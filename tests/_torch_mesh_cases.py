"""Cases of the mesh tests (``tests/test_torch_mesh.py``, and the card's in
``tests/test_torch_cuda.py``): inputs made with numpy from seeds, which
the reference's shard_map (in a subprocess of its own) and the port's
ranks (spawned over gloo) both run, and the function each port rank runs.

This module imports nothing of the JAX package, so that spawned ranks
and the card tests can import it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

SEED = 0
SEQ = 16
#: the layer loss: sum(y * sin y) + AUX_WEIGHT * aux
AUX_WEIGHT = 0.3

#: name -> (mesh (data, model), fsdp, batch rows, capacity factor) of the
#: MoE layer cases (olmoe-1b-7b ``reduced()``: E 4, k 2, d 256, f 128, f32)
LAYER_CASES = {
    "1x2": ((1, 2), False, 4, 1.25),
    "2x2": ((2, 2), False, 4, 1.25),
    "2x2_fsdp": ((2, 2), True, 4, 1.25),
    "1x4": ((1, 4), False, 4, 1.25),
    # capacity drops copies in every group
    "2x2_drops": ((2, 2), False, 4, 0.5),
    # B = 1 does not split over data: the rows are replicated
    "2x2_b1": ((2, 2), False, 1, 1.25),
    "2x2_b1_fsdp": ((2, 2), True, 1, 1.25),
}

#: the whole model: olmoe-1b-7b ``reduced()`` (2 layers, f32), batch
#: (4, 16), one value_and_grad and one train_step under each mesh
MODEL_CASES = {"2x2": ((2, 2), False), "2x2_fsdp": ((2, 2), True)}
MODEL_BATCH = 4
#: AdamW with no warm-up, so one step moves the params visibly
OPT = dict(lr=1e-2, warmup_steps=0)

#: Engine.generate: capacity ample (no copy dropped), so the partial sums
#: of k = 2 copies equal the local path's and the tokens the one-process
#: run's; (mesh, prompt rows)
ENGINE_CAPACITY = 16.0
ENGINE_CASES = {"1x2": ((1, 2), 2), "2x2": ((2, 2), 2),
                "2x2_b1": ((2, 2), 1)}
ENGINE_NEW = 6

#: the reference's shard_map in_specs of the expert leaves (right-aligned;
#: "fsdp" is the data axis when fsdp is on, else None)
EXPERT_SPECS = {"w_gate": ("model", None, "fsdp"),
                "w_up": ("model", None, "fsdp"),
                "w_down": ("model", "fsdp", None)}


def layer_cfg(cfg, case: str):
    return dataclasses.replace(cfg, capacity_factor=LAYER_CASES[case][3])


def layer_arrays(cfg, case: str):
    """(router w, w_gate, w_up, w_down, x) of a layer case."""
    (_, _), _, b, _ = LAYER_CASES[case]
    rng = np.random.default_rng(SEED + list(LAYER_CASES).index(case))
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    return (n(d, e, s=0.02), n(e, d, f, s=0.02), n(e, d, f, s=0.02),
            n(e, f, d, s=0.02), n(b, SEQ, d))


def draw_tree(shapes, seed: int):
    """numpy params for a tree of shapes (nested dicts, keys walked in
    sorted order): norm scales 1 + 0.1 n, other leaves n / sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(t[k], k) for k in sorted(t)}
        shape = tuple(t)
        a = rng.standard_normal(shape)
        if name == "scale":
            a = 1.0 + 0.1 * a
        else:
            a = a / np.sqrt(shape[-2] if len(shape) > 1 else 1.0)
        return a.astype(np.float32)
    return walk(shapes, "")


def model_tokens(vocab: int):
    rng = np.random.default_rng(SEED + 100)
    t = rng.integers(0, vocab, (MODEL_BATCH, SEQ + 1)).astype(np.int32)
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def engine_prompts(vocab: int, rows: int):
    rng = np.random.default_rng(SEED + 200)
    return rng.integers(0, vocab, (rows, SEQ)).astype(np.int32)


def expert_slice(path: str, a: np.ndarray, coords, mesh, fsdp: bool):
    """Rank ``coords``' slice of the full array ``a`` at ``path`` under the
    reference's in_specs (the whole array for a replicated leaf)."""
    parent, _, name = path.rpartition("/")
    if not parent.endswith("moe") or name not in EXPERT_SPECS:
        return a
    spec = EXPERT_SPECS[name]
    index = [slice(None)] * a.ndim
    for j, ax in enumerate(spec):
        ax = "data" if ax == "fsdp" and fsdp else ax
        if ax in ("data", "model"):
            i = ("data", "model").index(ax)
            dim = a.ndim - len(spec) + j
            n = a.shape[dim] // mesh[i]
            index[dim] = slice(coords[i] * n, (coords[i] + 1) * n)
    return a[tuple(index)]


def flatten(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# What each port rank runs (spawned by repro_torch.launch.mesh.spawn)
# ---------------------------------------------------------------------------


def _np(t):
    return t.detach().float().cpu().numpy()


def _layer(mesh, case, device):
    import torch
    from repro_torch import configs, sharding as SH
    from repro_torch.launch import specs
    from repro_torch.models import moe as TM

    (nd, _), fsdp, b, _ = LAYER_CASES[case]
    cfg = layer_cfg(configs.get_arch("olmoe-1b-7b").reduced(), case)
    r, wg, wu, wd, x = (torch.as_tensor(a) for a in layer_arrays(cfg, case))
    split = b % nd == 0
    full = {"moe": {"router": {"w": r}, "w_gate": wg, "w_up": wu,
                    "w_down": wd}}
    with SH.axis_env(mesh, ("data",), fsdp=fsdp) as env:
        p = specs.rank_params(full, env)["moe"]
        di = mesh.index("data")
        xl = x[di * b // nd:(di + 1) * b // nd] if split else x
        leaves = [p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"], xl]
        alias = [t.detach().to(device).requires_grad_() for t in leaves]
        with SH.replicated_rows() if not split else contextlib.nullcontext():
            q = {"router": {"w": alias[0]}, "w_gate": alias[1],
                 "w_up": alias[2], "w_down": alias[3]}
            y, aux = TM.moe_ffn(q, alias[4], cfg)
            w_rows = 1.0 if split else 1.0 / nd
            loss = (w_rows * torch.sum(y * torch.sin(y))
                    + AUX_WEIGHT / nd * aux)
            grads = torch.autograd.grad(loss, alias)
    names = ("gr", "gwg", "gwu", "gwd", "gx")
    return {"y": _np(y), "aux": _np(aux),
            **{k: _np(g) for k, g in zip(names, grads)}}


def _model(mesh, case, device):
    import torch
    from repro_torch import configs, sharding as SH
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import specs
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS

    _, fsdp = MODEL_CASES[case]
    cfg = configs.get_arch("olmoe-1b-7b").reduced()
    shapes = TT.tree_map(lambda t: tuple(t.shape),
                         TT.init_params(cfg, torch.Generator(), "meta"))
    full = TT.tree_map(torch.as_tensor, draw_tree(shapes, SEED))
    with SH.axis_env(mesh, ("data",), fsdp=fsdp) as env:
        params = TT.tree_map(lambda t: t.to(device),
                             specs.rank_params(full, env))
        batch = DP.shard_batch(model_tokens(cfg.vocab_size), device, mesh)
        (loss, parts), grads = TS.value_and_grad(cfg, params, batch)
        opt = adamw.OptConfig(**OPT)
        state = {"params": TT.tree_map(torch.clone, params),
                 "opt": adamw.init(params)}
        state, metrics = TS.train_step(cfg, opt, state, batch)
    out = {"loss": _np(loss), "ce": _np(parts["ce"]),
           "aux": _np(parts["moe_aux"]),
           "step_loss": _np(metrics["loss"]),
           "grad_norm": _np(metrics["grad_norm"])}
    for tag, tree in (("g", grads), ("p", state["params"]),
                      ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        out.update({f"{tag}/{k}": _np(v) for k, v in flatten(tree).items()})
    return out


def engine_params(cfg):
    """The engine cases' full params, as torch tensors on the CPU."""
    import torch
    from repro_torch.models import transformer as TT
    shapes = TT.tree_map(lambda t: tuple(t.shape),
                         TT.init_params(cfg, torch.Generator(), "meta"))
    return TT.tree_map(torch.as_tensor, draw_tree(shapes, SEED + 300))


def engine_cfg():
    from repro_torch import configs
    return dataclasses.replace(configs.get_arch("olmoe-1b-7b").reduced(),
                               capacity_factor=ENGINE_CAPACITY)


def _engine(mesh, case, device):
    from repro_torch import sharding as SH
    from repro_torch.launch import specs
    from repro_torch.serve.engine import Engine, ServeConfig

    _, rows = ENGINE_CASES[case]
    cfg = engine_cfg()
    with SH.axis_env(mesh, ("data",)) as env:
        eng = Engine(cfg, specs.rank_params(engine_params(cfg), env),
                     ServeConfig(cache_len=SEQ + ENGINE_NEW + 2,
                                 max_new_tokens=ENGINE_NEW), device=device)
        return {"tokens": eng.generate(engine_prompts(cfg.vocab_size, rows))}


def raises_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def hangs_on_rank_0(mesh):
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time
    import torch
    from repro_torch import sharding as SH
    if mesh.rank == 0:
        SH.gather(torch.zeros(2), mesh, "model")
    else:
        time.sleep(300)
    return mesh.rank


def refuse_unordered_sums():
    """Make a floating-point ``index_add_`` and every ``all_reduce`` or
    ``reduce_scatter`` raise in this process: sums whose order the
    library picks (atomic adds on the card, a backend's reduction)."""
    import torch
    import torch.distributed as dist

    def refuse(name, fn):
        def run(self, *a, **kw):
            if self.is_floating_point():
                raise AssertionError(f"a floating-point {name}")
            return fn(self, *a, **kw)
        return run

    def never(name):
        def run(*a, **kw):
            raise AssertionError(f"a {name}, whose order the backend picks")
        return run
    for n in ("index_add_", "index_add"):
        setattr(torch.Tensor, n, refuse(n, getattr(torch.Tensor, n)))
    torch.index_add = refuse("index_add", torch.index_add)
    for n in ("all_reduce", "reduce_scatter", "reduce_scatter_tensor"):
        setattr(dist, n, never(n))


def run_rank(mesh, cases, device="cpu", repeats=2):
    """Every (kind, case) of ``cases`` on this rank, ``repeats`` times each,
    with the unordered sums refused: {f"{kind}/{case}": [each run's
    result]}."""
    import torch
    torch.set_num_threads(1)
    refuse_unordered_sums()
    run = {"layer": _layer, "model": _model, "engine": _engine}
    return {f"{kind}/{case}": [run[kind](mesh, case, device)
                               for _ in range(repeats)]
            for kind, case in cases}
