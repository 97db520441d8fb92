"""The port's runtime mesh and its expert-parallel MoE body against the
reference's ``_moe_ffn_shardmap`` at the same mesh shape.

The reference side is one subprocess for the module, on an 8-device
virtual CPU mesh (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
with Auto axes: ``jax.jit`` of the MoE layer's value and gradient, of the
whole model's ``value_and_grad(loss_fn)`` and of one ``train_step``,
every result written to an ``.npz`` under a temporary directory. The port
side is ranks of ``repro_torch.launch.mesh.spawn`` over gloo with a
``file://`` store, each case run twice, with every floating-point
``index_add_`` and every ``all_reduce`` made to raise. Both start from
the same numpy inputs, made from seeds (``tests/_torch_mesh_cases.py``).

The cases: the MoE layer (olmoe-1b-7b ``reduced()``, f32) at meshes
(1, 2), (2, 2) with fsdp off and on, (1, 4), (2, 2) with capacity
dropping copies, and B = 1 at data 2 (the rows replicated), fsdp off and
on: output, aux, and the gradients of x, the router and each expert
shard. The whole model at (2, 2), fsdp off and on: loss, every gradient
leaf, and the state after one ``train_step``. ``Engine.generate`` at
(1, 2), (2, 2) and B = 1 at (2, 2): the one-process tokens. Two runs are
bit-equal, and so are the model ranks of a data row.

Tolerances (the reference's psum adds in XLA's order): f32 forward and
aux within 1e-5 of the output's max, gradients and state within 1e-4 of
each leaf's max. Every spawn has a time limit of its own, so a hung
collective fails its case rather than the suite.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import _torch_mesh_cases as C
from repro_torch import sharding as SH
from repro_torch.data import pipeline as DP
from repro_torch.launch import mesh as M
from repro_torch.serve.engine import Engine, ServeConfig

HERE = os.path.dirname(os.path.abspath(__file__))
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
#: seconds each spawn and the reference's subprocess may take
SPAWN_LIMIT = 240
REF_LIMIT = 420

#: the port's spawns: mesh -> the (kind, case)s its ranks run
SPAWNS = {
    # the engine first: its first collectives run in inference mode
    (1, 2): [("engine", "1x2"), ("layer", "1x2")],
    (2, 2): [("layer", c) for c in ("2x2", "2x2_fsdp", "2x2_drops", "2x2_b1",
                                    "2x2_b1_fsdp")]
    + [("model", c) for c in C.MODEL_CASES]
    + [("engine", c) for c in ("2x2", "2x2_b1")],
    (1, 4): [("layer", "1x4")],
}

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import functools
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro import sharding as SH
    from repro.configs import registry
    from repro.models import moe as RM
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.train import steps as TS
    import _torch_mesh_cases as C

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return jax.make_mesh(shape, ("data", "model"), (AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])

    out = {}
    base = registry()["olmoe-1b-7b"].reduced()
    for case, (shape, fsdp, b, _) in C.LAYER_CASES.items():
        cfg = C.layer_cfg(base, case)
        r, wg, wu, wd, x = C.layer_arrays(cfg, case)
        mesh = mesh_of(shape)

        def f(p, x):
            y, aux = RM.moe_ffn(p, x, cfg)
            return jnp.sum(y * jnp.sin(y)) + C.AUX_WEIGHT * aux, (y, aux)
        p = {"router": {"w": r}, "w_gate": wg, "w_up": wu, "w_down": wd}
        with jax.set_mesh(mesh), SH.axis_env(mesh, batch=("data",),
                                             fsdp=fsdp):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        got = {"y": y, "aux": aux, "gx": gx, "gr": gp["router"]["w"],
               "gwg": gp["w_gate"], "gwu": gp["w_up"], "gwd": gp["w_down"]}
        out.update({f"layer/{case}/{k}": v for k, v in got.items()})

    cfg = base
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda: T.init_params(cfg, jax.random.PRNGKey(0))))
    params = C.draw_tree(shapes, C.SEED)
    batch = C.model_tokens(cfg.vocab_size)
    opt = adamw.OptConfig(**C.OPT)
    for case, (shape, fsdp) in C.MODEL_CASES.items():
        mesh = mesh_of(shape)
        with jax.set_mesh(mesh), SH.axis_env(mesh, batch=("data",),
                                             fsdp=fsdp):
            (loss, parts), g = jax.jit(jax.value_and_grad(
                lambda p, b: TS.loss_fn(cfg, p, b), has_aux=True))(
                    params, batch)
            state = {"params": params, "opt": adamw.init(params)}
            state, m = jax.jit(functools.partial(TS.train_step, cfg, opt))(
                state, batch)
        got = {"loss": loss, "ce": parts["ce"], "aux": parts["moe_aux"],
               "step_loss": m["loss"], "grad_norm": m["grad_norm"]}
        for tag, tree in (("g", g), ("p", state["params"]),
                          ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
            got.update({f"{tag}/{k}": v for k, v in
                        C.flatten(jax.device_get(tree)).items()})
        out.update({f"model/{case}/{k}": v for k, v in got.items()})
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results by key, the port's by mesh and rank, the
    seconds each side took). The reference's subprocess and the port's
    three spawns run at once."""
    path = tmp_path_factory.mktemp("mesh") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE])
    env["JAX_PLATFORMS"] = "cpu"
    t0 = time.monotonic()
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(path)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(SPAWNS)) as pool:
            jobs = {mesh: pool.submit(M.spawn, C.run_rank, *mesh,
                                      backend="gloo", device="cpu",
                                      args=(cases,), timeout=SPAWN_LIMIT)
                    for mesh, cases in SPAWNS.items()}
            port = {mesh: job.result() for mesh, job in jobs.items()}
        t_port = time.monotonic() - t0
        _, err = ref.communicate(timeout=REF_LIMIT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(path) as z:
        want = dict(z)
    return want, port, (t_port, time.monotonic() - t0)


def _ranks(port, mesh):
    """[(coords, rank's results)] of a mesh's spawn."""
    return [(divmod(r, mesh[1]), res) for r, res in enumerate(port[mesh])]


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    lim = tol * max(np.max(np.abs(want)), 1e-30)
    assert err <= lim, f"{what}: {err:.3g} > {lim:.3g}"


@pytest.mark.parametrize("case", list(C.LAYER_CASES))
def test_moe_layer_matches_the_shardmap(runs, case):
    """Output, aux and the gradients of x, the router and each rank's expert
    shard against the reference's shard_map at the same mesh. The port's
    rank loss is sum(y sin y) over its rows (over 1/data of the replicated
    rows) + AUX_WEIGHT/data * aux, so the ranks' gradients summed over the
    data group are the reference's."""
    want, port, _ = runs
    mesh, fsdp, b, _ = C.LAYER_CASES[case]
    nd, nm = mesh
    split = b % nd == 0
    ref = {k: want[f"layer/{case}/{k}"] for k in
           ("y", "aux", "gx", "gr", "gwg", "gwu", "gwd")}
    ranks = {c: res[f"layer/{case}"][0] for c, res in _ranks(port, mesh)}
    for m in range(nm):
        col = [ranks[(d, m)] for d in range(nd)]
        if split:
            y = np.concatenate([r["y"] for r in col])
            gx = np.concatenate([r["gx"] for r in col])
        else:
            for r in col:
                _close(r["y"], ref["y"], FWD_TOL, f"{case} y, model {m}")
            y = col[0]["y"]
            gx = sum(r["gx"].astype(np.float64) for r in col)
        _close(y, ref["y"], FWD_TOL, f"{case} y, model {m}")
        _close(gx, ref["gx"], GRAD_TOL, f"{case} dx, model {m}")
        for r in col:
            _close(r["aux"], ref["aux"], FWD_TOL, f"{case} aux")
        _close(sum(r["gr"].astype(np.float64) for r in col), ref["gr"],
               GRAD_TOL, f"{case} d router, model {m}")
        for k, name in (("gwg", "w_gate"), ("gwu", "w_up"),
                        ("gwd", "w_down")):
            path = f"moe/{name}"
            if fsdp:
                for d in range(nd):
                    _close(col[d][k], C.expert_slice(
                        path, ref[k], (d, m), mesh, True), GRAD_TOL,
                        f"{case} d {name} rank ({d}, {m})")
            else:
                _close(sum(r[k].astype(np.float64) for r in col),
                       C.expert_slice(path, ref[k], (0, m), mesh, False),
                       GRAD_TOL, f"{case} d {name}, model {m}")


def _model_ranks(runs, case):
    want, port, _ = runs
    mesh, fsdp = C.MODEL_CASES[case]
    pre = f"model/{case}/"
    ref = {k[len(pre):]: v for k, v in want.items() if k.startswith(pre)}
    return ref, mesh, fsdp, [(c, res[f"model/{case}"][0])
                             for c, res in _ranks(port, mesh)]


@pytest.mark.parametrize("case", list(C.MODEL_CASES))
def test_model_value_and_grad_matches_the_reference(runs, case):
    """``train.steps.value_and_grad`` under the mesh (each rank its rows
    and shard, the gradient averaged over data) against the reference's
    jit of ``value_and_grad(loss_fn)``: loss, ce, aux and every gradient
    leaf on every rank."""
    ref, mesh, fsdp, ranks = _model_ranks(runs, case)
    grads = [k for k in ref if k.startswith("g/")]
    assert len(grads) == 13
    for coords, got in ranks:
        for k in ("loss", "ce", "aux"):
            _close(got[k], ref[k], FWD_TOL, f"{case} {k} rank {coords}")
        for k in grads:
            _close(got[k], C.expert_slice(k, ref[k], coords, mesh, fsdp),
                   GRAD_TOL, f"{case} {k} rank {coords}")


#: where the reference's gradient is below this share of its leaf's max
#: (and not 0), Adam's first step (lr g / (|g| + eps), about lr sign g)
#: turns the gradient's last digits into up to 2 lr: those params are held
#: to that
CONDITIONED = 1e-3


@pytest.mark.parametrize("case", list(C.MODEL_CASES))
def test_train_step_matches_the_reference(runs, case):
    """One ``train_step`` under the mesh (the clip's norm over the global
    tree, each rank updating its shard in place) against the reference's
    jit: loss, grad norm, every m and v leaf, and every param where the
    step is well conditioned (the rest within 2 lr), on every rank."""
    ref, mesh, fsdp, ranks = _model_ranks(runs, case)
    lr = C.OPT["lr"]
    for coords, got in ranks:
        for k in ("step_loss", "grad_norm"):
            _close(got[k], ref[k], FWD_TOL, f"{case} {k} rank {coords}")
        for k in ref:
            if k[:2] not in ("p/", "m/", "v/"):
                continue
            want = C.expert_slice(k, ref[k], coords, mesh, fsdp)
            if k[:2] != "p/":
                _close(got[k], want, GRAD_TOL, f"{case} {k} rank {coords}")
                continue
            g = np.abs(C.expert_slice("g" + k[1:], ref["g" + k[1:]], coords,
                                      mesh, fsdp))
            ok = (g == 0) | (g >= CONDITIONED * g.max())
            assert ok.mean() > 0.5, k
            err = np.abs(got[k] - want)
            assert err[ok].max() <= GRAD_TOL * np.abs(want).max(), k
            assert err.max() <= 2 * lr, k


@pytest.mark.parametrize("case", list(C.ENGINE_CASES))
def test_generate_matches_one_process(runs, case):
    """``Engine.generate`` under the mesh returns, on every rank, the whole
    batch's tokens, equal to one process's on the full weights."""
    _, port, _ = runs
    mesh, rows = C.ENGINE_CASES[case]
    cfg = C.engine_cfg()
    prompts = C.engine_prompts(cfg.vocab_size, rows)
    want = Engine(cfg, C.engine_params(cfg),
                  ServeConfig(cache_len=C.SEQ + C.ENGINE_NEW + 2,
                              max_new_tokens=C.ENGINE_NEW),
                  device="cpu").generate(prompts)
    assert want.shape == (rows, C.ENGINE_NEW)
    for coords, res in _ranks(port, mesh):
        np.testing.assert_array_equal(res[f"engine/{case}"][0]["tokens"],
                                      want, err_msg=f"rank {coords}")


#: what every model rank of a data row holds alike (the expert leaves and
#: their gradients are each rank's own)
_ALIKE = {"layer": ("y", "aux", "gx", "gr"), "engine": ("tokens",)}


@pytest.mark.parametrize("mesh", list(SPAWNS))
def test_runs_repeat_bit_for_bit_on_every_model_rank(runs, mesh):
    """Two runs of every case are bit-equal on every rank, and every model
    rank of a data row holds the same bits of what it shares: the ordered
    sums leave no rank and no run its own rounding."""
    _, port, _ = runs
    for coords, res in _ranks(port, mesh):
        for key, (a, b) in res.items():
            for k in a:
                assert np.array_equal(a[k], b[k]), f"{key} {k} {coords}"
    row = {}
    for (d, m), res in _ranks(port, mesh):
        for key, (a, _) in res.items():
            kind = key.split("/")[0]
            keys = _ALIKE.get(kind) or [
                k for k in a if "/moe/w_" not in k]
            first = row.setdefault((d, key), a)
            for k in keys:
                assert np.array_equal(a[k], first[k]), \
                    f"{key} {k}: model rank {m} of data row {d}"


def test_the_file_stays_inside_its_time(runs):
    """The reference's subprocess and the port's spawns finish well inside
    their limits (a hung collective would have failed the fixture)."""
    _, _, (t_port, t_all) = runs
    assert t_port < SPAWN_LIMIT and t_all < REF_LIMIT


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_ranks_are_row_major_as_jax_make_mesh():
    """rank = data_index * model + model_index; the data groups are the
    columns, the model groups the rows, each in ascending index."""
    assert M.axis_ranks(2, 3) == {"data": [[0, 3], [1, 4], [2, 5]],
                                  "model": [[0, 1, 2], [3, 4, 5]]}
    mesh = M.RuntimeMesh(2, 3, 4, "gloo", torch.device("cpu"), {})
    assert mesh.coords == (1, 1) and mesh.index("model") == 1
    assert dict(mesh.shape) == {"data": 2, "model": 3} and mesh.size == 6


@pytest.mark.parametrize("microbatches", [1, 2])
def test_shard_batch_gives_a_data_rank_its_rows(microbatches):
    """A data rank's rows are its block of each global microbatch (its
    block of the batch for one), as ``P("data", ...)`` splits them."""
    rows = np.arange(8 * 3).reshape(8, 3)
    got = []
    for d in range(2):
        mesh = M.RuntimeMesh(2, 2, 2 * d + 1, "gloo", torch.device("cpu"),
                             {})
        got.append(DP.shard_batch({"x": rows}, "cpu", mesh,
                                  microbatches)["x"].numpy())
    mb = 8 // microbatches
    for j in range(microbatches):
        whole = np.concatenate([g[j * mb // 2:(j + 1) * mb // 2]
                                for g in got])
        np.testing.assert_array_equal(whole, rows[j * mb:(j + 1) * mb])
    with pytest.raises(ValueError):
        DP.shard_batch({"x": rows[:3]}, "cpu", mesh)


def test_leaf_axes_follow_the_shardmap_in_specs():
    """The expert leaves split as the reference's in_specs, every other
    leaf whole; a stacked leaf as its layer's."""
    mesh = M.RuntimeMesh(2, 2, 0, "gloo", torch.device("cpu"), {})
    for fsdp in (False, True):
        env = SH.AxisEnv(mesh, fsdp=fsdp)
        for name, spec in C.EXPERT_SPECS.items():
            want = {("data" if a == "fsdp" else a): j - len(spec)
                    for j, a in enumerate(spec)
                    if a == "model" or (a == "fsdp" and fsdp)}
            assert SH.leaf_axes(f"blocks/moe/{name}", env) == want
            assert SH.leaf_axes(f"moe/{name}", env) == want
        for path in ("blocks/moe/router/w", "embed", "blocks/attn/wq/w",
                     "blocks/mlp/w_up/w", "lm_head"):
            assert SH.leaf_axes(path, env) == {}


def test_spawn_fails_a_rank_that_raises_or_hangs():
    """A rank that raises fails the run with its traceback; a collective
    that never completes fails it at the time limit; neither stalls."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        M.spawn(C.raises_on_rank_1, 1, 2, backend="gloo", device="cpu",
                timeout=60)
    with pytest.raises(TimeoutError):
        M.spawn(C.hangs_on_rank_0, 1, 2, backend="gloo", device="cpu",
                timeout=6)
    assert time.monotonic() - t0 < 60


def test_backends_are_the_callers():
    """No backend but nccl and gloo; gloo takes the caller's device (None:
    the card, which raises here rather than fall back to the CPU)."""
    with pytest.raises(ValueError):
        M.rank_device("mpi", 0, 2)
    assert M.rank_device("gloo", 1, 2, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="file://"):
        M.open_mesh(1, 2, backend="gloo", rank=0, device="cpu",
                    init_method="tcp://localhost:1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            M.rank_device("gloo", 0, 2)


def test_rank_init_params_are_shards_of_the_local_draw():
    """Each rank's weights drawn shard by shard (``rank_init_params``, the
    chip script's) are its slices of the one tree ``init_params`` draws
    from the same seed, so the ranks and the one-process path share
    weights; a whole leaf is the same on every rank."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import transformer as TT
    cfg = configs.get_arch("olmoe-1b-7b").reduced()
    full = C.flatten(TT.init_params(cfg, torch.Generator().manual_seed(5),
                                    "cpu"))
    for fsdp in (False, True):
        for r in range(4):
            mesh = M.RuntimeMesh(2, 2, r, "gloo", torch.device("cpu"), {})
            env = SH.AxisEnv(mesh, fsdp=fsdp)
            got = C.flatten(specs.rank_init_params(
                cfg, torch.Generator().manual_seed(5), env, "cpu"))
            assert got.keys() == full.keys()
            for k, t in got.items():
                want = C.expert_slice(k, full[k].numpy(), mesh.coords,
                                      (2, 2), fsdp)
                assert np.array_equal(t.numpy(), want), (fsdp, r, k)


def test_mesh_phase_shards_fit_the_card():
    """The chip script's mesh runs reckoned on the meta device before they
    run: every rank's weights (served, with its rows' cache) and state at
    10 B a parameter (trained), summed over the ranks that share the card,
    stay under 60 and 40 GB (room for activations beside them)."""
    import importlib.util
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import transformer as TT
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def shard_elems(cfg, mesh, fsdp):
        out = []
        for r in range(mesh[0] * mesh[1]):
            env = SH.AxisEnv(M.RuntimeMesh(*mesh, r, "gloo", "meta", {}),
                             fsdp=fsdp)
            out.append(sum(t.numel() for t in C.flatten(
                specs.rank_init_params(cfg, torch.Generator(), env,
                                       "meta")).values()))
        return out
    base = configs.get_arch(cs.MESH_ARCH)
    b, sp, new = cs.MESH_SERVE_SHAPE
    for mesh, fsdp in cs.MESH_SERVE:
        elems = shard_elems(base, mesh, fsdp)
        cache = sum(t.numel() * t.element_size() for t in TT.init_cache(
            base, b // mesh[0], sp + new, "meta").values())
        total = sum(2 * e + cache for e in elems)
        assert total < 60e9, (mesh, total)
    mesh, fsdp, layers, _ = cs.MESH_TRAIN
    cut = dataclasses.replace(base, num_layers=layers)
    assert sum(10 * e for e in shard_elems(cut, mesh, fsdp)) < 40e9


def test_remat_recompute_keeps_the_mesh_on_autograd_threads():
    """On the card the backward, and a remat group's recompute in it, runs
    on autograd's own thread, where the thread's env is not installed: the
    recompute must still take the expert-parallel body (else its saved
    tensors differ and checkpoint raises). Shown on the CPU by running the
    backward on another thread, on a one-rank runtime mesh (every
    collective the identity), against the local path's gradients."""
    import threading
    from repro_torch import configs
    from repro_torch.models import transformer as TT
    from repro_torch.train import steps as TS
    cfg = configs.get_arch("olmoe-1b-7b").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             C.model_tokens(cfg.vocab_size).items()}
    _, want = TS.value_and_grad(cfg, params, batch, remat=True)
    mesh = M.RuntimeMesh(1, 1, 0, "gloo", torch.device("cpu"), {})
    leaves = [t.detach().requires_grad_() for _, t in SH.tree_paths(params)]
    with SH.axis_env(mesh, ("data",)), torch.enable_grad():
        loss, _ = TS.loss_fn(cfg, TS._like(params, leaves), batch,
                             remat=True)
    got = {}

    def backward():
        got["g"] = torch.autograd.grad(loss, leaves)
    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and "g" in got
    for (path, w), g in zip(SH.tree_paths(want), got["g"]):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6), path
