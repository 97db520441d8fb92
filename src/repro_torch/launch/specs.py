"""Abstract input stand-ins + parameter/cache sharding specs per (arch,
shape).

The counterpart of the reference's ``src/repro/launch/specs.py``. Where
the reference builds ``jax.ShapeDtypeStruct`` stand-ins with
``jax.eval_shape``, the port builds the same trees on PyTorch's ``meta``
device: tensors with a shape and a dtype and no storage, so no full
config is ever allocated. Where the reference returns ``NamedSharding``s
of ``PartitionSpec``s, the port returns the specs as tuples of mesh axis
names (a tuple of names where axes compose, None where replicated), over a
``launch/mesh.py`` mesh or anything with ``axis_names`` and ``shape``.

Under a runtime mesh (``launch/mesh.py::RuntimeMesh``) a rank holds its
shard of the parameters (:func:`rank_params`, :func:`rank_init_params`):
the expert leaves sliced as the reference's shard_map ``in_specs``
(``sharding.leaf_axes``), every other leaf whole. The reference's jit
would also split the dense leaves over model (:func:`param_shardings`);
that is XLA's partitioning of the same arithmetic, and here those leaves
are replicated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.train import steps as TS

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    """A stand-in with a shape and a dtype and no storage."""
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Abstract state/batch construction
# ---------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig):
    return T.init_params(cfg, torch.Generator(), META)


def abstract_state(cfg: ArchConfig):
    return TS.init_state(cfg, torch.Generator(), TS.opt_config_for(cfg),
                         device=META)


def abstract_cache(cfg: ArchConfig, batch: int, cache_len: int):
    return T.init_cache(cfg, batch, cache_len, device=META)


def cache_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """decode_32k keeps the full 32k cache; long_500k uses the sliding
    window ring for attention archs (sub-quadratic path; SSM state is O(1))."""
    if shape.kind == "long_decode":
        return min(cfg.sliding_window or 4096, shape.seq_len)
    return shape.seq_len


def decode_window(cfg: ArchConfig, shape: ShapeConfig) -> int:
    return cfg.sliding_window if shape.kind == "long_decode" else 0


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All inputs of the step built for ``shape`` (see launch/dryrun.py)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.frontend != "none":
            inputs = _sds((b, s, cfg.d_model), torch.float32)
        else:
            inputs = _sds((b, s), torch.int32)
        if shape.kind == "train":
            return {"state": abstract_state(cfg),
                    "batch": {"inputs": inputs,
                              "targets": _sds((b, s), torch.int32)}}
        return {"params": abstract_params(cfg), "inputs": inputs}
    # decode shapes
    cl = cache_len_for(cfg, shape)
    return {
        "params": abstract_params(cfg),
        "cache": abstract_cache(cfg, b, cl),
        "tokens": _sds((b, 1), torch.int32),
        "pos": _sds((), torch.int32),
    }


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def _fit(mesh, shape: Tuple[int, ...], spec_dims) -> tuple:
    """Drop sharding on axes that do not divide evenly."""
    out = []
    for size, ax in zip(shape, spec_dims):
        out.append(ax if size % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


#: (path-substring, per-dim logical spec RIGHT-ALIGNED to the array rank).
#: "M" = model axis, "F" = FSDP over the data axis (applied only when the
#: replicated-over-data state would overflow HBM — see ``needs_fsdp``),
#: None = replicated.
_PARAM_RULES = [
    ("moe/router/w", (None, None)),
    ("moe/w_gate", ("M", None, "F")),
    ("moe/w_up", ("M", None, "F")),
    ("moe/w_down", ("M", "F", None)),
    ("attn/wq/w", ("F", "M")), ("attn/wk/w", ("F", "M")),
    ("attn/wv/w", ("F", "M")), ("attn/wo/w", ("M", "F")),
    ("attn/wq/b", ("M",)), ("attn/wk/b", ("M",)), ("attn/wv/b", ("M",)),
    ("attn/wq_a/w", (None, None)), ("attn/wkv_a/w", (None, None)),
    ("attn/wq_b/w", (None, "M")), ("attn/wk_b/w", (None, "M")),
    ("attn/wv_b/w", (None, "M")),
    ("mlp/w_up/w", ("F", "M")), ("mlp/w_gate/w", ("F", "M")),
    ("mlp/w_down/w", ("M", "F")),
    ("rwkv/wr/w", (None, "M")), ("rwkv/wk/w", (None, "M")),
    ("rwkv/wv/w", (None, "M")), ("rwkv/wd/w", (None, "M")),
    ("rwkv/wg/w", (None, "M")), ("rwkv/wo/w", ("M", None)),
    ("cmix/wk/w", (None, "M")), ("cmix/wv/w", ("M", None)),
    ("mamba/w_in/w", (None, "M")), ("mamba/conv", (None, "M")),
    ("mamba/w_bc/w", ("M", None)), ("mamba/w_dt/w", ("M", None)),
    ("mamba/a_log", ("M", None)), ("mamba/d_skip", ("M",)),
    ("mamba/w_out/w", ("M", None)),
]


def parallel_policy(cfg: ArchConfig, mesh) -> str:
    """"dp" = pure data parallel (params replicated, batch over data AND
    model axes) for models whose full train state fits one chip; "tp" =
    tensor/expert parallel over the model axis (default)."""
    state_bytes = cfg.param_count() * (2 + 4 + 4)
    if not cfg.is_moe and state_bytes <= 8 * 2**30:
        return "dp"
    return "tp"


def needs_fsdp(cfg: ArchConfig, mesh, model_axis="model",
               budget_bytes: float = 8 * 2**30) -> bool:
    """True when params+AdamW moments sharded over the model axis alone
    would exceed the per-chip budget — then "F" dims shard over data too."""
    state_bytes = cfg.param_count() * (2 + 4 + 4)  # bf16 + f32 m,v
    return state_bytes / _axis_size(mesh, model_axis) > budget_bytes


def _param_spec(mesh, path: str, leaf, model_axis="model",
                fsdp: bool = False, fsdp_axis="data") -> tuple:
    shape = tuple(leaf.shape)
    if path == "embed":
        # vocab-sharded when divisible; otherwise fully replicated
        cand = ("M", "F") if fsdp else ("M", None)
        return _fit(mesh, shape, _resolve(cand, model_axis, fsdp, fsdp_axis))
    if path == "lm_head":
        return _fit(mesh, shape,
                    _resolve(("F", "M"), model_axis, fsdp, fsdp_axis))
    for frag, dims in _PARAM_RULES:
        if frag in path:
            spec = _resolve(dims, model_axis, fsdp, fsdp_axis)
            # right-align (block params carry a leading L dim)
            full = [None] * (len(shape) - len(spec)) + list(spec)
            return _fit(mesh, shape, full)
    return (None,) * len(shape)


def _resolve(dims, model_axis, fsdp: bool = False, fsdp_axis="data"):
    out = []
    for d in dims:
        if d == "M":
            out.append(model_axis)
        elif d == "F":
            out.append(fsdp_axis if fsdp else None)
        else:
            out.append(None)
    return out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def param_shardings(cfg: ArchConfig, mesh, model_axis="model",
                    fsdp: Optional[bool] = None,
                    policy: Optional[str] = None):
    """The params' tree of specs."""
    ap = abstract_params(cfg)
    if policy is None:
        policy = parallel_policy(cfg, mesh)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, mesh, model_axis)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        if policy == "dp":
            return (None,) * tree.dim()
        return _param_spec(mesh, prefix[:-1], tree, model_axis, fsdp)

    return build(ap)


def state_shardings(cfg: ArchConfig, mesh, model_axis="model",
                    policy: Optional[str] = None):
    ps = param_shardings(cfg, mesh, model_axis, policy=policy)
    return {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    batch_ax=None):
    ba = batch_ax or (("pod", "data") if "pod" in mesh.axis_names else "data")
    specs = input_specs(cfg, shape)

    def shard_like(sds):
        dims = [ba] + [None] * (sds.dim() - 1)
        return _fit(mesh, tuple(sds.shape), dims)

    return {k: shard_like(v) for k, v in specs["batch"].items()}


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    model_axis="model", batch_ax=None):
    ba = batch_ax or (("pod", "data") if "pod" in mesh.axis_names else "data")
    cl = cache_len_for(cfg, shape)
    ac = abstract_cache(cfg, shape.global_batch, cl)

    def spec_for(name: str, sds) -> tuple:
        shp = tuple(sds.shape)
        if name in ("k", "v"):                     # (L,B,C,KV,D)
            kv_ok = shp[3] % _axis_size(mesh, model_axis) == 0
            dims = [None, ba, None if kv_ok else model_axis,
                    model_axis if kv_ok else None, None]
        elif name in ("k_scale", "v_scale"):       # (L,B,C,KV)
            kv_ok = shp[3] % _axis_size(mesh, model_axis) == 0
            dims = [None, ba, None if kv_ok else model_axis,
                    model_axis if kv_ok else None]
        elif name in ("c_kv", "k_rope"):           # (L,B,C,r)
            dims = [None, ba, model_axis, None]
        elif name == "wkv":                        # (L,B,H,D,D)
            dims = [None, ba, model_axis, None, None]
        elif name in ("shift", "cm_shift"):        # (L,B,d)
            dims = [None, ba, model_axis]
        elif name == "ssm":                        # (L,B,di,N)
            dims = [None, ba, model_axis, None]
        elif name == "conv":                       # (L,B,K-1,di)
            dims = [None, ba, None, model_axis]
        else:
            dims = [None] * len(shp)
        return _fit(mesh, shp, dims)

    return {k: spec_for(k, v) for k, v in ac.items()}


# ---------------------------------------------------------------------------
# A rank's shard under a runtime mesh
# ---------------------------------------------------------------------------


def shard_leaf(path: str, t: torch.Tensor, env: SH.AxisEnv) -> torch.Tensor:
    """This rank's slice of the full leaf ``t`` at ``path`` (a copy, so the
    full leaf can be freed; ``t`` itself where the leaf is whole)."""
    axes = SH.leaf_axes(path, env)
    for axis, dim in axes.items():
        n = t.shape[dim] // env.mesh.shape[axis]
        t = t.narrow(dim, env.mesh.index(axis) * n, n)
    return t.clone() if axes else t


def rank_params(params, env: SH.AxisEnv):
    """This rank's shard of a full parameter tree (e.g.
    ``transformer.params_from_reference``'s), so that every rank and the
    reference start from one tree."""
    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        return shard_leaf(prefix[:-1], tree, env)
    return build(params, "")


def rank_init_params(cfg: ArchConfig, generator: torch.Generator,
                     env: SH.AxisEnv, device=None):
    """:func:`transformer.init_params`'s tree, drawn in the same order from
    ``generator``, with each layer's leaves cut to this rank's shard as
    they are drawn: a rank never holds more than one full layer."""
    return T.init_params(cfg, generator, device,
                         shard=lambda path, t: shard_leaf(path, t, env))
