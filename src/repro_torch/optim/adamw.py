"""AdamW with global-norm clipping and cosine schedule, updated in place.

The counterpart of the reference's ``src/repro/optim/adamw.py``. Moments
are kept in float32 regardless of parameter dtype (bfloat16 for the
>100B configs). The reference's train step donates its state to XLA,
which writes the new params and moments over the old: the ``O_s = |out|``
in-place case of the paper's diagonal memory optimisation. Here
:func:`update` writes the new p, m and v into their own storage (under a
runtime mesh, a rank its own shard), walking every leaf in slices of
:data:`SLICE` elements, so its float32 temporaries stay a few slices in
size whatever the leaf (qwen2.5-3b's stacked MLP weight is 811.6 M
elements, 3.25 GB in float32).

The reference's update is an elementwise chain that XLA fuses, not a
Pallas kernel; here it is plain PyTorch, a few launches a slice. Every
scalar (the step, the clip scale, the learning rate, the bias
corrections) stays a float32 tensor on the device, so an update never
waits for the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import sharding as SH

#: elements of one slice of a leaf; float32 temporaries of this size
#: (64 MiB each) are the update's working memory
SLICE = 1 << 24

_MOMENT_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    #: moment dtype; bf16 halves optimiser memory for the >100B configs
    moment_dtype: str = "float32"


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of nested dicts in ``jax.tree.leaves`` order
    (dict keys sorted), so that sums over them run in the reference's
    order."""
    return [x for _, x in SH.tree_paths(tree)]


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init(params, moment_dtype: str = "float32") -> Dict[str, Any]:
    """Zero moments beside every leaf (on its device) and a zero step."""
    mdt = _MOMENT_TYPES[moment_dtype]

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=mdt, device=tree.device)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), SLICE):
        yield flat[i:i + SLICE]


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32: each leaf's
    sum over its slices, the leaves summed in :func:`tree_leaves` order.
    Under a runtime mesh ``tree`` is this rank's shard: a split leaf's sum
    is summed over the groups that split it, a whole one counted once
    (``sharding.shard_sums``), so every rank holds the same norm."""
    paths, sqs = [], []
    for path, x in SH.tree_paths(tree):
        sq = None
        for sl in _slices(x):
            part = torch.sum(torch.square(sl.to(torch.float32)))
            sq = part if sq is None else sq + part
        paths.append(path)
        sqs.append(sq)
    env = SH.runtime_env()
    if env is not None:
        sqs = SH.shard_sums(paths, sqs, env)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: OptConfig, grads, opt_state, params
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, opt_state, metrics): the same trees, their leaves
    and the step overwritten in place with the new values (every
    ``data_ptr`` kept). ``grads`` has the params' tree; its leaves are
    read, never written."""
    step = opt_state["step"]
    step.add_(1)
    s = step.to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** s
    b2c = 1 - cfg.b2 ** s
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw: shapes {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} differ")
        for ps, gs, ms, vs in zip(*(_slices(t) for t in (p, g, m, v))):
            gf = gs.to(torch.float32) * scale
            # each moment in float32 (for a float32 moment, its own slice),
            # stored, then read back through the stored type as the
            # reference does
            mf = ms.to(torch.float32)
            mf.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            vf = vs.to(torch.float32)
            vf.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            if mf.data_ptr() != ms.data_ptr():
                ms.copy_(mf)
                vs.copy_(vf)
                mf, vf = ms.to(torch.float32), vs.to(torch.float32)
            den = torch.sqrt(vf / b2c).add_(cfg.eps)
            u = (mf / b1c).div_(den)
            pf = ps.to(torch.float32)
            u.add_(pf, alpha=cfg.weight_decay)
            if pf.data_ptr() == ps.data_ptr():
                ps.sub_(u.mul_(lr))
            else:
                ps.copy_(pf.sub_(u.mul_(lr)))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
