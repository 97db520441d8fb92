"""Mesh-axis environment + activation sharding constraints.

The counterpart of the reference's ``src/repro/sharding.py``. The model
code is mesh-agnostic: it calls :func:`constrain` with *logical* axis names
("batch", "model", None...). The launcher installs an :class:`AxisEnv`
mapping logical names to physical mesh axes — e.g. batch -> ("pod",
"data") on the multi-pod mesh, ("data",) on one pod.

The port has no SPMD compiler. Under a description mesh
(``launch/mesh.py::Mesh``, the dry run's) nothing is placed. Under a
runtime mesh (``launch/mesh.py::RuntimeMesh``, a process a device) each
rank already holds its own shard of every tensor explicitly: its rows of
the batch (``data/pipeline.py::shard_batch``) and its slice of each
sharded parameter (``launch/specs.py::rank_params``). So
:func:`constrain` returns its tensor unchanged, with no env and on every
mesh. Specs are tuples of axis names (a tuple of names where axes
compose, None where replicated); :meth:`AxisEnv.resolve` raises on an
unknown logical name.

The collectives below join the ranks of one axis of a runtime mesh. Each
is a ``torch.autograd.Function`` whose sums run in ascending index along
the axis: the partials are all-gathered and added one after another, so
every rank of the axis holds the same bits and a run repeats bit for bit
(a backend's ``all_reduce`` adds in the library's own order and is not
used). Their backwards follow one convention: along ``data`` the ranks'
losses are parts of one loss, the mean over the data group of the ranks'
own; along ``model`` every rank computes the same loss.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Tuple

import torch

_state = threading.local()


class AxisEnv:
    def __init__(self, mesh, batch: Tuple[str, ...] = ("data",),
                 model: str = "model", fsdp: bool = False):
        self.mesh = mesh
        self.batch = tuple(batch)
        self.model = model
        #: expert/mlp weights additionally sharded over the data axis
        self.fsdp = fsdp

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch if len(self.batch) > 1 else self.batch[0]
        if logical == "model":
            return self.model
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *dims: Optional[str]) -> tuple:
        return tuple(self.resolve(d) for d in dims)


def current_env() -> Optional[AxisEnv]:
    return getattr(_state, "env", None)


def runtime_env() -> Optional[AxisEnv]:
    """The installed env when it runs on a runtime mesh (one with process
    groups), else None."""
    env = current_env()
    return env if env is not None and hasattr(env.mesh, "groups") else None


@contextlib.contextmanager
def axis_env(mesh, batch: Tuple[str, ...] = ("data",), model: str = "model",
             fsdp: bool = False):
    prev = current_env()
    _state.env = AxisEnv(mesh, batch, model, fsdp)
    try:
        yield _state.env
    finally:
        _state.env = prev


def keep_env(fn: Callable) -> Callable:
    """``fn`` run under the env installed now, wherever it is called: a
    checkpoint's recompute runs on autograd's own thread (on the card),
    where this thread's env is not installed."""
    env = current_env()

    def run(*args, **kw):
        prev = current_env()
        _state.env = env
        try:
            return fn(*args, **kw)
        finally:
            _state.env = prev
    return run


#: the leaves a runtime mesh splits, as the reference's shard_map
#: ``in_specs``: each expert leaf's E dim over ``model`` and, with fsdp, its
#: f dim over ``data`` (dims counted from the right, so a layer's leaf and
#: the stacked leaf alike). Every other leaf is whole on every rank.
_EXPERT_DIMS = {"w_gate": (-3, -1), "w_up": (-3, -1), "w_down": (-3, -2)}


def leaf_axes(path: str, env: AxisEnv) -> dict:
    """{mesh axis: dim} of the parameter at ``path`` ("blocks/moe/w_gate")
    under ``env``; {} for a leaf every rank holds whole."""
    parent, _, name = path.rpartition("/")
    if not parent.endswith("moe") or name not in _EXPERT_DIMS:
        return {}
    e_dim, f_dim = _EXPERT_DIMS[name]
    return {env.model: e_dim, "data": f_dim} if env.fsdp \
        else {env.model: e_dim}


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of a tree of nested dicts, keys sorted at every level
    (``jax.tree.leaves``' order), paths as ``"blocks/moe/w_gate"``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@contextlib.contextmanager
def replicated_rows():
    """The installed env with no batch axes: the rows in hand are the whole
    batch on every rank (a batch that the data axis does not divide), as
    the reference's MoE body replicates such tokens over data."""
    env = current_env()
    with axis_env(env.mesh, (), env.model, env.fsdp) as inner:
        yield inner


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """The reference's with_sharding_constraint: the identity here (no
    SPMD compiler; under a runtime mesh each rank holds its shard)."""
    return x


# ---------------------------------------------------------------------------
# Collectives over one axis of a runtime mesh, in ascending index
# ---------------------------------------------------------------------------
#
# Each takes the mesh explicitly: a backward (and a checkpoint's recompute)
# may run on autograd's own thread, where the env installed here is not.


def gather(x: torch.Tensor, mesh, axis: str) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axis`` of ``mesh``, in ascending index
    (no grad; ``RuntimeMesh.gather``)."""
    if mesh.shape[axis] == 1:
        return [x]
    return mesh.gather(x, axis)


def ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ..., one add after another."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _Psum(torch.autograd.Function):
    """The sum over an axis whose result every rank of it uses alike:
    the backward is the identity (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return ordered_sum(gather(x, mesh, axis))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pmean(torch.autograd.Function):
    """The mean over the data axis (the reference's ``pmean``): each rank's
    input reaches every rank's loss, so its cotangent is the mean of
    theirs."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return ordered_sum(gather(x, mesh, axis)) / mesh.shape[axis]

    @staticmethod
    def backward(ctx, g):
        return (ordered_sum(gather(g, ctx.mesh, ctx.axis))
                / ctx.mesh.shape[ctx.axis], None, None)


class _Enter(torch.autograd.Function):
    """Identity forward into a region each rank of ``axis`` computes a
    part of; the backward sums the parts' cotangents (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_sum(gather(g, ctx.mesh, ctx.axis)), None, None


class _GatherLast(torch.autograd.Function):
    """The reference's ``_ag_last``: the shards concatenated along the last
    dim in ascending index. The backward sums this rank's slice of the
    ranks' cotangents in ascending index."""

    @staticmethod
    def forward(ctx, w, mesh, axis):
        ctx.mesh, ctx.axis, ctx.n = mesh, axis, w.shape[-1]
        return torch.cat(gather(w, mesh, axis), dim=-1)

    @staticmethod
    def backward(ctx, g):
        i0 = ctx.mesh.index(ctx.axis) * ctx.n
        parts = gather(g, ctx.mesh, ctx.axis)
        return (ordered_sum([p[..., i0:i0 + ctx.n] for p in parts]),
                None, None)


# each the identity along an axis of size 1


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return x if mesh.shape[axis] == 1 else _Psum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return x if mesh.shape[axis] == 1 else _Pmean.apply(x, mesh, axis)


def enter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return x if mesh.shape[axis] == 1 else _Enter.apply(x, mesh, axis)


def gather_last(w: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return w if mesh.shape[axis] == 1 else _GatherLast.apply(w, mesh, axis)


def data_mean(paths: List[str], grads: List[torch.Tensor], env: AxisEnv
              ) -> List[torch.Tensor]:
    """The gradient of the global loss (the mean over the data group of the
    ranks' losses) from each rank's own: a leaf whole on every rank is
    summed over the data group in ascending index, a leaf split over data
    is already summed by ``gather_last``'s backward; both then divided by
    the group's size."""
    mesh = env.mesh
    nd = mesh.shape["data"]
    if nd == 1:
        return grads
    return [g / nd if "data" in leaf_axes(p, env)
            else ordered_sum(gather(g, mesh, "data")) / nd
            for p, g in zip(paths, grads)]


def shard_sums(paths: List[str], sums: List[torch.Tensor], env: AxisEnv
               ) -> List[torch.Tensor]:
    """Per-leaf sums (e.g. of squares) over the whole tree from each rank's
    shard's: a split leaf's summed over the groups that split it (data,
    then model, each in ascending index), a whole leaf's kept once."""
    mesh = env.mesh
    q = torch.stack(sums)
    for axis in ("data", env.model):
        flags = [axis in leaf_axes(p, env) for p in paths]
        if mesh.shape[axis] > 1 and any(flags):
            split = torch.tensor(flags, device=q.device)
            q = torch.where(split, ordered_sum(gather(q, mesh, axis)), q)
    return list(q.unbind())
