"""Mesh-axis environment + activation sharding constraints.

The counterpart of the reference's ``src/repro/sharding.py``. The model
code is mesh-agnostic: it calls :func:`constrain` with *logical* axis names
("batch", "model", None...). The launcher installs an :class:`AxisEnv`
mapping logical names to physical mesh axes — e.g. batch -> ("pod",
"data") on the multi-pod mesh, ("data",) on one pod.

The port runs on one card and has no SPMD compiler: :func:`constrain`
returns its tensor unchanged, with no env and on every mesh. Specs are
tuples of axis names (a tuple of names where axes compose, None where
replicated); :meth:`AxisEnv.resolve` raises on an unknown logical name.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

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


@contextlib.contextmanager
def axis_env(mesh, batch: Tuple[str, ...] = ("data",), model: str = "model",
             fsdp: bool = False):
    prev = current_env()
    _state.env = AxisEnv(mesh, batch, model, fsdp)
    try:
        yield _state.env
    finally:
        _state.env = prev


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """The reference's with_sharding_constraint: the identity here (one
    card, no SPMD compiler)."""
    return x
