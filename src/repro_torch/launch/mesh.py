"""Meshes: named axes over devices.

The counterpart of the reference's ``src/repro/launch/mesh.py``.
Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2, data=16,
model=16) = 512 chips; the ``pod`` axis composes with ``data`` for batch
sharding (pure data parallel across pods).

The port runs one card and has no SPMD compiler, so a :class:`Mesh` is a
description: axis names and sizes, the shape the sharding rules
(``launch/specs.py``) and the dry run (``launch/dryrun.py``) read, and,
for the host mesh, the devices it covers. Building one touches no device.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes; ``devices`` the devices of a host mesh
    (empty for a description of a production mesh)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[str, ...] = ()

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the cards that are visible (the CPU when
    there is none), shrunk to (1, 1) when they are too few."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = tuple(f"cuda:{i}" for i in range(n)) or ("cpu",)
    if data * model > len(devices):
        data, model = 1, 1
    return Mesh(("data", "model"), (data, model), devices[:data * model])
