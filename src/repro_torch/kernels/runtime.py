"""The port's one device switch.

Every entry point of the port takes ``device=None`` and resolves it here:
None is the card, and raises when no CUDA device is visible; ``"cuda"`` or
``"cuda:N"`` names a card; ``"cpu"`` runs every kernel's plain PyTorch
version instead. Nothing falls back from the card to the CPU.

There is no environment variable and no interpret flag. Where the JAX
package flips its Pallas kernels into interpret mode with
``REPRO_DMO_INTERPRET=1``, a caller of the port passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_ops import resolve_device

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The card the entry points run on by default; raises without one."""
    return resolve_device(None)
