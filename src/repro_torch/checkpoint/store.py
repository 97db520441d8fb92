"""Checkpointing: a tree of tensors <-> npz with '/'-joined key paths.

The counterpart of the reference's ``src/repro/checkpoint/store.py``, in
its format: one ``np.savez`` file a step, named ``step_XXXXXXXX.npz``, with
the same keys, so each package reads the other's checkpoints. A float32
or int32 leaf is stored as its numpy array. A bfloat16 leaf is stored as
the reference's ``np.asarray`` of a JAX bfloat16 array comes out of npz:
its raw 2-byte payload, read back as ``|V2``; :func:`restore` views such
an array as ``torch.bfloat16`` where the template wants bfloat16.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_RAW_BF16 = np.dtype("V2")


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def save(path: str, tree, step: Optional[int] = None) -> str:
    """Writes ``tree`` (nested dicts of tensors) to ``path``, or to
    ``path/step_XXXXXXXX.npz`` when ``step`` is given; returns the file."""
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}.npz")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})
    return path


def _from_numpy(a: np.ndarray, like: torch.Tensor, device,
                key: str) -> torch.Tensor:
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint {key}: shape {a.shape}, expected "
                         f"{tuple(like.shape)}")
    a = np.ascontiguousarray(a).reshape(a.shape)  # keeps a 0-d leaf 0-d
    if a.dtype == _RAW_BF16:
        if like.dtype != torch.bfloat16:
            raise ValueError(f"checkpoint {key}: a bfloat16 payload for a "
                             f"{like.dtype} leaf")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    return t.to(device)


def restore(path: str, like, device=None):
    """Restore into the structure of ``like`` (nested dicts of tensors,
    whose shapes and dtypes the file must hold). Each leaf lands on
    ``device``, or on its template's device when ``device`` is None. A
    template leaf on the ``meta`` device is checked by name and returned
    as it is, unread: ``restore(path, {"params": params, "opt": meta})``
    loads a state's params alone."""
    with np.load(path) as z:
        flat_like = _flatten(like)
        if set(flat_like) != set(z.files):
            raise ValueError(f"checkpoint keys mismatch: "
                             f"{sorted(set(flat_like) ^ set(z.files))}")

        def build(template, prefix=""):
            if isinstance(template, dict):
                return {k: build(v, f"{prefix}{k}/")
                        for k, v in template.items()}
            if isinstance(template, (list, tuple)):
                return type(template)(build(v, f"{prefix}{i}/")
                                      for i, v in enumerate(template))
            if template.device.type == "meta":
                return template
            key = prefix[:-1]
            return _from_numpy(z[key], template, device or template.device,
                               key)
        return build(like)


def latest(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    cands = sorted(f for f in os.listdir(path)
                   if f.startswith("step_") and f.endswith(".npz"))
    return os.path.join(path, cands[-1]) if cands else None
