"""Public wrappers around the standalone kernels.

``dmo_dwconv2d`` is the end-to-end DMO path: it computes the analytic safe
overlap ``O_s`` with the *paper's* formulas
(:mod:`repro_torch.core.overlap.analytic`), converts it to a row-granular
arena offset, lays the input into the shared arena and runs the in-place
kernel. ``dmo_dwconv2d_footprint`` reports the arena against the
two-buffer baseline. ``rmsnorm_residual`` is the in-place fused residual +
RMSNorm (its output is x's storage) and ``flash_attention`` the blockwise
online-softmax attention. The counterparts of the reference's
``src/repro/kernels/ops.py`` wrappers of the same names; they run on the
card unless the caller passes ``device="cpu"`` (the plain versions), and
raise without a card rather than fall back.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.graph import Graph
from repro_torch.core.overlap import safe_overlap
from repro_torch.kernels.arena_ops import resolve_device
from repro_torch.kernels.dmo_arena_dwconv import dmo_dwconv2d_arena
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.inplace_rmsnorm import \
    rmsnorm_scale_residual_inplace


def dwconv_overlap_rows(ih: int, iw: int, c: int, k: int, stride: int,
                        pad: int) -> Tuple[int, int, int]:
    """(d_rows, oh, ow): arena row offset of the input derived from the
    paper's analytic O_s, rounded up to whole output rows (block-granular)."""
    oh = (ih + 2 * pad - k) // stride + 1
    ow = (iw + 2 * pad - k) // stride + 1
    g = Graph("k")
    x = g.tensor("x", (ih, iw, c), 4, "input")
    g.op("depthwise_conv2d", [x], (oh, ow, c),
         dict(kernel=(k, k), stride=(stride, stride),
              padding="same" if pad else "valid", multiplier=1))
    os_bytes = safe_overlap(g.ops[0], 0, method="analytic")
    ob = oh * ow * c * 4
    row_bytes = max(iw, ow) * c * 4
    d_rows = math.ceil((ob - os_bytes) / row_bytes)
    return d_rows, oh, ow


def dmo_dwconv2d(x, w, stride: int = 1, pad: int = 0,
                 device=None) -> torch.Tensor:
    """Depthwise conv through one shared arena. x: (IH, IW, C) f32, w:
    (K, K, C) f32 (tensors or arrays); returns (OH, OW, C) f32 on
    ``device`` (None: the card, raising without one; ``"cpu"``: the plain
    version)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    w = torch.as_tensor(w, dtype=torch.float32).to(dev)
    ih, iw, c = x.shape
    k = int(w.shape[0])
    d_rows, oh, ow = dwconv_overlap_rows(ih, iw, c, k, stride, pad)
    rowlen = max(iw, ow) * c
    arena = torch.zeros((max(d_rows + ih, oh), rowlen), dtype=torch.float32,
                        device=dev)
    arena[d_rows:d_rows + ih, :iw * c] = x.reshape(ih, iw * c)
    dmo_dwconv2d_arena(arena, w, ih=ih, iw=iw, c=c, stride=stride, pad=pad,
                       d_rows=d_rows, oh=oh, ow=ow)
    return arena[:oh, :ow * c].reshape(oh, ow, c).clone()


def dmo_dwconv2d_footprint(ih: int, iw: int, c: int, k: int, stride: int,
                           pad: int) -> Tuple[int, int]:
    """(arena bytes, two-buffer bytes): the kernel-level memory saving."""
    d_rows, oh, ow = dwconv_overlap_rows(ih, iw, c, k, stride, pad)
    rowlen = max(iw, ow) * c * 4
    return (max(d_rows + ih, oh) * rowlen, ih * iw * c * 4 + oh * ow * c * 4)


def _on(t, dev: torch.device) -> torch.Tensor:
    """``t`` (a tensor or an array) as a tensor on ``dev``; a tensor already
    there is the same tensor, and a numpy array on the CPU shares its
    memory (``torch.as_tensor``)."""
    return torch.as_tensor(t).to(dev)


def rmsnorm_residual(x, g, r, device=None) -> torch.Tensor:
    """In-place fused residual + RMSNorm: ``r + rmsnorm(x) * g``, written
    over x (O_s = |out|). x, r: (N, d); g: (d,); float32 or bfloat16,
    computed in float32. **Overwrites x** when x is already a tensor on
    ``device`` (None: the card, raising without one; ``"cpu"``: the plain
    version) and returns it: the result is x's own storage. An x elsewhere
    is first copied there, and the copy is overwritten and returned."""
    dev = resolve_device(device)
    return rmsnorm_scale_residual_inplace(_on(x, dev), _on(g, dev),
                                          _on(r, dev))


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, device=None) -> torch.Tensor:
    """Blockwise online-softmax attention. q: (S, H, D); k, v: (T, H, D)
    with q's H (grouped-query expansion stays with the caller); float32 or
    bfloat16, the softmax in float32 (bfloat16's products on the card's
    tensor cores, accumulated in float32); returns (S, H, D) in q's type
    on ``device`` (None: the card, raising without one; ``"cpu"``: the
    plain version, which walks ``block_q`` x ``block_k`` blocks as the
    reference does). On the card q, k and v start on 16-byte boundaries
    (a misaligned view raises ``ValueError``)."""
    dev = resolve_device(device)
    return flash_attention_kernel(_on(q, dev), _on(k, dev), _on(v, dev),
                                  causal=causal, block_q=block_q,
                                  block_k=block_k)
