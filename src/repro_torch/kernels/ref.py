"""Plain PyTorch oracles of the standalone kernels (the allclose ground
truth), in the layouts of the reference's ``src/repro/kernels/ref.py``:
full computations in float32, no blocking, cast back to the input's type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dwconv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             pad: int = 0) -> torch.Tensor:
    """x: (IH, IW, C); w: (KH, KW, C) -> (OH, OW, C)."""
    ih, iw, c = x.shape
    kh, kw, _ = w.shape
    oh = (ih + 2 * pad - kh) // stride + 1
    ow = (iw + 2 * pad - kw) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    out = torch.zeros((oh, ow, c), dtype=torch.float32, device=x.device)
    for fy in range(kh):
        for fx in range(kw):
            sl = xp[fy:fy + oh * stride:stride, fx:fx + ow * stride:stride]
            out = out + sl.float() * w[fy, fx][None, None, :]
    return out.to(x.dtype)


def rmsnorm_scale_residual(x: torch.Tensor, g: torch.Tensor,
                           r: torch.Tensor, eps: float = 1e-6
                           ) -> torch.Tensor:
    """out = r + rmsnorm(x) * g (rows along the last axis); a new tensor."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (r.float() + y * g.float()).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """q: (S, H, D); k, v: (T, H, D), one batch; full softmax. The causal
    mask is bottom-right aligned (``kpos <= qpos + t - s``) with the
    finite -1e30, so a row that sees no key averages v over all keys."""
    s, h, d = q.shape
    t = k.shape[0]
    sc = torch.einsum("shd,thd->hst", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None] + (t - s))
        sc = torch.where(mask[None], sc, torch.full_like(sc, -1e30))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("hst,thd->shd", w, v.float()).to(q.dtype)
