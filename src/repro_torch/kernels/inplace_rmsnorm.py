"""In-place fused residual-add + RMSNorm.

The paper's ideal diagonal case (Fig. 3a): a per-row op has
``O_s = |out|``, so its input and output share all their storage. The
reference realises it with ``input_output_aliases={0: 0}``; here the
kernel, ``csrc/rmsnorm_inplace.cu``, writes each row of the result over
the same row of ``x`` (one CTA per row; every read of the row completes
before its first store), and the wrapper returns ``x`` itself. On the card
the call allocates no buffer of ``x``'s size.

The counterpart of the reference's
``src/repro/kernels/inplace_rmsnorm.py::rmsnorm_scale_residual_inplace``.
"""
from __future__ import annotations

import torch

#: Launches of ``csrc/rmsnorm_inplace.cu`` since :func:`reset_launches`;
#: the wrapper adds one where it launches the kernel and nowhere else.
LAUNCHES = 0

_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def rmsnorm_plain(x: torch.Tensor, g: torch.Tensor, r: torch.Tensor,
                  eps: float = 1e-6, block: int = 128) -> torch.Tensor:
    """The plain PyTorch version: ``x <- r + x*rsqrt(mean(x²)+eps)*g`` in
    float32, written into ``x`` block of ``block`` rows by block (the
    reference's grid, its block shrunk to a divisor of the rows); returns
    ``x``."""
    n = x.shape[0]
    b = min(block, n)
    while n % b:
        b -= 1
    gf = g.float()
    for i in range(0, n, b):
        xf = x[i:i + b].float()
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * gf
        x[i:i + b] = (r[i:i + b].float() + y).to(x.dtype)
    return x


def rmsnorm_scale_residual_inplace(x: torch.Tensor, g: torch.Tensor,
                                   r: torch.Tensor, eps: float = 1e-6,
                                   block: int = 128) -> torch.Tensor:
    """x, r: (N, d), both float32 or both bfloat16; g: (d,) float32 or
    bfloat16. **Overwrites x** with ``r + rmsnorm(x) * g`` (computed in
    float32, rounded to x's type) and returns x itself. On the CPU this is :func:`rmsnorm_plain`; on the card
    the kernel, whose grid is one CTA per row (``block`` keeps the
    reference's meaning only in the plain version)."""
    if x.dim() != 2 or r.shape != x.shape or g.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x, r must be (N, d) and g (d,); got "
                         f"{tuple(x.shape)}, {tuple(r.shape)}, "
                         f"{tuple(g.shape)}")
    if x.dtype not in _TYPES or r.dtype != x.dtype or g.dtype not in _TYPES:
        raise ValueError(f"rmsnorm: x and r float32 or bfloat16, one type, "
                         f"and g either; got {x.dtype}, {r.dtype}, "
                         f"{g.dtype}")
    if x.device != r.device or x.device != g.device:
        raise ValueError("rmsnorm: x, g and r must be on one device")
    if not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError("rmsnorm: x and r must be contiguous")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, g, r, eps, block)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    from repro_torch.kernels import build
    gf = g.float().contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.entry("rmsnorm_inplace")(
        x.data_ptr(), r.data_ptr(), gf.data_ptr(), x.shape[0], x.shape[1],
        int(x.dtype == torch.bfloat16), eps, stream), "rmsnorm_inplace")
    global LAUNCHES
    LAUNCHES += 1
    return x
