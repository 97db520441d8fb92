"""Diagonal-memory-optimised depthwise conv2d in one row-blocked arena.

The paper overlaps an op's input and output buffers inside the MCU's SRAM
arena. Here the arena is one typed ``(rows, rowlen)`` f32 tensor on the
card, with the input placed ``d_rows`` rows above the output region;
``d_rows`` comes from the *analytic* safe overlap ``O_s``
(:func:`repro_torch.kernels.ops.dwconv_overlap_rows`), rounded up to whole
rows. The kernel runs output row tiles over the whole card, and a tile
stores only once every tile of its row and of the rows before has read its
inputs, so the reads for output row ``i`` (input rows ``i*stride + d``
onward) happen before the store of row ``i``, and no live input value is
ever clobbered: the op needs ``max(rows_in + d, rows_out)`` arena rows
instead of ``rows_in + rows_out``.

The counterpart of the reference's
``src/repro/kernels/dmo_arena_dwconv.py::dmo_dwconv2d_arena``: one
row-blocked :class:`~repro_torch.kernels.arena_ops.OpSpec` (legacy
addressing, one image row per arena row) run by the arena's depthwise
kernel, ``csrc/arena_conv.cu``, through
:func:`~repro_torch.kernels.arena_ops.arena_conv`: its plain version on a
CPU arena, the kernel on a CUDA one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_ops import OpSpec, arena_conv


def dwconv_spec(*, ih: int, iw: int, c: int, k: int, stride: int, pad: int,
                d_rows: int, oh: int, ow: int, rowlen: int) -> OpSpec:
    """The row-blocked spec of the in-place depthwise conv: the input in
    rows ``[d_rows, d_rows + ih)`` using ``iw*c`` elements of each row,
    the output in rows ``[0, oh)``."""
    return OpSpec(
        kind="depthwise_conv2d",
        in_off=(d_rows,),
        in_shape=((ih, iw, c),),
        out_off=0,
        out_shape=(oh, ow, c),
        meta=(k, k, stride, stride, 1, 1, pad, pad, 1),
        rowlen=rowlen,
        in_rows=((ih, iw * c),),
        out_rows=(oh, ow * c),
    )


def dmo_dwconv2d_arena(arena: torch.Tensor, w: torch.Tensor, *, ih: int,
                       iw: int, c: int, stride: int, pad: int, d_rows: int,
                       oh: int, ow: int) -> torch.Tensor:
    """Run the in-place depthwise conv on a prepared arena and return it.

    arena: a contiguous (R, rowlen) f32 tensor with the input occupying
    rows [d_rows, d_rows+ih) and the first iw*c entries of each row; the
    output lands in rows [0, oh). w: (k, k, c) f32 on the arena's
    device."""
    k = int(w.shape[0])
    spec = dwconv_spec(ih=ih, iw=iw, c=c, k=k, stride=stride, pad=pad,
                       d_rows=d_rows, oh=oh, ow=ow,
                       rowlen=int(arena.shape[1]))
    # the arena's kernel takes (kh, kw, ic, multiplier) filters
    arena_conv(arena, spec, w.reshape(k, k, c, 1).contiguous())
    return arena
