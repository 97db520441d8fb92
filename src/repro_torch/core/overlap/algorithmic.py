"""Algorithmic method for the safe buffer overlap (paper §III-C, Alg. 2).

For each op kind we strip the arithmetic out of the TFLite reference loop
nest and keep only the offset computation, producing two arrays:

- ``minR[i]`` — minimum *input-buffer* offset read at step ``i`` or any
  future step (built with a reverse cumulative min);
- ``maxW[i]`` — maximum *output-buffer* offset written at step ``i`` or any
  previous step (``arange`` for the write-one-element-per-step kinds).

Then (Eq. 1):  ``O_s = |out| + min_i(minR[i] - maxW[i])`` — all in bytes here.

The loop nests are vectorised with NumPy so that million-step ops (full
MobileNet/Inception layers) are analysed in milliseconds.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Op, Tensor, op_pads

_INF = np.iinfo(np.int64).max // 4


def _rev_cummin(a: np.ndarray) -> np.ndarray:
    return np.minimum.accumulate(a[::-1])[::-1]


def _min_valid_coord(out_coords: np.ndarray, stride: int, pad: int, k: int,
                     dilation: int, in_dim: int) -> np.ndarray:
    """Per output coordinate: the smallest valid input coordinate touched by
    the kernel window, or _INF if the window is entirely padding."""
    start = out_coords * stride - pad                      # fy = 0 position
    # first kernel tap with coordinate >= 0
    f0 = np.maximum(0, -(-(-start) // dilation))           # ceil(-start/dil)
    f0 = np.where(start >= 0, 0, f0)
    coord = start + f0 * dilation
    valid = (f0 < k) & (coord < in_dim)
    return np.where(valid, coord, _INF)


def _spatial_min_read(op: Op) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Min input read offset (in elements) per (oy, ox) for conv-family ops.

    Returns the (Oh, Ow) int64 array of min read offsets where the minimum is
    taken over the kernel window (smallest valid iy, then smallest valid ix,
    channel 0), plus the (Ih, Iw, Id) input shape.
    """
    x = op.inputs[0]
    ih, iw, idep = _hwc(x.shape)
    oh, ow, od = _hwc(op.output.shape)
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    kh, kw = op.params["kernel"]
    # band-aware: row-banded ops substitute their explicit per-band pads
    # (possibly negative ph) and the whole band-local loop nest — reads
    # confined to the halo rows, writes to the band's output rows — falls
    # out of the same offset arithmetic
    ph, pw = op_pads(op)
    iy = _min_valid_coord(np.arange(oh), sh, ph, kh, dh, ih)   # (Oh,)
    ix = _min_valid_coord(np.arange(ow), sw, pw, kw, dw, iw)   # (Ow,)
    grid = iy[:, None] * (iw * idep) + ix[None, :] * idep       # (Oh, Ow)
    grid = np.where((iy[:, None] >= _INF) | (ix[None, :] >= _INF), _INF, grid)
    return grid.astype(np.int64), (ih, iw, idep)


def _hwc(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """Interpret a shape as (H, W, C), folding any leading batch of 1."""
    s = tuple(shape)
    while len(s) > 3 and s[0] == 1:
        s = s[1:]
    if len(s) == 3:
        return s
    if len(s) == 2:
        return (1, s[0], s[1])
    if len(s) == 1:
        return (1, 1, s[0])
    raise ValueError(f"cannot interpret shape {shape} as HWC (batch must be 1)")


# ---------------------------------------------------------------------------
# Per-kind (minR, steps) profiles, offsets in *elements*
# ---------------------------------------------------------------------------


def _profile_conv2d(op: Op, input_index: int) -> np.ndarray:
    # steps: (oy, ox, oc); reads of input 0 at min (iy, ix, 0)
    grid, _ = _spatial_min_read(op)
    _, _, od = _hwc(op.output.shape)
    return np.repeat(grid.reshape(-1), od)


def _profile_depthwise(op: Op, input_index: int) -> np.ndarray:
    # steps: (oy, ox, ic, m); reads input channel ic only
    grid, (_, _, idep) = _spatial_min_read(op)
    kc = op.params.get("multiplier", 1)
    base = np.repeat(grid.reshape(-1), idep * kc)           # (Oh*Ow*Id*Kc,)
    chan = np.tile(np.repeat(np.arange(idep), kc), grid.size)
    return np.where(base >= _INF, _INF, base + chan)


def _profile_pool(op: Op, input_index: int) -> np.ndarray:
    grid, (_, _, idep) = _spatial_min_read(op)
    base = np.repeat(grid.reshape(-1), idep)
    chan = np.tile(np.arange(idep), grid.size)
    return np.where(base >= _INF, _INF, base + chan)


def _profile_elementwise(op: Op, input_index: int) -> np.ndarray:
    out_e = op.output.elems
    in_e = op.inputs[input_index].elems
    if in_e == out_e:
        return np.arange(out_e, dtype=np.int64)
    # broadcast input (e.g. bias): read offset i % in_e
    return np.arange(out_e, dtype=np.int64) % in_e


def _profile_softmax(op: Op, input_index: int) -> np.ndarray:
    # max & sum passes read everything before the first write; the write pass
    # reads in[i] at step i. Folding the pre-pass reads into step 0 keeps
    # minR[0] = 0 which is already implied by the write-pass reads.
    return np.arange(op.output.elems, dtype=np.int64)


def _profile_fully_connected(op: Op, input_index: int) -> np.ndarray:
    # steps: (b, oc); each step reads the whole input row b
    x = op.inputs[input_index]
    out_e = op.output.elems
    od = op.output.shape[-1]
    idim = x.shape[-1]
    b = np.arange(out_e, dtype=np.int64) // od
    return b * idim


def _profile_matmul_rhs(op: Op, input_index: int) -> np.ndarray:
    # reading the RHS: every step reads from offset (0 .. Id*Od); min read of
    # step (b, oc) is column oc's first element = oc (row-major (Id, Od)).
    od = op.output.shape[-1]
    out_e = op.output.elems
    return np.arange(out_e, dtype=np.int64) % od


def _profile_concat(op: Op, input_index: int) -> np.ndarray:
    axis = op.params.get("axis", -1)
    out = op.output
    shape = out.shape
    if axis < 0:
        axis += len(shape)
    outer = int(np.prod(shape[:axis])) if axis > 0 else 1
    inner = int(np.prod(shape[axis + 1:])) if axis + 1 < len(shape) else 1
    sizes = [t.shape[axis] for t in op.inputs]
    target = op.inputs[input_index]
    out_e = out.elems
    minr = np.full(out_e, _INF, dtype=np.int64)
    # output written sequentially; input j's slice within each outer block
    block = shape[axis] * inner
    start_in_block = sum(sizes[:input_index]) * inner
    seg = sizes[input_index] * inner
    for o in range(outer):
        s = o * block + start_in_block
        minr[s:s + seg] = o * seg + np.arange(seg)
    return minr


def _profile_pad(op: Op, input_index: int) -> np.ndarray:
    pads = op.params["paddings"]  # [(lo, hi)] per dim
    x = op.inputs[input_index]
    out = op.output
    out_e = out.elems
    # mapped input offset per output element; padding positions read nothing
    idx = np.arange(out_e, dtype=np.int64)
    coords = []
    rem = idx
    for d in range(len(out.shape) - 1, -1, -1):
        coords.append(rem % out.shape[d])
        rem = rem // out.shape[d]
    coords = coords[::-1]
    in_off = np.zeros(out_e, dtype=np.int64)
    valid = np.ones(out_e, dtype=bool)
    stride = 1
    for d in range(len(x.shape) - 1, -1, -1):
        c = coords[d] - pads[d][0]
        valid &= (c >= 0) & (c < x.shape[d])
        in_off += np.clip(c, 0, x.shape[d] - 1) * stride
        stride *= x.shape[d]
    return np.where(valid, in_off, _INF)


def _profile_mean(op: Op, input_index: int) -> np.ndarray:
    # all reads complete (accumulators) before the first write
    out_e = op.output.elems
    minr = np.full(out_e, _INF, dtype=np.int64)
    minr[0] = 0
    return minr


def _profile_embedding(op: Op, input_index: int) -> np.ndarray:
    # reads id i when writing row i: minR = row index
    out = op.output
    row = out.shape[-1]
    return np.arange(out.elems, dtype=np.int64) // row


_PROFILES = {
    "conv2d": _profile_conv2d,
    "depthwise_conv2d": _profile_depthwise,
    "pool": _profile_pool,
    "elementwise": _profile_elementwise,
    "softmax": _profile_softmax,
    "fully_connected": _profile_fully_connected,
    "concat": _profile_concat,
    "pad": _profile_pad,
    "mean": _profile_mean,
    "embedding_lookup": _profile_embedding,
}


def min_read_profile(op: Op, input_index: int = 0) -> Optional[np.ndarray]:
    """Raw per-step min read offset (elements, _INF = no read). None means
    "no model" (fully conservative)."""
    if op.kind == "matmul":
        return (_profile_fully_connected(op, input_index) if input_index == 0
                else _profile_matmul_rhs(op, input_index))
    fn = _PROFILES.get(op.kind)
    if fn is None:
        return None
    return fn(op, input_index)


def safe_overlap_algorithmic(op: Op, input_index: int = 0) -> int:
    """Exact ``O_s`` in bytes for (op, input_index) per Alg. 2."""
    out = op.output
    if op.kind == "reshape":
        return 0  # aliasing handled by the graph, not by overlap
    raw = min_read_profile(op, input_index)
    if raw is None:
        return 0  # custom / unknown: fully conservative
    ts_in = op.inputs[input_index].dtype_bytes
    ts_out = out.dtype_bytes
    minr_b = np.where(raw >= _INF, _INF, raw * ts_in)
    minr_b = _rev_cummin(minr_b)
    maxw_b = np.arange(out.elems, dtype=np.int64) * ts_out  # monotone writes
    diff = minr_b - maxw_b
    mind = int(min(diff.min(), 0)) if diff.size else 0
    os_bytes = out.nbytes + ts_out + mind - ts_out  # = OB + minD (bytes)
    # clip: the metric is "overlap of input start with output end"
    return int(max(0, min(out.nbytes, os_bytes)))
