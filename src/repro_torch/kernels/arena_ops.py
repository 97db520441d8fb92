"""Flat-arena kernels for Hopper: one wrapper per hand-written CUDA kernel,
each beside its plain PyTorch version.

The arena is ONE ``torch.uint8`` tensor of exactly the plan's peak bytes.
Every lowered op (an :class:`OpSpec`) addresses its operands at byte
offsets in it (f32 operands at 4-byte-aligned offsets) and runs in place:

=========================  ==================================================
wrapper                    TPU kernel it replaces (src/repro/kernels/arena_ops.py)
=========================  ==================================================
:func:`arena_conv`         ``_conv_kernel`` (conv2d and depthwise)
:func:`arena_mean`         ``_mean_kernel``
:func:`arena_fully_connected`  ``_fully_connected_kernel``
:func:`arena_softmax`      ``_softmax_kernel``
:func:`arena_fused_chain`  ``_fused_kernel`` with ``_RoutedFlatMem`` and the
                           ``_concat_kernel``/``_rescale`` terminal stage
=========================  ==================================================

A wrapper checks device, dtype, shape and contiguity, then routes on the
arena's device alone: a CPU arena runs the plain version, a CUDA arena
launches the kernel (built from ``csrc/`` by :mod:`.build`) or raises. A
CUDA arena never takes the plain route. Each launch adds one to
:data:`LAUNCHES`.

The plain versions walk output rows in Python with torch ops on typed views
of the arena bytes, in the reference's order (every read of row ``oy``
before its store, rows ascending; whole-block ops read everything before
writing), so they are exact on in-place and diagonally overlapped layouts.
The CPU tests hold them against the Pallas kernels in interpret mode, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Hashable, fully static description of one lowered op; the same
    fields in the same order as the reference's ``OpSpec``, so the two
    compare equal under :func:`dataclasses.astuple`.

    ``rowlen == 0`` selects the flat byte program (the only one this
    package runs so far): ``in_off``/``out_off`` are byte offsets into the
    1-D uint8 arena. The row-blocked (``rowlen > 0``) and streaming
    (``win_rows > 0``) fields are carried so specs stay comparable. A fused
    band chain (``kind == "fused"``) carries its member ops as ``stages``;
    stage operands whose ``in_scratch``/``out_scratch`` flag is set address
    the chain's scratch buffer of ``scratch_rows`` bytes."""

    kind: str
    in_off: Tuple[int, ...]
    in_shape: Tuple[Tuple[int, ...], ...]
    out_off: int
    out_shape: Tuple[int, ...]
    dtype: str = "f32"                 # arena tier: "f32" | "i8"
    meta: Tuple = ()                   # kind-specific statics
    qmeta: Tuple = ()                  # int8 statics (zero points, multipliers)
    rowlen: int = 0
    in_rows: Tuple[Tuple[int, int], ...] = ()
    out_rows: Tuple[int, int] = ()
    win_lo: int = 0
    win_rows: int = 0
    win_starts: Tuple[int, ...] = ()
    in_addr: Tuple[Tuple[int, int, int], ...] = ()
    out_addr: Tuple[int, int, int] = ()
    out_tile: int = 0
    stages: Tuple["OpSpec", ...] = ()
    scratch_rows: int = 0              # chain scratch bytes (flat program)
    in_scratch: Tuple[int, ...] = ()
    out_scratch: int = 0
    in_slots: Tuple[int, ...] = ()
    out_slot: int = 0


#: Op kinds that carry one weight operand.
WEIGHTED_KINDS = frozenset({"conv2d", "depthwise_conv2d", "fully_connected"})

#: Launches per kernel since :func:`reset_launches`; each wrapper adds one
#: where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {
    "arena_conv": 0, "arena_mean": 0, "arena_fully_connected": 0,
    "arena_softmax": 0, "arena_fused_chain": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def spec_weight_count(spec: OpSpec) -> int:
    """Weight operands a lowered spec consumes (a fused chain consumes all
    of its stages' weights, in stage order)."""
    if spec.kind == "fused":
        return sum(1 for st in spec.stages if st.kind in WEIGHTED_KINDS)
    return 1 if spec.kind in WEIGHTED_KINDS else 0


def _elems(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _isz(dtype: str) -> int:
    return 1 if dtype == "i8" else 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Descriptors: the int32 words the CUDA kernels read (csrc/arena_common.cuh
# holds the same word offsets)
# ---------------------------------------------------------------------------

NT = 512                 # threads of the one CTA
MAXPT = 16               # row outputs one thread holds in registers
ROW_LIMIT = NT * MAXPT   # widest output row (ow * oc) a conv kernel takes
DESC_WORDS = 128
MAX_CAT = 16
#: Dynamic shared memory one CTA can use on Hopper (227 KB).
SMEM_LIMIT = 232_448

K_CONV2D, K_DEPTHWISE, K_CONCAT, K_MEAN, K_FC, K_SOFTMAX = range(6)
_KIND_CODE = {"conv2d": K_CONV2D, "depthwise_conv2d": K_DEPTHWISE,
              "concat": K_CONCAT, "mean": K_MEAN, "fully_connected": K_FC,
              "softmax": K_SOFTMAX}
(D_KIND, D_QUANT, D_WOFF, D_IN_OFF, D_OUT_OFF, D_IN_SCR, D_OUT_SCR, D_X_ZP,
 D_Y_ZP, D_AMULT) = range(10)
(D_IH, D_IW, D_IC, D_OH, D_OW, D_OC, D_KH, D_KW, D_SH, D_SW, D_DH, D_DW,
 D_PH, D_PW, D_MULT) = range(10, 25)
D_DIM0, D_RMASK, D_CNT, D_OUTN = 10, 14, 15, 16
D_M, D_IDIM, D_ODIM = 10, 11, 12
D_ROWS, D_LAST, D_XSCALE, D_YSCALE = 10, 11, 12, 13
D_NIN, D_OUTER, D_INNER_OUT = 10, 11, 12
D_CIN_OFF, D_CIN_SCR, D_CINNER, D_CZP, D_CMULT = 16, 32, 48, 64, 80


def _fbits(x: float) -> int:
    """The int32 word holding float32 ``x``'s bits."""
    return struct.unpack("<i", struct.pack("<f", float(np.float32(x))))[0]


def _check_flat(spec: OpSpec) -> None:
    if spec.rowlen or spec.win_rows:
        raise NotImplementedError(
            f"{spec.kind}: only the flat byte program is ported; row-blocked "
            "and streaming specs come with ROADMAP queue 1 (blocked "
            "addressing, then streaming)")


def _conv_geometry(spec: OpSpec) -> Tuple[int, ...]:
    ih, iw, ic = spec.in_shape[0][-3:]
    oh, ow, oc = spec.out_shape[-3:]
    if ow * oc > ROW_LIMIT:
        raise ValueError(f"{spec.kind}: output row of {ow * oc} elements "
                         f"exceeds the kernel's {ROW_LIMIT}")
    return ih, iw, ic, oh, ow, oc


def _weight_shape(spec: OpSpec) -> Tuple[int, ...]:
    if spec.kind == "fully_connected":
        idim = spec.in_shape[0][-1]
        m = _elems(spec.in_shape[0]) // idim
        return (idim, _elems(spec.out_shape) // m)
    kh, kw = spec.meta[:2]
    ic = spec.in_shape[0][-1]
    if spec.kind == "depthwise_conv2d":
        return (kh, kw, ic, spec.meta[8])
    return (kh, kw, ic, spec.out_shape[-1])


def _op_words(spec: OpSpec, woff: int = 0) -> List[int]:
    """One op's DESC_WORDS descriptor words."""
    w = [0] * DESC_WORDS
    q = spec.dtype == "i8"
    w[D_KIND] = _KIND_CODE.get(spec.kind, -1)
    w[D_QUANT] = int(q)
    w[D_WOFF] = woff
    w[D_IN_OFF] = spec.in_off[0]
    w[D_OUT_OFF] = spec.out_off
    w[D_IN_SCR] = spec.in_scratch[0] if spec.in_scratch else 0
    w[D_OUT_SCR] = spec.out_scratch
    k = spec.kind
    if k in ("conv2d", "depthwise_conv2d", "fully_connected", "mean") and q:
        x_zp, amult, y_zp = spec.qmeta
        w[D_X_ZP], w[D_AMULT], w[D_Y_ZP] = x_zp, _fbits(amult), y_zp
    if k in ("conv2d", "depthwise_conv2d"):
        w[D_IH:D_OC + 1] = _conv_geometry(spec)
        w[D_KH:D_MULT + 1] = spec.meta
    elif k == "mean":
        shape = tuple(spec.in_shape[0])
        if len(shape) > 4:
            raise ValueError(f"mean over a {len(shape)}-d input")
        axes = {a % len(shape) for a in spec.meta[0]}
        pad = 4 - len(shape)
        w[D_DIM0:D_DIM0 + 4] = (1,) * pad + shape
        w[D_RMASK] = sum(1 << (a + pad) for a in axes)
        w[D_CNT] = _elems(shape[a] for a in axes)
        w[D_OUTN] = _elems(s for i, s in enumerate(shape) if i not in axes)
    elif k == "fully_connected":
        idim = spec.in_shape[0][-1]
        m = _elems(spec.in_shape[0]) // idim
        w[D_M], w[D_IDIM], w[D_ODIM] = m, idim, _elems(spec.out_shape) // m
    elif k == "softmax":
        last = spec.in_shape[0][-1]
        w[D_ROWS], w[D_LAST] = _elems(spec.in_shape[0]) // last, last
        if q:
            (xs, xzp), (ys, yzp) = spec.qmeta
            w[D_X_ZP], w[D_XSCALE] = xzp, _fbits(xs)
            w[D_Y_ZP], w[D_YSCALE] = yzp, _fbits(ys)
    elif k == "concat":
        n = len(spec.in_shape)
        if n > MAX_CAT:
            raise ValueError(f"concat of {n} inputs exceeds {MAX_CAT}")
        nd = len(spec.out_shape)
        axis = spec.meta[0] % nd
        w[D_NIN] = n
        w[D_OUTER] = _elems(spec.out_shape[:axis])
        w[D_INNER_OUT] = _elems(spec.out_shape[axis:])
        in_q = spec.qmeta[0] if q else ((0, 1.0),) * n
        if q:
            w[D_Y_ZP] = spec.qmeta[1][0]
        for i in range(n):
            w[D_CIN_OFF + i] = spec.in_off[i]
            w[D_CIN_SCR + i] = spec.in_scratch[i] if spec.in_scratch else 0
            w[D_CINNER + i] = _elems(spec.in_shape[i][axis:])
            w[D_CZP + i] = in_q[i][0]
            w[D_CMULT + i] = _fbits(in_q[i][1])
    else:
        raise NotImplementedError(
            f"op kind {k!r} has no CUDA kernel yet (ROADMAP queue 1: pool, "
            "elementwise, matmul and pad come after the blocked addressing)")
    return w


def weight_offsets(spec: OpSpec) -> Tuple[Tuple[Optional[int], ...], int]:
    """Byte offset of each fused stage's filter in the packed weight blob
    (None for stages without one; 16-byte aligned), and the blob size."""
    offs: List[Optional[int]] = []
    cur = 0
    for st in spec.stages:
        if st.kind not in WEIGHTED_KINDS:
            offs.append(None)
            continue
        cur = _round_up(cur, 16)
        offs.append(cur)
        cur += _elems(_weight_shape(st)) * _isz(st.dtype)
    return tuple(offs), cur


def descriptor_words(spec: OpSpec) -> np.ndarray:
    """The int32 descriptor of a lowered spec: one op's words, or for a
    fused chain a header (word 0 = stage count) and then every stage's."""
    _check_flat(spec)
    if spec.kind != "fused":
        return np.asarray(_op_words(spec), np.int32)
    offs, _ = weight_offsets(spec)
    head = [0] * DESC_WORDS
    head[0] = len(spec.stages)
    words = head
    for st, off in zip(spec.stages, offs):
        if st.kind not in ("conv2d", "depthwise_conv2d", "concat"):
            raise NotImplementedError(
                f"fused stage kind {st.kind!r} has no CUDA routine")
        words = words + _op_words(st, off or 0)
    return np.asarray(words, np.int32)


def descriptor(spec: OpSpec, device) -> torch.Tensor:
    """The spec's descriptor uploaded to ``device`` (callers cache it per
    spec, so repeated executions upload nothing)."""
    return torch.from_numpy(descriptor_words(spec)).to(device)


def pack_weights(spec: OpSpec, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """A fused chain's stage filters, in stage order, packed into one uint8
    blob at :func:`weight_offsets` (the layout the fused kernel reads)."""
    offs, total = weight_offsets(spec)
    stages = [st for st in spec.stages if st.kind in WEIGHTED_KINDS]
    if len(weights) != len(stages):
        raise ValueError(f"fused chain takes {len(stages)} filters, got "
                         f"{len(weights)}")
    blob = torch.zeros(total, dtype=torch.uint8,
                       device=weights[0].device if weights else "cpu")
    for st, w, off in zip(stages, weights,
                          [o for o in offs if o is not None]):
        _check_weight(st, w)
        flat = w.contiguous().reshape(-1).view(torch.uint8)
        blob[off:off + flat.numel()].copy_(flat)
    return blob


def _check_weight(spec: OpSpec, w: torch.Tensor) -> None:
    want = torch.int8 if spec.dtype == "i8" else torch.float32
    if w.dtype != want or tuple(w.shape) != _weight_shape(spec):
        raise ValueError(f"{spec.kind}: filter {tuple(w.shape)} {w.dtype}, "
                         f"expected {_weight_shape(spec)} {want}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route, and the card's yardstick)
# ---------------------------------------------------------------------------


def _typed(buf: torch.Tensor, off: int, n: int, i8: bool) -> torch.Tensor:
    """A typed view of ``n`` elements at byte offset ``off``."""
    if i8:
        return buf[off:off + n].view(torch.int8)
    return buf[off:off + 4 * n].view(torch.float32)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _requant(acc: torch.Tensor, mult: float, zp: int) -> torch.Tensor:
    """ops.requantise: f32 product, round half to even, + zp, clip."""
    q = torch.round(acc.to(torch.float32) * _f32(mult)) + zp
    return q.clamp(-128, 127).to(torch.int8)


def _quant(v: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    q = torch.round(v / _f32(scale)) + zp
    return q.clamp(-128, 127).to(torch.int8)


def _dequant(x: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    return (x.to(torch.float32) - zp) * _f32(scale)


def _src(arena, scratch, flags, i):
    return scratch if flags and flags[i] else arena


def conv_plain(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
               scratch: Optional[torch.Tensor] = None) -> None:
    """conv2d / depthwise, rows ascending, each row's taps read before its
    store; taps at ``iy = oy*sh - ph + fy*dh`` outside the input count
    zero (after the zero-point shift in int8)."""
    ih, iw, ic, oh, ow, oc = _conv_geometry(spec)
    kh, kw, sh, sw, dh, dw, ph, pw, mult = spec.meta
    q = spec.dtype == "i8"
    isz = _isz(spec.dtype)
    src = _src(arena, scratch, spec.in_scratch, 0)
    dst = scratch if spec.out_scratch else arena
    wt = w.to(torch.int32) if q else w
    if q:
        x_zp, amult, y_zp = spec.qmeta
    cols = torch.arange(ow, device=arena.device)
    for oy in range(oh):
        acc = torch.zeros((ow, oc), dtype=torch.int32 if q else torch.float32,
                          device=arena.device)
        for fy in range(kh):
            iy = oy * sh - ph + fy * dh
            if not 0 <= iy < ih:
                continue
            row = _typed(src, spec.in_off[0] + iy * iw * ic * isz, iw * ic,
                         q).reshape(iw, ic)
            if q:
                row = row.to(torch.int32) - x_zp
            for fx in range(kw):
                ix = cols * sw - pw + fx * dw
                valid = ((ix >= 0) & (ix < iw))[:, None]
                taps = torch.where(valid, row[ix.clamp(0, iw - 1)],
                                   torch.zeros((), dtype=row.dtype))
                if spec.kind == "depthwise_conv2d":
                    acc += (taps[:, :, None] * wt[fy, fx][None]).reshape(
                        ow, ic * mult)
                elif q:
                    acc += (taps[:, :, None] * wt[fy, fx][None]).sum(
                        1, dtype=torch.int32)
                else:
                    acc += taps @ wt[fy, fx]
        out = _requant(acc, amult, y_zp) if q else acc
        _typed(dst, spec.out_off + oy * ow * oc * isz, ow * oc,
               q).copy_(out.reshape(-1))


def mean_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    q = spec.dtype == "i8"
    shape = tuple(spec.in_shape[0])
    x = _typed(arena, spec.in_off[0], _elems(shape), q).clone().reshape(shape)
    axes = tuple(sorted(a % len(shape) for a in spec.meta[0]))
    if q:
        x_zp, amult, y_zp = spec.qmeta
        cnt = _elems(shape[a] for a in axes)
        acc = x.to(torch.int32).sum(dim=axes, dtype=torch.int32)
        y = _requant(acc.to(torch.float32) / _f32(cnt) - x_zp, amult, y_zp)
    else:
        y = x.mean(dim=axes)
    _typed(arena, spec.out_off, y.numel(), q).copy_(y.reshape(-1))


def fully_connected_plain(arena: torch.Tensor, spec: OpSpec,
                          w: torch.Tensor) -> None:
    q = spec.dtype == "i8"
    idim = spec.in_shape[0][-1]
    n = _elems(spec.in_shape[0])
    x = _typed(arena, spec.in_off[0], n, q).clone().reshape(-1, idim)
    if q:
        x_zp, amult, y_zp = spec.qmeta
        acc = ((x.to(torch.int32) - x_zp)[:, :, None]
               * w.to(torch.int32)[None]).sum(1, dtype=torch.int32)
        y = _requant(acc, amult, y_zp)
    else:
        y = x @ w
    _typed(arena, spec.out_off, y.numel(), q).copy_(y.reshape(-1))


def softmax_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    q = spec.dtype == "i8"
    last = spec.in_shape[0][-1]
    n = _elems(spec.in_shape[0])
    x = _typed(arena, spec.in_off[0], n, q).clone().reshape(-1, last)
    if q:
        (xs, xzp), (ys, yzp) = spec.qmeta
        x = _dequant(x, xs, xzp)
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    y = e / e.sum(dim=-1, keepdim=True)
    if q:
        y = _quant(y, ys, yzp)
    _typed(arena, spec.out_off, n, q).copy_(y.reshape(-1))


def concat_plain(arena: torch.Tensor, spec: OpSpec,
                 scratch: Optional[torch.Tensor] = None) -> None:
    """concat along ``meta[0]``, int8 inputs rescaled to the output's
    params; every input is read before the output is written."""
    q = spec.dtype == "i8"
    xs = [_typed(_src(arena, scratch, spec.in_scratch, i), off, _elems(shp),
                 q).clone().reshape(shp)
          for i, (off, shp) in enumerate(zip(spec.in_off, spec.in_shape))]
    if q:
        in_q, (y_zp,) = spec.qmeta
        xs = [_requant(x.to(torch.int32) - zp, mult, y_zp)
              for x, (zp, mult) in zip(xs, in_q)]
    y = torch.cat(xs, dim=spec.meta[0])
    dst = scratch if spec.out_scratch else arena
    _typed(dst, spec.out_off, y.numel(), q).copy_(y.reshape(-1))


def fused_chain_plain(arena: torch.Tensor, spec: OpSpec,
                      wblob: torch.Tensor) -> None:
    """Every stage in order against the arena and a scratch buffer; stage
    filters come from the packed blob (:func:`pack_weights`)."""
    scratch = torch.zeros(spec.scratch_rows, dtype=torch.uint8,
                          device=arena.device)
    offs, _ = weight_offsets(spec)
    for st, off in zip(spec.stages, offs):
        if st.kind == "concat":
            concat_plain(arena, st, scratch)
            continue
        shape = _weight_shape(st)
        w = _typed(wblob, off, _elems(shape), st.dtype == "i8").reshape(shape)
        conv_plain(arena, st, w, scratch)


# ---------------------------------------------------------------------------
# Wrappers: checks, then the plain version on a CPU arena or the kernel on
# a CUDA arena
# ---------------------------------------------------------------------------


def _on_card(arena: torch.Tensor, spec: OpSpec, *tensors) -> bool:
    """Check the operands; True when the kernel must launch (CUDA arena),
    False for the plain version (CPU arena)."""
    _check_flat(spec)
    if arena.dtype != torch.uint8 or arena.dim() != 1 \
            or not arena.is_contiguous():
        raise ValueError("the arena must be a contiguous 1-D uint8 tensor")
    if arena.numel() >= 2 ** 31:
        raise ValueError("arena offsets are int32 in the kernels")
    for t in tensors:
        if t is not None and (t.device != arena.device
                              or not t.is_contiguous()):
            raise ValueError(f"{spec.kind}: operands must be contiguous and "
                             f"on the arena's device {arena.device}")
    if arena.device.type == "cpu":
        return False
    if arena.device.type != "cuda":
        raise ValueError(f"no arena kernels for device {arena.device}")
    return True


def _launch_args(arena: torch.Tensor, spec: OpSpec,
                 desc: Optional[torch.Tensor]):
    if desc is None:
        desc = descriptor(spec, arena.device)
    elif desc.dtype != torch.int32 or desc.device != arena.device:
        raise ValueError("descriptor must be int32 on the arena's device")
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    return desc, stream


def _staging(arena: torch.Tensor, nbytes: int):
    """(global staging tensor or None, dynamic shared bytes): shared memory
    when the staged input fits a CTA, else a wrapper-allocated buffer."""
    if nbytes <= SMEM_LIMIT:
        return None, nbytes
    return torch.empty(nbytes, dtype=torch.uint8, device=arena.device), 0


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def arena_conv(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
               desc: Optional[torch.Tensor] = None) -> None:
    """conv2d / depthwise_conv2d in place on the flat arena."""
    if spec.kind not in ("conv2d", "depthwise_conv2d"):
        raise ValueError(f"arena_conv cannot run {spec.kind!r}")
    _check_weight(spec, w)
    _conv_geometry(spec)
    if not _on_card(arena, spec, w):
        conv_plain(arena, spec, w)
        return
    from repro_torch.kernels import build
    desc, stream = _launch_args(arena, spec, desc)
    build.check(build.entry("arena_conv")(
        arena.data_ptr(), desc.data_ptr(), w.data_ptr(), stream),
        "arena_conv")
    LAUNCHES["arena_conv"] += 1


def arena_mean(arena: torch.Tensor, spec: OpSpec,
               desc: Optional[torch.Tensor] = None) -> None:
    if spec.kind != "mean":
        raise ValueError(f"arena_mean cannot run {spec.kind!r}")
    if not _on_card(arena, spec):
        mean_plain(arena, spec)
        return
    from repro_torch.kernels import build
    desc, stream = _launch_args(arena, spec, desc)
    gstage, smem = _staging(
        arena, _elems(spec.in_shape[0]) * _isz(spec.dtype))
    build.check(build.entry("arena_mean")(
        arena.data_ptr(), desc.data_ptr(), _ptr(gstage), smem, stream),
        "arena_mean")
    LAUNCHES["arena_mean"] += 1


def arena_fully_connected(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
                          desc: Optional[torch.Tensor] = None) -> None:
    if spec.kind != "fully_connected":
        raise ValueError(f"arena_fully_connected cannot run {spec.kind!r}")
    _check_weight(spec, w)
    if not _on_card(arena, spec, w):
        fully_connected_plain(arena, spec, w)
        return
    from repro_torch.kernels import build
    desc, stream = _launch_args(arena, spec, desc)
    gstage, smem = _staging(
        arena, _elems(spec.in_shape[0]) * _isz(spec.dtype))
    build.check(build.entry("arena_fully_connected")(
        arena.data_ptr(), desc.data_ptr(), w.data_ptr(), _ptr(gstage), smem,
        stream), "arena_fully_connected")
    LAUNCHES["arena_fully_connected"] += 1


def arena_softmax(arena: torch.Tensor, spec: OpSpec,
                  desc: Optional[torch.Tensor] = None) -> None:
    if spec.kind != "softmax":
        raise ValueError(f"arena_softmax cannot run {spec.kind!r}")
    if not _on_card(arena, spec):
        softmax_plain(arena, spec)
        return
    from repro_torch.kernels import build
    desc, stream = _launch_args(arena, spec, desc)
    gstage, smem = _staging(arena, 4 * _elems(spec.in_shape[0]))
    build.check(build.entry("arena_softmax")(
        arena.data_ptr(), desc.data_ptr(), _ptr(gstage), smem, stream),
        "arena_softmax")
    LAUNCHES["arena_softmax"] += 1


def _concat_bytes(spec: OpSpec) -> int:
    """Staging bytes of a fused chain's widest concat stage."""
    return max((_elems(st.out_shape) * _isz(st.dtype) for st in spec.stages
                if st.kind == "concat"), default=0)


def fused_smem_plan(spec: OpSpec) -> Tuple[bool, bool, int, int]:
    """Where a fused chain's buffers live: (scratch in shared memory?,
    concat staging in shared memory?, shared bytes of the scratch, total
    dynamic shared bytes). The scratch takes shared memory when it fits a
    CTA; the concat staging follows it there when both fit."""
    cat = _concat_bytes(spec)
    scr_smem = spec.scratch_rows <= SMEM_LIMIT
    scr_bytes = _round_up(spec.scratch_rows, 16) if scr_smem else 0
    stage_smem = scr_bytes + cat <= SMEM_LIMIT
    return scr_smem, stage_smem, scr_bytes, \
        scr_bytes + (cat if stage_smem else 0)


def arena_fused_chain(arena: torch.Tensor, spec: OpSpec, wblob: torch.Tensor,
                      desc: Optional[torch.Tensor] = None) -> None:
    """A fused band chain in one launch; ``wblob`` is
    :func:`pack_weights`' blob of the stage filters."""
    if spec.kind != "fused":
        raise ValueError(f"arena_fused_chain cannot run {spec.kind!r}")
    if wblob.dtype != torch.uint8 or \
            wblob.numel() != weight_offsets(spec)[1]:
        raise ValueError("wblob must be the chain's packed uint8 filters")
    for st in spec.stages:
        if st.kind != "concat":
            _conv_geometry(st)
    if not _on_card(arena, spec, wblob):
        fused_chain_plain(arena, spec, wblob)
        return
    from repro_torch.kernels import build
    desc, stream = _launch_args(arena, spec, desc)
    scr_smem, stage_smem, scr_bytes, smem = fused_smem_plan(spec)
    dev = arena.device
    gscratch = None if scr_smem else torch.empty(
        spec.scratch_rows, dtype=torch.uint8, device=dev)
    gstage = None if stage_smem else torch.empty(
        _concat_bytes(spec), dtype=torch.uint8, device=dev)
    build.check(build.entry("arena_fused_chain")(
        arena.data_ptr(), desc.data_ptr(), wblob.data_ptr(), _ptr(gscratch),
        _ptr(gstage), scr_bytes, smem, stream), "arena_fused_chain")
    LAUNCHES["arena_fused_chain"] += 1


def apply_op(arena: torch.Tensor, spec: OpSpec,
             w: Optional[torch.Tensor] = None,
             desc: Optional[torch.Tensor] = None) -> None:
    """Run one lowered op in place on the arena through its wrapper. ``w``
    is the filter of a weighted op, or a fused chain's packed blob."""
    k = spec.kind
    if k in ("conv2d", "depthwise_conv2d"):
        arena_conv(arena, spec, w, desc)
    elif k == "mean":
        arena_mean(arena, spec, desc)
    elif k == "fully_connected":
        arena_fully_connected(arena, spec, w, desc)
    elif k == "softmax":
        arena_softmax(arena, spec, desc)
    elif k == "fused":
        arena_fused_chain(arena, spec, w, desc)
    else:
        raise NotImplementedError(
            f"op kind {k!r} has no CUDA kernel yet (ROADMAP queue 1: pool, "
            "elementwise, matmul and pad come after the blocked addressing)")
