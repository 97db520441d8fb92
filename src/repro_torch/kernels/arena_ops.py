"""Arena kernels for Hopper: one wrapper per hand-written CUDA kernel, each
beside its plain PyTorch version, over the reference's three in-place
arena programs.

- **Flat** (``OpSpec.rowlen == 0``): the arena is ONE ``torch.uint8``
  tensor of exactly the plan's peak bytes; every operand lives at a byte
  offset (f32 operands at 4-byte-aligned offsets).
- **Row-blocked** (``rowlen > 0``): the arena is ONE contiguous typed
  ``(rows, rowlen)`` tensor (``torch.int8`` or ``torch.float32``, the
  spec's tier) laid out by ``planner.legalise_for_blocks``; offsets are
  arena rows, ``in_rows``/``out_rows`` the operands' ``(rows, used)``
  blocks, and ``in_addr``/``out_addr`` the packed addressing triples
  ``(cols_per_row, row_span, image_rowlen)`` (empty: one image row per
  arena row). In every addressing one image row is contiguous: packed
  rows sit at lane phase ``(iy % c) * rl`` of arena row ``iy // c``, a
  spanning row covers ``k`` consecutive arena rows.
- **Streaming** (``win_rows > 0`` on top of ``rowlen > 0``): the same
  typed arena, but in the reference each op copies only its live window
  (the planner's ``WindowSchedule``) into a staging buffer, runs there,
  and copies its output back. Three forms, each a kernel of its own:
  *rolling* (conv, depthwise, pool with ``win_starts``: output rows of
  streaming tile ``t`` read ``win_in`` arena rows from ``win_starts[t]``;
  the kernel reads them in place and stores straight into the arena),
  *staged* (every other kind: operand blocks packed by
  ``planner.staged_slots``; the kernel runs every staged kind in place on
  the arena instead) and *fused* (a band chain whose inputs, internals and
  output all live in the reference's ``include_io`` scratch slots; the
  kernel reads the inputs and writes the output in place on the arena).

Every lowered op (an :class:`OpSpec`) runs in place:

==============================  =============================================
wrapper                         TPU kernel it replaces
                                (src/repro/kernels/arena_ops.py)
==============================  =============================================
:func:`arena_conv`              ``_conv_kernel`` (conv2d and depthwise)
:func:`arena_pool`              ``_pool_kernel``
:func:`arena_elementwise`       ``_elementwise_kernel``
:func:`arena_matmul`            ``_matmul_kernel``
:func:`arena_pad`               ``_pad_kernel``
:func:`arena_concat`            ``_concat_kernel`` with ``_rescale``
:func:`arena_mean`              ``_mean_kernel``
:func:`arena_fully_connected`   ``_fully_connected_kernel``
:func:`arena_softmax`           ``_softmax_kernel``
:func:`arena_fused_chain`       ``_fused_kernel`` with ``_RoutedFlatMem`` /
                                ``_RoutedBlockMem`` (conv, depthwise, pool,
                                elementwise and concat stages)
:func:`arena_stream_roll`       ``_stream_roll_kernel`` with
                                ``_StreamRollMem``
:func:`arena_stream_stage`      ``_stream_stage_kernel`` with
                                ``_StreamStageMem``
:func:`arena_stream_fused`      ``_stream_fused_kernel``
==============================  =============================================

and, for the row-blocked program, the reference's memory layer
``_BlockMem`` with ``_dec_row``, ``_dec_block``, ``_enc_block`` and
``_pad_cols``/``_out_block``: in the kernels that is the addressing words
of the descriptor (``csrc/arena_common.cuh``), here :class:`_BlockMem`.

A wrapper checks device, dtype, shape and contiguity, then routes on the
arena's device alone: a CPU arena runs the plain version, a CUDA arena
launches the kernel (built from ``csrc/`` by :mod:`.build`) or raises. A
CUDA arena never takes the plain route. Each launch adds one to
:data:`LAUNCHES`.

A kernel's staged results, tile footprint and row buffers live in
dynamic shared memory when they fit one CTA and otherwise in a global
workspace allocated once per spec and cached (:func:`buffer_plan`,
:func:`workspace`); the descriptor tells the kernel where each is. The
standalone conv (:func:`arena_conv`), pool
(:func:`arena_pool`) and the rolling streaming op
(:func:`arena_stream_roll`) run row tiles over the whole card
(:func:`conv_tiling`), each tile's input footprint in its CTA's shared
memory (or a global slice per CTA), their counters at the start of the
workspace, and wait only where the operands overlap (:func:`conv_order`).
Elementwise, concat, mean and pad ops (:func:`arena_elementwise`,
:func:`arena_concat`, :func:`arena_mean`, :func:`arena_pad`, and the
staged ones of :func:`arena_stream_stage`, in place on the arena) run in
chunks of output units over the whole card (:func:`ew_tiling`,
:func:`concat_tiling`, :func:`mean_tiling`, :func:`pad_tiling`) and stage
their results before one grid-wide barrier only where the byte ranges do
not prove that no store can clobber a read (:func:`ew_order`,
:func:`concat_order`, :func:`mean_order`, :func:`pad_order`). Fully
connected ops (:func:`arena_fully_connected`, and the staged one of
:func:`arena_stream_stage`, in place on the arena) cut W into column blocks
and K slices over the whole card (:func:`fc_tiling`), sum the slices'
partials in a fixed order, and put one grid-wide barrier before any store
where the output meets x (:func:`fc_order`); a matmul
(:func:`arena_matmul`, and the staged one) runs the same grid with b in the
arena, adding row blocks where a has many rows (:func:`matmul_order`).
Softmax (:func:`arena_softmax`, and the staged one) gives a few rows a CTA
each and many rows a warp each over the whole card
(:func:`softmax_tiling`) and stages every result before one grid-wide
barrier only where an input lies in another row's output or the padding
(:func:`softmax_order`). The fused chains
(:func:`arena_fused_chain`, :func:`arena_stream_fused`) give every
chain-internal tensor a workspace region of its own and run the stages
that do not depend on each other as one level of row tiles and chunks
over the whole card, a grid-wide barrier between levels, the terminal
stage last (:func:`chain_schedule`).

The plain versions walk output rows in Python with torch ops on typed views
of the arena, in the reference's order (every read of row ``oy`` before its
store, rows ascending; whole-block ops read everything before writing), so
they are exact on in-place and diagonally overlapped layouts. The
rolling and fused streaming ones copy the window out of the arena, run the
same bodies with the operands rebased to it, and copy the output back; a
staged op runs its blocked plain version on the arena, in place as the
kernel does. They store as the reference does: a plain or spanning row store zeroes the rest of its
arena rows, a packed one writes only its lane phase, and a whole-block op
writes its whole padded ``(rows, rowlen)`` block, zeros in the padding.
The CPU tests hold them against the Pallas kernels in interpret mode, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Hashable, fully static description of one lowered op; the same
    fields in the same order as the reference's ``OpSpec``, so the two
    compare equal under :func:`dataclasses.astuple`.

    ``rowlen == 0`` selects the flat byte program: ``in_off``/``out_off``
    are byte offsets into the 1-D uint8 arena. ``rowlen > 0`` selects the
    row-blocked program over a typed ``(rows, rowlen)`` arena: offsets are
    arena rows, ``in_rows``/``out_rows`` the ``(rows, used)`` blocks and
    ``in_addr``/``out_addr`` the packed addressing triples. ``win_rows >
    0`` selects the streaming program: ``win_starts`` is the planner's
    per-output-tile fetch start table of a rolling op (empty: a staged
    whole-block op), ``win_lo`` the window's low edge (reporting only),
    and a streaming chain's ``in_slots``/``out_slot`` the scratch rows of
    its external inputs and terminal output. A fused band chain (``kind ==
    "fused"``) carries its member ops as ``stages``; stage operands whose
    ``in_scratch``/``out_scratch`` flag is set address the chain's scratch
    buffer of ``scratch_rows`` bytes (flat) or rows (blocked)."""

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
    scratch_rows: int = 0              # chain scratch: bytes (flat) | rows
    in_scratch: Tuple[int, ...] = ()
    out_scratch: int = 0
    in_slots: Tuple[int, ...] = ()
    out_slot: int = 0

    def __hash__(self) -> int:
        """The fields' hash, computed once: the wrappers look a spec up in
        several caches per launch, and a chain's nested stages make the
        field tuple long. Equality stays the fields'."""
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash(tuple(getattr(self, f.name)
                           for f in dataclasses.fields(self)))
            object.__setattr__(self, "_hash", h)
        return h

    def __getstate__(self):
        # a string's hash differs between processes: never pickle it
        return {k: v for k, v in self.__dict__.items() if k != "_hash"}


#: Op kinds that carry one weight operand.
WEIGHTED_KINDS = frozenset({"conv2d", "depthwise_conv2d", "fully_connected"})
#: Op kinds that map output rows to input rows (row tiles standalone and
#: rolling, a row buffer each as fused stages).
ROW_KINDS = frozenset({"conv2d", "depthwise_conv2d", "pool"})
#: Stage kinds the fused kernel runs (the planner's FUSABLE_KINDS).
FUSED_STAGE_KINDS = frozenset(ROW_KINDS | {"elementwise", "concat"})

#: The kernel that runs each lowered op kind outside the streaming program.
KERNEL_OF = {
    "conv2d": "arena_conv", "depthwise_conv2d": "arena_conv",
    "pool": "arena_pool", "elementwise": "arena_elementwise",
    "matmul": "arena_matmul", "pad": "arena_pad", "concat": "arena_concat",
    "mean": "arena_mean", "fully_connected": "arena_fully_connected",
    "softmax": "arena_softmax", "fused": "arena_fused_chain",
}
#: The kernel that runs each form of the streaming program
#: (:func:`stream_form`); :func:`kernel_of` consults it first.
STREAM_KERNEL_OF = {"roll": "arena_stream_roll",
                    "stage": "arena_stream_stage",
                    "fused": "arena_stream_fused"}

#: Launches per kernel since :func:`reset_launches`; each wrapper adds one
#: where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {name: 0 for name in dict.fromkeys(
    [*KERNEL_OF.values(), *STREAM_KERNEL_OF.values()])}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_form(spec: "OpSpec") -> Optional[str]:
    """The streaming form of a spec: ``"roll"`` (a fetch-start table),
    ``"fused"`` (a band chain), ``"stage"`` (any other kind), or None
    outside the streaming program."""
    if not spec.win_rows:
        return None
    if spec.win_starts:
        return "roll"
    return "fused" if spec.kind == "fused" else "stage"


def kernel_of(spec: "OpSpec") -> Optional[str]:
    """The kernel that runs a lowered spec (None for an unknown kind)."""
    form = stream_form(spec)
    return STREAM_KERNEL_OF[form] if form else KERNEL_OF.get(spec.kind)


def _elems(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _isz(dtype: str) -> int:
    return 1 if dtype == "i8" else 4


#: The row-blocked arena's element type per tier.
_TORCH_DTYPE = {"i8": torch.int8, "f32": torch.float32}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Descriptors: the int32 words the CUDA kernels read (csrc/arena_common.cuh
# holds the same word offsets)
# ---------------------------------------------------------------------------

DESC_WORDS = 256
MAX_CAT = 16
MAX_DIMS = 6
#: Dynamic shared memory one CTA can use on Hopper (227 KB).
SMEM_LIMIT = 232_448

(K_CONV2D, K_DEPTHWISE, K_CONCAT, K_MEAN, K_FC, K_SOFTMAX, K_POOL,
 K_ELEMENTWISE, K_MATMUL, K_PAD) = range(10)
_KIND_CODE = {"conv2d": K_CONV2D, "depthwise_conv2d": K_DEPTHWISE,
              "concat": K_CONCAT, "mean": K_MEAN, "fully_connected": K_FC,
              "softmax": K_SOFTMAX, "pool": K_POOL,
              "elementwise": K_ELEMENTWISE, "matmul": K_MATMUL, "pad": K_PAD}
#: Elementwise function codes; codes >= EW_ADD are binary.
EW_CODE = {"relu": 0, "relu6": 1, "sigmoid": 2, "identity": 3, "add": 4,
           "mul": 5, "sub": 6}
EW_ADD = EW_CODE["add"]
(D_KIND, D_QUANT, D_WOFF, D_IN_OFF, D_OUT_OFF, D_IN_SCR, D_OUT_SCR, D_X_ZP,
 D_Y_ZP, D_AMULT) = range(10)
(D_IH, D_IW, D_IC, D_OH, D_OW, D_OC, D_KH, D_KW, D_SH, D_SW, D_DH, D_DW,
 D_PH, D_PW, D_MULT) = range(10, 25)
D_DIM0, D_RMASK, D_CNT, D_OUTN = 10, 14, 15, 16
D_M, D_IDIM, D_ODIM = 10, 11, 12
D_ROWS, D_LAST, D_XSCALE, D_YSCALE = 10, 11, 12, 13
D_NIN, D_OUTER, D_INNER_OUT = 10, 11, 12
D_CIN_OFF, D_CIN_SCR, D_CINNER, D_CZP, D_CMULT = 16, 32, 48, 64, 80
(D_FN, D_EN, D_BCAST, D_IN2_OFF, D_IN2_SCR, D_ASCALE, D_BZP, D_BSCALE,
 D_OSCALE) = range(10, 19)
D_EDIM0, D_BSTR0 = 20, 26
D_MM, D_MK, D_MN = 10, 11, 12
D_PIN0, D_PLO0, D_POUT0, D_PN = 10, 14, 18, 22
#: A grid kernel's order word (a tile kernel's :func:`conv_order`, a chunk
#: walk's :func:`ew_order`, :func:`concat_order`, :func:`mean_order` or
#: :func:`pad_order`, a
#: product's :func:`fc_order` or :func:`matmul_order`, a softmax's
#: :func:`softmax_order`), then its tiling's fields in order
#: (:func:`conv_tiling`, :func:`chunk_of`, :func:`fc_tiling`,
#: :func:`softmax_tiling`).
D_ORDER = 100
D_TILING = 101
#: Buffer placement words (flag: 1 = global workspace, then byte offset);
#: a tile kernel's footprint, a chunk walk's staging, a product's partials
#: and a softmax's order-2 results take the "stage" words, a tile kernel's
#: filter chunks, a product CTA's warp sums and a softmax's staged row the
#: "row" words; a fused
#: chain's header carries its footprint ("tile"), filter chunks ("wts")
#: and staged terminal chunks ("term").
BUFFER_WORD = {"stage": 120, "row": 122, "tile": 120, "wts": 122,
               "chunk": 120, "part": 120, "red": 122, "term": 124,
               "results": 120, "rowbuf": 122}
#: Operand addressing: slot 0 is the output, slot 1 + i input i, each
#: ADDR_WORDS words (L, c, k, rl, used, nblk) from D_ADDR on.
D_ADDR, ADDR_WORDS = 128, 6
#: A streaming descriptor's stream block (the S_* words of
#: csrc/arena_common.cuh), then the body's descriptor at word S_BODY: the
#: body's word offset, the rolling statics (the input's arena row, window
#: rows, image rows of a streaming tile, tiles, output rows), and from
#: S_COPY0 a rolling op's S_T fetch starts.
S_BODY, S_IN_ROW, S_WIN_IN, S_TR, S_T, S_OH = range(6)
S_COPY0 = 8
#: Shared memory a streaming launch leaves to static shared arrays (a
#: softmax CTA row's reduction, a product CTA's last-slice flag).
STREAM_STATIC_SMEM = 1024


def _fbits(x: float) -> int:
    """The int32 word holding float32 ``x``'s bits."""
    return struct.unpack("<i", struct.pack("<f", float(np.float32(x))))[0]


def _sub(dtype: str) -> int:
    """Sublane tile rows of the arena tier (the planner's TPU tiles)."""
    return 32 if dtype == "i8" else 8


def _tile_geom(spec: OpSpec) -> Tuple[int, int]:
    """(image rows, sublane-rounded arena rows) of one rolling output tile,
    as the reference's ``_tile_geom`` and ``planner.tile_rows``/
    ``tile_arena_rows`` give them (``out_tile`` 0: one sublane tile)."""
    sub = _sub(spec.dtype)
    tr = spec.out_tile or sub
    c, k, _ = _triple(spec, None)
    ar = (tr - 1) // c + 1 if c > 1 else tr * k
    return tr, _round_up(ar, sub)


def _tile_rows(spec: OpSpec, y0: int, y1: int) -> Tuple[int, int]:
    """Output arena rows ``[a0, a1)`` (operand-relative) that image rows
    ``[y0, y1)`` occupy."""
    c, k, _ = _triple(spec, None)
    if c > 1:
        return y0 // c, (y1 - 1) // c + 1
    return y0 * k, y1 * k


def _blocked(spec: OpSpec) -> OpSpec:
    """The spec with its window fields cleared: the row-blocked op."""
    return dataclasses.replace(spec, win_lo=0, win_rows=0, win_starts=(),
                               in_slots=(), out_slot=0)


def _stream_body(spec: OpSpec) -> OpSpec:
    """The spec a streaming kernel's body runs (the plain versions' too):
    the window fields cleared (a rolling or staged op: its arena offsets);
    a streaming chain's scratch grown to its window (all its operands live
    there)."""
    body = _blocked(spec)
    if stream_form(spec) == "fused":
        body = dataclasses.replace(
            body, scratch_rows=max(spec.scratch_rows, spec.win_rows))
    return body


def _check_stream(spec: OpSpec, rows: int) -> None:
    """Raise ValueError on a streaming spec its kernel cannot run over an
    arena of ``rows`` rows: not row-blocked, a rolling op that is not a
    one-input row kind, a fetch-start table of the wrong length or
    fetching past the arena, a staged row kind, too many copies."""
    form = stream_form(spec)
    if not spec.rowlen:
        raise ValueError("the streaming program runs row-blocked specs "
                         "(rowlen > 0)")
    if form == "roll":
        if spec.kind not in ROW_KINDS or len(spec.in_off) != 1:
            raise ValueError(f"{spec.kind}: a rolling window needs a "
                             "one-input conv, depthwise or pool")
        tr, tile_ar = _tile_geom(spec)
        win_in = spec.win_rows - tile_ar
        oh = spec.out_shape[-3]
        if win_in <= 0 or len(spec.win_starts) != -(-oh // tr):
            raise ValueError(
                f"{spec.kind}: {len(spec.win_starts)} fetch starts and a "
                f"{win_in}-row window for {oh} output rows in tiles of {tr}")
        if not all(0 <= s <= rows - win_in for s in spec.win_starts):
            raise ValueError(f"{spec.kind}: a fetch of {win_in} rows from "
                             f"{spec.win_starts} leaves the {rows}-row "
                             "arena")
        return
    if form == "stage" and spec.kind in ROW_KINDS:
        raise ValueError(f"{spec.kind}: a row kind streams through a "
                         "rolling window (win_starts)")
    if form == "fused" and len(spec.in_slots) != len(spec.in_off):
        raise ValueError("a streaming chain needs one slot per input")


def _triple(spec: OpSpec, i: Optional[int]) -> Tuple[int, int, int]:
    """Packed addressing triple ``(c, k, rl)`` of input ``i`` (None: the
    output); ``(1, 1, 0)`` is one image row per arena row."""
    if i is None:
        return spec.out_addr or (1, 1, 0)
    return spec.in_addr[i] if spec.in_addr else (1, 1, 0)


def operand_addr(spec: OpSpec, i: Optional[int]) -> Tuple[int, ...]:
    """``(byte offset, L, c, k, rl, used, nblk)`` of input ``i`` (None: the
    output), the words the kernels address it by: image row ``iy`` starts
    at element ``(iy // c) * L + (iy % c) * rl`` (packed, ``c > 1``) or
    ``iy * k * L``; tensor element ``e`` sits at element ``(e // rl) * k *
    L + e % rl`` (``k > 1``) or ``(e // used) * L + e % used``; a
    whole-block write covers ``nblk`` elements. The flat program is the
    degenerate case ``c = k = 1``, ``L = used`` = one image row, ``nblk``
    the tensor's elements."""
    shape = spec.out_shape if i is None else spec.in_shape[i]
    off = spec.out_off if i is None else spec.in_off[i]
    if not spec.rowlen:
        row = max(1, _elems(shape[-2:]))
        return off, row, 1, 1, 0, row, _elems(shape)
    rows, used = spec.out_rows if i is None else spec.in_rows[i]
    L = spec.rowlen
    return (off * L * _isz(spec.dtype), L, *_triple(spec, i), used,
            rows * L)


def _row_geometry(spec: OpSpec) -> Tuple[int, ...]:
    """(ih, iw, ic, oh, ow, oc) of a conv2d, depthwise or pool spec. Any
    row width runs: the row walks stage one output row in a row buffer,
    the standalone conv cuts a row into column tiles."""
    ih, iw, ic = spec.in_shape[0][-3:]
    oh, ow, oc = spec.out_shape[-3:]
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


def _ew_broadcast(spec: OpSpec) -> Tuple[bool, Tuple[int, ...],
                                         Tuple[int, ...]]:
    """(broadcast?, the first operand's dims, the second operand's strides
    over them), both padded to MAX_DIMS. The second operand is broadcast
    (numpy rules) when its element count differs, as the reference does;
    raises ValueError where it does not broadcast."""
    fn = spec.meta[0]
    if fn not in EW_CODE:
        raise ValueError(f"unknown elementwise fn {fn!r}")
    n_in = 2 if EW_CODE[fn] >= EW_ADD else 1
    a = tuple(spec.in_shape[0])
    if len(spec.in_shape) != n_in or _elems(a) != _elems(spec.out_shape) \
            or len(a) > MAX_DIMS:
        raise ValueError(f"elementwise {fn}: operands {spec.in_shape} -> "
                         f"{spec.out_shape}")
    dims = (1,) * (MAX_DIMS - len(a)) + a
    if n_in == 1 or _elems(spec.in_shape[1]) == _elems(a):
        return False, dims, (0,) * MAX_DIMS
    b = tuple(spec.in_shape[1])
    if len(b) > len(a) or any(bd not in (1, ad) for bd, ad in
                              zip(b[::-1], a[::-1])):
        raise ValueError(f"elementwise {fn}: operand {b} does not broadcast "
                         f"to {a}")
    b = (1,) * (MAX_DIMS - len(b)) + b
    strides, s = [], 1
    for bd in reversed(b):
        strides.append(0 if bd == 1 else s)
        s *= bd
    return True, dims, tuple(reversed(strides))


def _matmul_geometry(spec: OpSpec) -> Tuple[int, int, int]:
    k = spec.in_shape[0][-1]
    m = _elems(spec.in_shape[0]) // k
    b = tuple(spec.in_shape[1])
    if len(b) != 2 or b[0] != k or _elems(spec.out_shape) != m * b[1]:
        raise ValueError(f"matmul: {spec.in_shape} -> {spec.out_shape}")
    return m, k, b[1]


def _pad_geometry(spec: OpSpec) -> Tuple[Tuple[int, ...], ...]:
    """(input dims, leading pads, output dims), each padded to 4."""
    shape = tuple(spec.in_shape[0])
    pads = spec.meta[0]
    if len(shape) > 4 or len(pads) != len(shape) or \
            tuple(spec.out_shape) != tuple(
                n + lo + hi for n, (lo, hi) in zip(shape, pads)) or \
            min((p for lh in pads for p in lh), default=0) < 0:
        raise ValueError(f"pad {pads}: {shape} -> {spec.out_shape}")
    lead = 4 - len(shape)
    return ((1,) * lead + shape, (0,) * lead + tuple(lo for lo, _ in pads),
            (1,) * lead + tuple(spec.out_shape))


def _mean_geometry(spec: OpSpec) -> Tuple[Tuple[int, ...], int, int, int]:
    """(input dims padded to 4 with leading 1s, reduced-axis mask: bit i =
    axis i of those dims, elements a reduction sums, outputs) of a mean."""
    shape = tuple(spec.in_shape[0])
    if len(shape) > 4:
        raise ValueError(f"mean over a {len(shape)}-d input")
    axes = {a % len(shape) for a in spec.meta[0]}
    pad = 4 - len(shape)
    return ((1,) * pad + shape, sum(1 << (a + pad) for a in axes),
            _elems(shape[a] for a in axes),
            _elems(s for i, s in enumerate(shape) if i not in axes))


def _op_words(spec: OpSpec, woff: int = 0) -> List[int]:
    """One op's DESC_WORDS descriptor words (buffer words excluded)."""
    w = [0] * DESC_WORDS
    q = spec.dtype == "i8"
    k = spec.kind
    if k not in _KIND_CODE:
        raise NotImplementedError(f"op kind {k!r} has no CUDA kernel")
    w[D_KIND] = _KIND_CODE[k]
    w[D_QUANT] = int(q)
    w[D_WOFF] = woff
    addrs = [operand_addr(spec, None)] + [
        operand_addr(spec, i) for i in range(len(spec.in_shape))]
    if len(addrs) > MAX_CAT + 1:
        raise ValueError(f"{k} of {len(addrs) - 1} inputs exceeds {MAX_CAT}")
    for slot, a in enumerate(addrs):
        w[D_ADDR + ADDR_WORDS * slot:D_ADDR + ADDR_WORDS * (slot + 1)] = a[1:]
    w[D_IN_OFF] = addrs[1][0]
    w[D_OUT_OFF] = addrs[0][0]
    w[D_IN_SCR] = spec.in_scratch[0] if spec.in_scratch else 0
    w[D_OUT_SCR] = spec.out_scratch
    if k in ("conv2d", "depthwise_conv2d", "pool", "fully_connected",
             "mean") and q:
        x_zp, amult, y_zp = spec.qmeta
        w[D_X_ZP], w[D_AMULT], w[D_Y_ZP] = x_zp, _fbits(amult), y_zp
    if k in ("conv2d", "depthwise_conv2d"):
        w[D_IH:D_OC + 1] = _row_geometry(spec)
        w[D_KH:D_MULT + 1] = spec.meta
    elif k == "pool":
        kh, kw, sh, sw, ph, pw, mode = spec.meta
        w[D_IH:D_OC + 1] = _row_geometry(spec)
        w[D_KH:D_MULT + 1] = (kh, kw, sh, sw, 1, 1, ph, pw,
                              int(mode == "max"))
    elif k == "mean":
        dims, rmask, cnt, outn = _mean_geometry(spec)
        w[D_DIM0:D_DIM0 + 4] = dims
        w[D_RMASK], w[D_CNT], w[D_OUTN] = rmask, cnt, outn
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
    elif k == "elementwise":
        bcast, dims, strides = _ew_broadcast(spec)
        w[D_FN], w[D_EN], w[D_BCAST] = EW_CODE[spec.meta[0]], _elems(dims), \
            int(bcast)
        if len(spec.in_off) == 2:
            w[D_IN2_OFF] = addrs[2][0]
            w[D_IN2_SCR] = spec.in_scratch[1] if spec.in_scratch else 0
        w[D_EDIM0:D_EDIM0 + MAX_DIMS] = dims
        w[D_BSTR0:D_BSTR0 + MAX_DIMS] = strides
        if q:
            in_q, (ys, yzp) = spec.qmeta
            w[D_ASCALE], w[D_X_ZP] = _fbits(in_q[0][0]), in_q[0][1]
            if len(in_q) == 2:
                w[D_BSCALE], w[D_BZP] = _fbits(in_q[1][0]), in_q[1][1]
            w[D_OSCALE], w[D_Y_ZP] = _fbits(ys), yzp
    elif k == "matmul":
        w[D_MM], w[D_MK], w[D_MN] = _matmul_geometry(spec)
        w[D_IN2_OFF] = addrs[2][0]
        if q:
            a_zp, b_zp, amult, y_zp = spec.qmeta
            w[D_X_ZP], w[D_BZP], w[D_AMULT], w[D_Y_ZP] = \
                a_zp, b_zp, _fbits(amult), y_zp
    elif k == "pad":
        ind, lo, outd = _pad_geometry(spec)
        w[D_PIN0:D_PIN0 + 4], w[D_PLO0:D_PLO0 + 4] = ind, lo
        w[D_POUT0:D_POUT0 + 4], w[D_PN] = outd, _elems(outd)
        if q:
            (x_zp, mult), (y_zp,) = spec.qmeta
            w[D_X_ZP], w[D_AMULT], w[D_Y_ZP] = x_zp, _fbits(mult), y_zp
    else:  # concat
        n = len(spec.in_shape)
        nd = len(spec.out_shape)
        axis = spec.meta[0] % nd
        w[D_NIN] = n
        w[D_OUTER] = _elems(spec.out_shape[:axis])
        w[D_INNER_OUT] = _elems(spec.out_shape[axis:])
        in_q = spec.qmeta[0] if q else ((0, 1.0),) * n
        if q:
            w[D_Y_ZP] = spec.qmeta[1][0]
        for i in range(n):
            w[D_CIN_OFF + i] = addrs[1 + i][0]
            w[D_CIN_SCR + i] = spec.in_scratch[i] if spec.in_scratch else 0
            w[D_CINNER + i] = _elems(spec.in_shape[i][axis:])
            w[D_CZP + i] = in_q[i][0]
            w[D_CMULT + i] = _fbits(in_q[i][1])
    return w


# ---------------------------------------------------------------------------
# The tile kernels over the whole card (csrc/conv_tiles.cuh: arena_conv,
# arena_pool, and arena_stream_roll through its window): output row tiles,
# their input footprints and the order the arena's overlap needs. The
# kernels read the same numbers from the descriptor.
# ---------------------------------------------------------------------------

#: The kernels that run row tiles over the whole card.
TILE_KERNELS = ("arena_conv", "arena_pool", "arena_stream_roll")
#: Threads of one tile CTA.
CONV_THREADS = 256
#: Shared memory a conv tile's input footprint may take; a larger one is
#: staged in a per-CTA slice of the global workspace.
CONV_SMEM_BUDGET = 192 * 1024
#: Shared bytes one filter chunk of a conv2d tile may take (two are in
#: flight).
CONV_WCHUNK_BYTES = 16 * 1024
#: CTAs a globally staged conv launches at most (one slice each).
CONV_SLICES = 132
#: SMs of the card and conv CTAs an SM holds at most (256 threads at 128
#: registers), and the shared memory of one SM (228 KB), for the tiling's
#: cost model.
CONV_SMS, CONV_CTAS_PER_SM = 132, 2
SM_SMEM = 233_472
#: Bytes of the conv's counters at the start of its workspace before its
#: per-row ones: the next ticket, tiles stored (two words of padding).
CONV_COUNTER_BYTES = 16
#: Order modes: no read meets a store; they meet, and no row's store meets
#: a later row's reads (a tile stores once every tile of its row and the
#: rows before has staged its input: a count of staged tiles per row); a
#: later row reads an earlier row's store (groups of rows run one after
#: another: a tile reads only after every row of the groups before is
#: stored, and stores once every tile of its group has staged; a group is
#: one row of a standalone conv, one streaming tile of a rolling op).
ORDER_DISJOINT, ORDER_STAGED, ORDER_ROWS = range(3)


class ConvTiling(NamedTuple):
    """A tile kernel's tiles (a standalone conv or pool, or a rolling conv,
    depthwise or pool). A tile is (output row, ``tc`` output
    columns, ``to`` output channels); thread ``i`` of the CTA takes output
    channels ``og*vo .. og*vo+vo-1`` (``og = i % nog``) of pixels ``slot +
    p*(CONV_THREADS // nog)``, ``p < vp`` (``slot = i // nog``). Its input
    footprint (``fp`` bytes, 16-aligned) is ``kh`` rows of ``fw`` columns
    (those ``min(tc, ow)`` output columns reach) of ``ib`` channels (every
    input channel of a conv2d; a depthwise or pool tile's block), a
    column every ``ps`` elements (padded so that the columns a warp reads
    at once sit in different shared-memory banks). Tickets run row-major:
    ``tpr = ncb * nob`` tiles a row, column block major. A conv2d with ``vo == 4`` stages its
    filter's ``to`` columns in shared memory ``ch`` input channels at a
    time, two chunks in flight (``ch == 0``: filter loads from global
    memory)."""
    vp: int
    vo: int
    nog: int
    tc: int
    to: int
    ib: int
    fw: int
    ncb: int
    nob: int
    tpr: int
    ntiles: int
    fp: int
    ch: int
    ps: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _conv_meta(spec: OpSpec) -> Tuple[int, ...]:
    """``(kh, kw, sh, sw, dh, dw, ph, pw, m)`` of a conv2d, depthwise or
    pool spec (a pool: no dilation, one output channel an input
    channel)."""
    if spec.kind == "pool":
        kh, kw, sh, sw, ph, pw, _ = spec.meta
        return kh, kw, sh, sw, 1, 1, ph, pw, 1
    return tuple(spec.meta)


def _resident(spec: OpSpec, t: ConvTiling) -> int:
    """Conv CTAs of tiling ``t`` the card holds at once, by registers and
    shared memory."""
    smem = (t.fp if t.fp <= CONV_SMEM_BUDGET else 0) + \
        2 * t.ch * t.to * _isz(spec.dtype) + 1024
    return CONV_SMS * max(1, min(CONV_CTAS_PER_SM, SM_SMEM // smem))


def _column_stride(ib: int, isz: int) -> int:
    """Elements from one footprint column to the next: ``ib`` rounded up
    to 16 bytes, plus 16 where that is a multiple of 32 bytes, so eight
    consecutive columns start in eight different 4-byte banks groups."""
    words = _round_up(-(-ib * isz // 4), 4)
    if words % 8 == 0:
        words += 4
    return words * 4 // isz


def _tile_cycles(spec: OpSpec, t: ConvTiling) -> float:
    """Rough cycles of one tile, to rank tilings (not a prediction): the
    footprint's copy, then per step of a staged filter (a tap's chunk of
    ``ch`` input channels) a barrier pair and the larger of the chunk's
    copy and its ``ch`` iterations; without staging, every tap and input
    channel's global filter load. An iteration costs more with more pixels
    a thread."""
    ic = spec.in_shape[0][-1]
    taps = spec.meta[0] * spec.meta[1]
    isz = _isz(spec.dtype)
    cycles = 600 + t.fp / 32
    if t.ch:
        load = 600 + t.ch * t.to * isz / 32
        work = t.ch * (8 + 4 * t.vp)
        cycles += taps * -(-ic // t.ch) * (200 + max(load, work))
    else:
        reach = ic if spec.kind == "conv2d" else 1
        cycles += taps * reach * (30 + 4 * t.vp)
    return cycles


@functools.lru_cache(maxsize=1024)
def conv_tiling(spec: OpSpec) -> ConvTiling:
    """The tiling of a conv2d, depthwise or pool spec, standalone or
    rolling (a pool tiles as a depthwise with ``m = 1``, no filter): four
    output channels a thread where the filter's rows allow (conv2d with
    ``oc % 4 == 0``), then the threads across the
    channels (a power of two up to 64) and the pixels a thread (4, 2 or
    1) whose footprint fits
    :data:`CONV_SMEM_BUDGET` and whose waves of resident tiles
    (:func:`_resident`) cost least by :func:`_tile_cycles` (ties: more
    pixels a thread, then more threads across the channels). Where no
    footprint fits, more threads go across the channels (fewer columns a
    tile, down to one), and the smallest footprint is staged in global
    memory."""
    ih, iw, ic, oh, ow, oc = _row_geometry(spec)
    kh, kw, sh, sw, dh, dw, ph, pw, m = _conv_meta(spec)
    dwk = spec.kind != "conv2d"
    vo = 1 if dwk or oc % 4 else 4
    nog0 = min(_pow2_at_least(-(-oc // vo)), 64)
    shapes = [(nog, vp) for nog in (64, 32, 16, 8, 4) if nog <= nog0
              for vp in (4, 2, 1)] or [(nog0, vp) for vp in (4, 2, 1)]
    shapes += [(n, 1) for n in (128, 256) if n > nog0]
    options = []
    for nog, vp in shapes:
        to = nog * vo
        if dwk and to % m and -(-oc // to) > 1:
            continue        # a channel block would split a multiplier
        tc = CONV_THREADS // nog * vp
        ib = min(ic, (to - 1) // m + 1) if dwk else ic
        fw = (min(tc, ow) - 1) * sw + (kw - 1) * dw + 1
        ncb, nob = -(-ow // tc), -(-oc // to)
        ps = _column_stride(ib, _isz(spec.dtype))
        fp = _round_up(kh * fw * ps * _isz(spec.dtype), 16)
        ch = 0 if vo == 1 else max(1, min(
            ic, CONV_WCHUNK_BYTES // (to * _isz(spec.dtype))))
        options.append(ConvTiling(vp, vo, nog, tc, to, ib, fw, ncb, nob,
                                  ncb * nob, oh * ncb * nob, fp, ch, ps))
    base = [t for t in options if t.nog <= nog0
            and t.fp <= CONV_SMEM_BUDGET]
    if base:
        return min(base, key=lambda t: (
            -(-t.ntiles // _resident(spec, t)) * _tile_cycles(spec, t),
            -t.vp, -t.nog))
    for t in options:
        if t.nog > nog0 and t.fp <= CONV_SMEM_BUDGET:
            return t
    return min(options, key=lambda t: t.fp)


def conv_counter_bytes(spec: OpSpec) -> int:
    """Bytes of a tile kernel's counters: :data:`CONV_COUNTER_BYTES`,
    then one int32 of staged tiles per output row, 16-aligned."""
    return _round_up(CONV_COUNTER_BYTES + 4 * spec.out_shape[-3], 16)


def _byte_range(spec: OpSpec, i: Optional[int]) -> Tuple[int, int]:
    """Arena bytes ``[lo, hi)`` of input ``i`` (None: the output): flat, its
    tensor's bytes; row-blocked, its whole block of arena rows."""
    off, L, _, _, _, _, nblk = operand_addr(spec, i)
    return off, off + nblk * _isz(spec.dtype)


def _row_start(addr: Tuple[int, ...], iy: int) -> int:
    """Element offset of image row ``iy`` (``row_elem`` of the kernels)."""
    _, L, c, k, rl, _, _ = addr
    return (iy // c) * L + (iy % c) * rl if c > 1 else iy * k * L


def _read_row(spec: OpSpec, r: int, iy: int) -> int:
    """Element offset, from input 0's first element, of input image row
    ``iy`` as output row ``r`` reads it: ``row_elem`` of the kernels, or for
    a rolling spec its arena row rebased on the fetch start of ``r``'s
    streaming tile and clamped into that window (``WinRows`` of
    csrc/arena_stream_roll.cu, ``_WindowMem.read_row`` here)."""
    a = operand_addr(spec, 0)
    if stream_form(spec) != "roll":
        return _row_start(a, iy)
    _, L, c, k, rl, _, _ = a
    tr, tile_ar = _tile_geom(spec)
    base = spec.win_starts[r // tr] - spec.in_off[0]
    n = 1 if c > 1 else k
    w = (iy // c if c > 1 else iy * k) - base
    w = min(max(w, 0), spec.win_rows - tile_ar - n)
    return (base + w) * L + ((iy % c) * rl if c > 1 else 0)


def conv_row_reads(spec: OpSpec, r: int,
                   cols: Tuple[int, int] = None) -> List[Tuple[int, int]]:
    """Arena byte intervals output row ``r`` reads: per valid tap row (a
    rolling spec's through its window, :func:`_read_row`), the input
    columns its output columns ``cols`` (default all) reach, every
    channel."""
    ih, iw, ic, oh, ow, oc = _row_geometry(spec)
    kh, kw, sh, sw, dh, dw, ph, pw, _ = _conv_meta(spec)
    x0, x1 = cols or (0, ow)
    lo_ix = max(0, x0 * sw - pw)
    hi_ix = min(iw, (x1 - 1) * sw - pw + (kw - 1) * dw + 1)
    if hi_ix <= lo_ix:
        return []
    a = operand_addr(spec, 0)
    isz = _isz(spec.dtype)
    out = []
    for fy in range(kh):
        iy = r * sh - ph + fy * dh
        if 0 <= iy < ih:
            e = _read_row(spec, r, iy)
            out.append((a[0] + (e + lo_ix * ic) * isz,
                        a[0] + (e + hi_ix * ic) * isz))
    return out


def conv_row_store(spec: OpSpec, r: int,
                   cols: Tuple[int, int] = None) -> Tuple[int, int]:
    """Arena byte interval output row ``r``'s store covers (columns
    ``cols``, default the whole row with, plain or spanning, the zeroed
    rest of its ``k * L`` elements)."""
    _, _, _, _, ow, oc = _row_geometry(spec)
    a = operand_addr(spec, None)
    isz = _isz(spec.dtype)
    e = _row_start(a, r)
    if cols is not None:
        return (a[0] + (e + cols[0] * oc) * isz,
                a[0] + (e + cols[1] * oc) * isz)
    span = ow * oc if a[2] > 1 else a[3] * a[1]
    return a[0] + e * isz, a[0] + (e + span) * isz


def _meets(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


@functools.lru_cache(maxsize=1024)
def conv_order(spec: OpSpec) -> int:
    """The order mode of a tile kernel's spec (:data:`ORDER_DISJOINT`,
    :data:`ORDER_STAGED` or :data:`ORDER_ROWS`) from the byte ranges of
    input 0 and of the output, then from each row's store against every
    later row's reads. A rolling spec's reads are the window-clamped rows
    its tiles really read, which may leave the input's block: it is
    disjoint when none of them meets the output's block."""
    oh = spec.out_shape[-3]
    if stream_form(spec) == "roll":
        out = _byte_range(spec, None)
        if not any(_meets(iv, out) for r in range(oh)
                   for iv in conv_row_reads(spec, r)):
            return ORDER_DISJOINT
    elif not _meets(_byte_range(spec, 0), _byte_range(spec, None)):
        return ORDER_DISJOINT
    stores = [conv_row_store(spec, r) for r in range(oh)]
    ends = np.maximum.accumulate([hi for _, hi in stores])
    starts = [lo for lo, _ in stores]
    for r in range(1, oh):
        for lo, hi in conv_row_reads(spec, r):
            # stores of rows < r that start below hi; the one of them
            # reaching furthest up decides
            n = min(r, int(np.searchsorted(starts[:r], hi)))
            if n and ends[n - 1] > lo and any(
                    _meets(stores[j], (lo, hi)) for j in range(n)):
                return ORDER_ROWS
    return ORDER_STAGED


def conv_tile_geometry(spec: OpSpec, t: int) -> Tuple[int, Tuple[int, int],
                                                      Tuple[int, int]]:
    """(output row, output columns ``[x0, x1)``, output channels ``[o0,
    o1)``) of ticket ``t``."""
    _, _, _, _, ow, oc = _row_geometry(spec)
    tl = conv_tiling(spec)
    r, rem = divmod(t, tl.tpr)
    cb, ob = divmod(rem, tl.nob)
    x0, o0 = cb * tl.tc, ob * tl.to
    return r, (x0, min(ow, x0 + tl.tc)), (o0, min(oc, o0 + tl.to))


def tile_reads(spec: OpSpec, t: int) -> List[Tuple[int, int, int]]:
    """What ticket ``t``'s footprint copy reads, per valid tap row: the
    arena byte interval ``[lo, hi)`` from its first to its last byte, and
    the bytes it copies (the columns the tile reaches, each the tile's
    channels: every channel of a conv2d, a depthwise or pool tile's
    block). Rows as the kernels find them (:func:`_read_row`)."""
    ih, iw, ic, _, _, _ = _row_geometry(spec)
    kh, _, sh, sw, dh, _, ph, pw, m = _conv_meta(spec)
    tl = conv_tiling(spec)
    r, (x0, _), (o0, _) = conv_tile_geometry(spec, t)
    c_lo = 0 if spec.kind == "conv2d" else o0 // m
    ixs, ixe = max(x0 * sw - pw, 0), min(x0 * sw - pw + tl.fw, iw)
    chans = min(tl.ib, ic - c_lo)
    base, isz = operand_addr(spec, 0)[0], _isz(spec.dtype)
    out = []
    for fy in range(kh):
        iy = r * sh - ph + fy * dh
        if 0 <= iy < ih and ixs < ixe:
            lo = base + (_read_row(spec, r, iy) + ixs * ic + c_lo) * isz
            out.append((lo, lo + ((ixe - ixs - 1) * ic + chans) * isz,
                        (ixe - ixs) * chans * isz))
    return out


# ---------------------------------------------------------------------------
# The chunk walk (csrc/ew_tiles.cuh: arena_elementwise, arena_concat,
# arena_mean, arena_pad, and arena_stream_stage's elementwise, concat, mean
# and pad bodies in place on the arena): output units in contiguous
# chunks, one chunk a CTA at a time, and the order word that keeps
# read-all-before-write-all.
# The kernels read the same numbers from the descriptor.
# ---------------------------------------------------------------------------

#: Threads of a chunk-walk CTA (arena_common.cuh's NT).
EW_THREADS = 512
#: Order words of a chunk walk: no input byte meets an output byte; for an
#: elementwise op, the output meets only inputs that map each element
#: where it does (element i of the output is exactly element i of each: a
#: thread stores only what it has just read itself), for a mean, every
#: output element's bytes hold only inputs of its own reduction (one thread
#: reads them all, then stores it); anything else (every chunk stages its
#: results, one grid-wide barrier, then every chunk stores).
EW_DISJOINT, EW_ALIGNED, EW_OVERLAP = range(3)
#: Chunks a launch of order 0 or 1 takes at most (two a SM); the entry
#: point lowers the grid to what the card holds and a CTA then walks more
#: than one chunk.
EW_GRID = 2 * CONV_SMS
#: Chunks an order-2 launch takes at most: one a SM, all resident at once.
EW_RESIDENT = CONV_SMS
#: Shared memory an order-2 chunk's staging may take; a larger one stages
#: in the global workspace, one slice a chunk.
EW_SMEM_BUDGET = 192 * 1024
#: Bytes of an order-2 launch's barrier counter, at the workspace's start.
EW_COUNTER_BYTES = 16
#: Outputs of a mean a chunk takes, one a thread (its whole reduction):
#: resnet_50_v2's 2,048 channels go to 16 CTAs.
MEAN_PER = 128


class EwTiling(NamedTuple):
    """The units of a chunk walk: ``vec`` output elements each (16 bytes'
    worth where every operand's element map allows 16-byte loads and
    stores, else 1; a mean's unit is one output), ``units`` of them over
    the output's whole block (padding included), ``per`` units a chunk,
    ``chunks`` chunks. Chunk ``c`` is units ``[c*per, min((c+1)*per,
    units))``; a CTA's threads stride over its chunk."""
    vec: int
    units: int
    per: int
    chunks: int


def runs_ew_grid(spec: OpSpec) -> bool:
    """Does the spec run the elementwise grid body: an elementwise op of
    the flat or row-blocked program, or a staged one of the streaming
    program (a fused chain runs its elementwise stages as chunks of its
    own levels, :func:`chain_schedule`)."""
    return spec.kind == "elementwise" and stream_form(spec) in (None,
                                                                "stage")


def runs_chunk_walk(spec: OpSpec) -> bool:
    """Does the spec run a chunk walk body: an elementwise, concat, mean or
    pad op of the flat or row-blocked program, or a staged one of the
    streaming program (a fused chain runs its elementwise and concat
    stages as chunks of its own levels, :func:`chain_schedule`)."""
    return spec.kind in ("elementwise", "concat", "mean", "pad") and \
        stream_form(spec) in (None, "stage")


def _ew_map(spec: OpSpec, i: Optional[int]) -> Tuple[int, int, int]:
    """How operand ``i`` (None: the output) maps tensor element ``e`` to
    the arena (``elem_at``; ``elem_of`` inverts it over the output's
    block): ``(byte offset, span, used)``, element ``e`` at element ``(e //
    used) * span + e % used`` from the offset, span ``k * L`` and used
    ``rl`` for a spanning operand; ``(offset, 0, 0)`` where that is ``e``
    itself (no padding)."""
    off, L, _, k, rl, used, _ = operand_addr(spec, i)
    span, used = (k * L, rl) if k > 1 else (L, used)
    return (off, 0, 0) if span == used else (off, span, used)


def _elem_bytes(spec: OpSpec, i: int, e: np.ndarray) -> np.ndarray:
    """Arena byte offset of tensor elements ``e`` of input ``i``."""
    off, span, used = _ew_map(spec, i)
    at = (e // used) * span + e % used if span else e
    return off + at * _isz(spec.dtype)


def _block_elems(spec: OpSpec, n: int) -> np.ndarray:
    """The tensor element each element of the output's block holds, -1 in
    the padding (``elem_of``)."""
    _, span, used = _ew_map(spec, None)
    b = np.arange(operand_addr(spec, None)[6])
    if not span:
        return np.where(b < n, b, -1)
    r, j = np.divmod(b, span)
    e = np.where(j < used, r * used + j, -1)
    return np.where(e < n, e, -1)


@functools.lru_cache(maxsize=1024)
def ew_order(spec: OpSpec) -> int:
    """The order word of an elementwise spec from the arena byte ranges of
    its operands (:func:`_byte_range`): :data:`EW_DISJOINT` when no input
    meets the output; :data:`EW_ALIGNED` when every input that meets it
    maps each element where the output does (:func:`_ew_map`) and is not
    broadcast; else :data:`EW_OVERLAP`."""
    out = _byte_range(spec, None)
    met = [i for i in range(len(spec.in_off))
           if _meets(_byte_range(spec, i), out)]
    if not met:
        return EW_DISJOINT
    bcast = _ew_broadcast(spec)[0]
    om = _ew_map(spec, None)
    if all(_ew_map(spec, i) == om and not (i == 1 and bcast) for i in met):
        return EW_ALIGNED
    return EW_OVERLAP


def _inputs_order(spec: OpSpec) -> int:
    """:data:`EW_DISJOINT` when no input's arena byte range meets the
    output's (:func:`_byte_range`), else :data:`EW_OVERLAP`."""
    out = _byte_range(spec, None)
    if any(_meets(_byte_range(spec, i), out)
           for i in range(len(spec.in_off))):
        return EW_OVERLAP
    return EW_DISJOINT


@functools.lru_cache(maxsize=1024)
def concat_order(spec: OpSpec) -> int:
    """The order word of a concat from each input's arena byte range
    against the output's: :data:`EW_DISJOINT` when none meets it (every
    concat of the Table III zoo), else :data:`EW_OVERLAP`."""
    return _inputs_order(spec)


@functools.lru_cache(maxsize=1024)
def pad_order(spec: OpSpec) -> int:
    """The order word of a pad from the input's arena byte range against
    the output's: :data:`EW_DISJOINT` when they do not meet (every pad the
    port's programs lower), else :data:`EW_OVERLAP`."""
    return _inputs_order(spec)


@functools.lru_cache(maxsize=1024)
def mean_order(spec: OpSpec) -> int:
    """The order word of a mean: :data:`EW_DISJOINT` when the input's and
    the output's byte ranges do not meet; :data:`EW_ALIGNED` ("own") when,
    byte for byte, every input element that lies in the output's block lies
    in the bytes of the one output element whose reduction it belongs to
    (never in padding), so that output's thread reads it before it stores
    there and no other thread reads it; else :data:`EW_OVERLAP`."""
    out = _byte_range(spec, None)
    if not _meets(_byte_range(spec, 0), out):
        return EW_DISJOINT
    dims, rmask, _, outn = _mean_geometry(spec)
    isz = _isz(spec.dtype)
    coords = np.unravel_index(np.arange(_elems(dims)), dims)
    kept = [i for i in range(4) if not rmask >> i & 1]
    owner = np.ravel_multi_index([coords[i] for i in kept],
                                 [dims[i] for i in kept]) if kept else \
        np.zeros(_elems(dims), np.int64)
    lo, hi = out
    e = _block_elems(spec, outn)
    holder = np.repeat(np.where(e >= 0, e, -2), isz)  # -2: padding
    start = _elem_bytes(spec, 0, np.arange(_elems(dims)))
    for j in range(isz):
        at = start + j - lo
        inside = (at >= 0) & (at < hi - lo)
        if (holder[at[inside]] != owner[inside]).any():
            return EW_OVERLAP
    return EW_ALIGNED


def _ew_vec_ok(spec: OpSpec, i: Optional[int], vec: int) -> bool:
    """Can operand ``i`` (None: the output) move ``vec`` elements a 16-byte
    access: its base 16-byte aligned and its rows unpadded or of
    ``vec``-multiple spans and used lengths (:func:`_ew_map`: a unit then
    never leaves one row's used elements or its padding)."""
    off, span, used = _ew_map(spec, i)
    return off % 16 == 0 and span % vec == 0 and used % vec == 0


def _unit_tiling(units: int, vec: int, overlap: bool,
                 per: int) -> EwTiling:
    """``units`` in chunks of about ``per``, at most :data:`EW_GRID`
    chunks (:data:`EW_RESIDENT` for order 2, whose chunks must all run at
    once)."""
    cap = EW_RESIDENT if overlap else EW_GRID
    chunks = max(1, min(cap, -(-units // per)))
    per = -(-units // chunks)
    return EwTiling(vec, units, per, -(-units // per))


def _ew_vec(spec: OpSpec) -> int:
    """Elements of an elementwise spec's unit: 16 bytes' worth where the
    element count, the output block and every operand that is not
    broadcast allow them (:func:`_ew_vec_ok`), else 1."""
    bcast, dims, _ = _ew_broadcast(spec)
    nblk = operand_addr(spec, None)[6]
    vec = 16 // _isz(spec.dtype)
    ops = [None, 0] + ([1] if len(spec.in_off) == 2 and not bcast else [])
    if _elems(dims) % vec or nblk % vec or not all(
            _ew_vec_ok(spec, i, vec) for i in ops):
        return 1
    return vec


@functools.lru_cache(maxsize=1024)
def ew_tiling(spec: OpSpec) -> EwTiling:
    """The units and chunks of an elementwise spec: :func:`_ew_vec`
    elements a unit, about one unit a thread (:func:`_unit_tiling`)."""
    vec = _ew_vec(spec)
    return _unit_tiling(operand_addr(spec, None)[6] // vec, vec,
                        ew_order(spec) == EW_OVERLAP, EW_THREADS)


def _concat_geometry(spec: OpSpec) -> Tuple[int, int, Tuple[int, ...]]:
    """(outer, inner_out, each input's inner) of a concat: outer = the
    product of the dims before the axis, inner the rest."""
    axis = spec.meta[0] % len(spec.out_shape)
    return (_elems(spec.out_shape[:axis]), _elems(spec.out_shape[axis:]),
            tuple(_elems(s[axis:]) for s in spec.in_shape))


def _concat_vec(spec: OpSpec) -> int:
    """Elements of a concat's unit: 16 bytes' worth where every input's
    inner, the output's inner_out, the output block and every operand's
    base and rows allow them (a unit then lies in one input's columns,
    which that input holds as one aligned 16-byte run), else 1."""
    _, inner_out, inners = _concat_geometry(spec)
    nblk = operand_addr(spec, None)[6]
    vec = 16 // _isz(spec.dtype)
    if inner_out % vec or nblk % vec or any(x % vec for x in inners) or \
            not all(_ew_vec_ok(spec, i, vec)
                    for i in [None, *range(len(spec.in_off))]):
        return 1
    return vec


@functools.lru_cache(maxsize=1024)
def concat_tiling(spec: OpSpec) -> EwTiling:
    """The units and chunks of a concat: :func:`_concat_vec` elements a
    unit, about one unit a thread (:func:`_unit_tiling`)."""
    vec = _concat_vec(spec)
    return _unit_tiling(operand_addr(spec, None)[6] // vec, vec,
                        concat_order(spec) == EW_OVERLAP, EW_THREADS)


def _pad_vec(spec: OpSpec) -> int:
    """Elements of a pad's unit: 16 bytes' worth where the innermost
    axis's input and output lengths and leading pad are multiples of them
    (a unit then lies in one innermost row, wholly inside or wholly
    outside the input's box, on an aligned run of the input's elements),
    the output block allows them and both operands' bases and rows do
    (:func:`_ew_vec_ok`), else 1."""
    ind, lo, outd = _pad_geometry(spec)
    nblk = operand_addr(spec, None)[6]
    vec = 16 // _isz(spec.dtype)
    if ind[3] % vec or lo[3] % vec or outd[3] % vec or nblk % vec or \
            not (_ew_vec_ok(spec, None, vec) and _ew_vec_ok(spec, 0, vec)):
        return 1
    return vec


@functools.lru_cache(maxsize=1024)
def pad_tiling(spec: OpSpec) -> EwTiling:
    """The units and chunks of a pad: :func:`_pad_vec` elements a unit,
    about one unit a thread (:func:`_unit_tiling`)."""
    vec = _pad_vec(spec)
    return _unit_tiling(operand_addr(spec, None)[6] // vec, vec,
                        pad_order(spec) == EW_OVERLAP, EW_THREADS)


@functools.lru_cache(maxsize=1024)
def mean_tiling(spec: OpSpec) -> EwTiling:
    """The units and chunks of a mean: one output (of the output's block,
    padding included) a unit and a thread, about :data:`MEAN_PER` a chunk
    (:func:`_unit_tiling`)."""
    return _unit_tiling(operand_addr(spec, None)[6], 1,
                        mean_order(spec) == EW_OVERLAP, MEAN_PER)


def chunk_of(spec: OpSpec) -> Tuple[EwTiling, int]:
    """(tiling, order word) of a spec that runs a chunk walk
    (:func:`runs_chunk_walk`)."""
    if spec.kind == "elementwise":
        return ew_tiling(spec), ew_order(spec)
    if spec.kind == "concat":
        return concat_tiling(spec), concat_order(spec)
    if spec.kind == "pad":
        return pad_tiling(spec), pad_order(spec)
    return mean_tiling(spec), mean_order(spec)


def chunk_grid(spec: OpSpec) -> Tuple[int, int, int]:
    """(CTAs to launch at most, CTAs that must run at once, counter bytes)
    of a chunk walk's spec: one CTA a chunk; order 2 needs every chunk
    resident (a cooperative launch the entry point refuses on a card that
    cannot hold it) and its barrier counter, which the entry point
    zeroes."""
    t, order = chunk_of(spec)
    if order == EW_OVERLAP:
        return t.chunks, t.chunks, EW_COUNTER_BYTES
    return t.chunks, 0, 0


# ---------------------------------------------------------------------------
# The product grid body (csrc/fc_tiles.cuh: arena_fully_connected,
# arena_matmul, and arena_stream_stage's FC and matmul bodies in place on
# the arena): b cut into column blocks x K slices (x row blocks of a's many
# rows), one item a CTA, the slices' partials summed in a fixed order, and
# the order word that keeps read-all-before-write-all. The kernels read the
# same numbers from the descriptor.
# ---------------------------------------------------------------------------

#: Output columns of a product CTA: four a lane of a warp (16-byte b loads).
FC_COLS = 4 * 32
#: Warps of a product CTA; with few rows each sums ``rpt`` rows of its K
#: slice, with many rows ``rm`` rows of a over the whole slice.
FC_WARPS = EW_THREADS // 32
#: CTAs a product grid takes at most, when b has enough rows: one a SM
#: (an order-2 grid: all of them resident, walking every item).
FC_GRID = CONV_SMS
#: Bytes of a product op's counters before its per-tile ones: the grid
#: barrier (three words of padding).
FC_COUNTER_BYTES = 16
#: Rows of a a warp of a matmul's row block sums over its whole K slice
#: in registers (an FC's rows, a batch of a few, take no row blocks: its
#: warps split the slice and meet in shared memory).
MM_RM = 4
#: Rows of b a row-block item's K slice takes at least.
MM_MIN_BK = 64
#: A matmul descriptor's word: 1 when b's four columns of a lane are one
#: aligned run in the arena (one 16-byte load; int8: 4-byte), else 0.
D_VECB = 112


class FcTiling(NamedTuple):
    """The items of a product ``y = a . b`` (a fully connected op, b = W;
    a matmul, b in the arena): column block ``cb`` (``bo`` output columns
    from ``cb * bo``) x K slice ``ks`` (``bk`` rows of b from ``ks * bk``)
    x row block ``rb`` (``bm`` rows of a from ``rb * bm``), ``nrb * ncb *
    nks`` of them, one a CTA (``ctas``); item ``i`` is ``ks = i % nks``,
    ``cb = i // nks % ncb``, ``rb = i // (nks * ncb)``. An FC (``rm`` 0:
    one row block of every row) splits a slice over the warps, ``rpt = bk
    / FC_WARPS`` rows of W each; a matmul's warp ``w`` takes rows ``rb *
    bm + w * rm ..`` (``rm`` of them) over the whole slice (``rpt =
    bk``). Every b element lies in exactly one item a row block."""
    bo: int
    bk: int
    rpt: int
    ncb: int
    nks: int
    ctas: int
    bm: int
    nrb: int
    rm: int


def runs_product_grid(spec: OpSpec) -> bool:
    """Does the spec run the product grid body: a fully connected op or a
    matmul of the flat or row-blocked program, or a staged one of the
    streaming program."""
    return spec.kind in ("fully_connected", "matmul") and stream_form(
        spec) in (None, "stage")


def _product_geometry(spec: OpSpec) -> Tuple[int, int, int]:
    """(m, k, n) of a product: a's rows and b's shape."""
    if spec.kind == "matmul":
        return _matmul_geometry(spec)
    return _fc_geometry(spec)


def _fc_geometry(spec: OpSpec) -> Tuple[int, int, int]:
    """(m, idim, odim): x's rows and W's shape."""
    idim, odim = _weight_shape(spec)
    return _elems(spec.in_shape[0]) // idim, idim, odim


@functools.lru_cache(maxsize=1024)
def product_tiling(m: int, k: int, n: int, rows: bool) -> FcTiling:
    """The items of ``(m, k) x (k, n)``: :data:`FC_COLS` columns a block;
    without ``rows`` (an FC) one row block, and the fewest rows a warp
    (``rpt``) that keep the items within :data:`FC_GRID` (at least one row
    a warp, one slice a block); with them (a matmul) row blocks of
    ``FC_WARPS * MM_RM`` rows and as many K slices (of :data:`MM_MIN_BK`
    rows at least) as keep the items within :data:`FC_GRID`."""
    ncb = -(-n // FC_COLS)
    if not rows:
        rpt = -(-k // (FC_WARPS * max(1, FC_GRID // ncb)))
        bk = FC_WARPS * rpt
        nks = -(-k // bk)
        return FcTiling(FC_COLS, bk, rpt, ncb, nks, ncb * nks, m, 1, 0)
    bm = FC_WARPS * MM_RM
    nrb = -(-m // bm)
    nks = max(1, min(FC_GRID // (nrb * ncb), -(-k // MM_MIN_BK)))
    bk = -(-k // nks)
    nks = -(-k // bk)
    return FcTiling(FC_COLS, bk, bk, ncb, nks, nrb * ncb * nks, bm, nrb,
                    MM_RM)


@functools.lru_cache(maxsize=1024)
def fc_tiling(spec: OpSpec) -> FcTiling:
    """The items of a fully connected or matmul spec, from ``(m, k, n)``
    and its kind alone (:func:`product_tiling`, row blocks for a matmul
    only: the dtype, layout and offsets never enter, so the flat, blocked
    and streaming programs sum in one order)."""
    return product_tiling(*_product_geometry(spec),
                          rows=spec.kind == "matmul")


@functools.lru_cache(maxsize=1024)
def fc_order(spec: OpSpec) -> int:
    """The order word of a fully connected spec from the arena byte ranges
    of x and of the output (:func:`_byte_range`): :data:`EW_DISJOINT` when
    they do not meet (no CTA waits), else :data:`EW_OVERLAP` (every CTA
    reads x before one grid-wide barrier, and stores after it)."""
    if _meets(_byte_range(spec, 0), _byte_range(spec, None)):
        return EW_OVERLAP
    return EW_DISJOINT


@functools.lru_cache(maxsize=1024)
def matmul_order(spec: OpSpec) -> int:
    """The order word of a matmul from the arena byte ranges of a, b and
    the output (:func:`_byte_range`): :data:`EW_DISJOINT` when neither
    operand meets the output, else :data:`EW_OVERLAP` (every CTA reads its
    rows of a and b before one grid-wide barrier, and stores after it)."""
    out = _byte_range(spec, None)
    if any(_meets(_byte_range(spec, i), out) for i in (0, 1)):
        return EW_OVERLAP
    return EW_DISJOINT


def product_order(spec: OpSpec) -> int:
    """:func:`fc_order` or :func:`matmul_order`, by the spec's kind."""
    return matmul_order(spec) if spec.kind == "matmul" else fc_order(spec)


def _mm_vec_b(spec: OpSpec) -> bool:
    """Does a matmul's b hold each lane's four columns as one aligned run
    (:func:`_ew_map`: n and b's rows multiples of four, its base at a
    16-byte (int8: 4-byte) boundary of the arena)?"""
    _, _, n = _matmul_geometry(spec)
    off, span, used = _ew_map(spec, 1)
    return n % 4 == 0 and off % (4 * _isz(spec.dtype)) == 0 and \
        span % 4 == 0 and used % 4 == 0


def mm_direct(spec: OpSpec) -> bool:
    """Do a matmul's row blocks store their sums straight from their
    registers: one K slice and order 0 (no partials, no counters)?"""
    return spec.kind == "matmul" and fc_tiling(spec).nks == 1 and \
        product_order(spec) != EW_OVERLAP


def fc_counter_bytes(spec: OpSpec) -> int:
    """Bytes of a product op's counters: :data:`FC_COUNTER_BYTES`, then one
    int32 of finished slices per (row block, column block), 16-aligned;
    none where nothing counts (order 0 with one K slice: every item is its
    tile's last, and the entry point sets no memset before the launch)."""
    t = fc_tiling(spec)
    if t.nks == 1 and product_order(spec) != EW_OVERLAP:
        return 0
    return _round_up(FC_COUNTER_BYTES + 4 * t.nrb * t.ncb, 16)


def fc_grid(spec: OpSpec) -> Tuple[int, int, int]:
    """(CTAs to launch at most, CTAs that must run at once, counter bytes)
    of a fully connected or matmul spec: one CTA an item; overlap needs a
    resident grid (a cooperative launch the entry point refuses on a card
    that cannot hold it): an FC's of one CTA an item, a matmul's of at
    most :data:`FC_GRID`, each CTA walking its items before the barrier;
    both count finished slices, which the entry point zeroes."""
    t = fc_tiling(spec)
    if product_order(spec) == EW_OVERLAP:
        g = min(t.ctas, FC_GRID) if spec.kind == "matmul" else t.ctas
        return g, g, fc_counter_bytes(spec)
    return t.ctas, 0, fc_counter_bytes(spec)


# ---------------------------------------------------------------------------
# The softmax grid body (csrc/softmax_tiles.cuh: arena_softmax, and
# arena_stream_stage's softmax body in place on the arena): rows over the
# card, a CTA a row for a few rows, a warp a row for many, and the order
# word that keeps read-all-before-write-all. The kernels read the same
# numbers from the descriptor.
# ---------------------------------------------------------------------------

#: Row policies: a warp a row, its values in registers; a CTA a row, a
#: column a thread, its values through a buffer (shared memory, or past
#: :data:`EW_SMEM_BUDGET` a workspace slice a CTA).
SM_WARP, SM_CTA = range(2)
#: Values a lane of a warp row holds at most (a warp row: 1,024 values).
SM_WARP_VALS = 32
#: Rows a softmax gives a CTA each at most: as many as one grid takes. A
#: few rows are bound by one row's latency, which a CTA's 512 threads cut
#: and a warp's 32 do not (a 1,000-class f32 row on an H100: 11.6 us on a
#: warp, 3.6 on a CTA, ``scripts/torch_softmax_matmul_variants.py``); many
#: rows fill the card on warps.
SM_FEW_ROWS = EW_GRID


class SoftmaxTiling(NamedTuple):
    """A softmax's row policy (:data:`SM_WARP`, :data:`SM_CTA`), the
    columns of a thread's group (a warp row's 16 bytes' worth: 4 f32, 16
    int8; a CTA row's one) and the groups a thread takes (``per``): thread
    ``t`` of a row's ``T`` (32, or :data:`EW_THREADS`) holds columns ``(t +
    T * j) * vec + i``, and sums them ``j`` then ``i`` ascending."""
    mode: int
    vec: int
    per: int


def runs_softmax_grid(spec: OpSpec) -> bool:
    """Does the spec run the softmax grid body: a softmax of the flat or
    row-blocked program, or a staged one of the streaming program."""
    return spec.kind == "softmax" and stream_form(spec) in (None, "stage")


def _softmax_geometry(spec: OpSpec) -> Tuple[int, int]:
    """(rows, last): the product of the leading dims, and the softmax
    axis."""
    last = spec.in_shape[0][-1]
    n = _elems(spec.in_shape[0])
    if _elems(spec.out_shape) != n or not last:
        raise ValueError(f"softmax: {spec.in_shape} -> {spec.out_shape}")
    return n // last, last


@functools.lru_cache(maxsize=1024)
def softmax_tiling(spec: OpSpec) -> SoftmaxTiling:
    """The row policy of a softmax from ``(rows, last)`` and the element
    type alone (the layout and offsets never enter, so the flat, blocked
    and streaming programs sum in one order): more than
    :data:`SM_FEW_ROWS` rows of at most ``32 * SM_WARP_VALS`` values a warp
    a row; else a CTA a row, a column a thread, through a buffer."""
    rows, last = _softmax_geometry(spec)
    if rows > SM_FEW_ROWS and last <= 32 * SM_WARP_VALS:
        vec = 16 // _isz(spec.dtype)
        return SoftmaxTiling(SM_WARP, vec, -(-last // (32 * vec)))
    return SoftmaxTiling(SM_CTA, 1, -(-last // EW_THREADS))


@functools.lru_cache(maxsize=1024)
def softmax_order(spec: OpSpec) -> int:
    """The order word of a softmax: :data:`EW_DISJOINT` when the input's
    and the output's byte ranges do not meet; :data:`EW_ALIGNED` when,
    byte for byte, every input element that lies in the output's block
    lies in an output element of its own row (never in padding), so that
    row's owner reads it before it stores there and no other warp or CTA
    reads it (the flagship's in-place softmax); else :data:`EW_OVERLAP`."""
    out = _byte_range(spec, None)
    if not _meets(_byte_range(spec, 0), out):
        return EW_DISJOINT
    rows, last = _softmax_geometry(spec)
    n = rows * last
    isz = _isz(spec.dtype)
    lo, hi = out
    e = _block_elems(spec, n)
    holder = np.repeat(np.where(e >= 0, e // last, -2), isz)  # -2: padding
    start = _elem_bytes(spec, 0, np.arange(n))
    row = np.arange(n) // last
    for j in range(isz):
        at = start + j - lo
        inside = (at >= 0) & (at < hi - lo)
        if (holder[at[inside]] != row[inside]).any():
            return EW_OVERLAP
    return EW_ALIGNED


def softmax_grid(spec: OpSpec) -> Tuple[int, int, int]:
    """(CTAs to launch at most, CTAs that must run at once, counter bytes)
    of a softmax: a CTA a row (a warp row's CTA takes the rows of its
    warps), at most :data:`EW_GRID`; order 2 at most :data:`EW_RESIDENT`,
    all resident (a cooperative launch the entry point refuses on a card
    that cannot hold it), and its barrier counter, which the entry point
    zeroes."""
    rows, _ = _softmax_geometry(spec)
    if softmax_order(spec) == EW_OVERLAP:
        g = min(rows, EW_RESIDENT)
        return g, g, EW_COUNTER_BYTES
    return min(rows, EW_GRID), 0, 0


def runs_in_place(spec: OpSpec) -> bool:
    """Does a staged streaming spec run in place on the arena (no window,
    no copies): an elementwise, concat, mean, pad, fully connected, matmul
    or softmax body (every staged kind)."""
    return runs_chunk_walk(spec) or runs_product_grid(spec) or \
        runs_softmax_grid(spec)


# ---------------------------------------------------------------------------
# The fused chains over the whole card (csrc/chain_tiles.cuh: the one
# device routine of arena_fused_chain and arena_stream_fused): the chain's
# own placement of its internal tensors, its stages in levels, and each
# stage's tiles or chunks in one ticket range per level. The kernels read
# the same numbers from the descriptor.
# ---------------------------------------------------------------------------

#: Threads of a chain CTA: the tile bodies' width, which the chunk bodies
#: run at too (one unit a thread a chunk).
CHAIN_THREADS = CONV_THREADS
#: Chain CTAs an SM holds at most (at most 128 registers a thread).
CHAIN_CTAS_PER_SM = 2
#: A chain descriptor's header words: the stage count, the level count,
#: the bytes of one CTA's footprint slice (global footprints) and of its
#: staged terminal chunk's slice, then per level from H_LEVEL0 its first
#: stage (stage descriptors follow the header in level order) and its
#: tickets; the buffer words after.
H_NS, H_NL, H_FP, H_TERM, H_LEVEL0 = 0, 1, 2, 3, 8
#: Levels a header holds.
MAX_LEVELS = (BUFFER_WORD["stage"] - H_LEVEL0) // 2
#: A chain stage's words beside its own op's: its first ticket within its
#: level and its tickets.
D_T0, D_NT = 116, 117


class ChainSchedule(NamedTuple):
    """How the chain kernels run a fused spec (:func:`chain_schedule`).

    ``stages``: the spec's stages in graph order, re-pointed to the
    kernel's own placement: an operand flagged ``in_scratch`` /
    ``out_scratch`` addresses the workspace, where every non-terminal
    stage's output has a region of its own (``regions``: (stage, offset,
    bytes), offsets in the spec's units from the workspace start: bytes
    flat, arena rows blocked; 16-byte aligned); every input the reference
    read from a scratch slot reads the region of the stage that last wrote
    those bytes. In the streaming program the external inputs and the
    terminal output address their arena rows instead (flag 0): no window.
    ``terminal``: the stages that write the arena, all in the last level.
    ``levels``: stage indices per level, graph order within; a stage's
    level is one more than the highest level of the stages it depends on
    (``edges``: (i, j, "raw" | "war" | "waw") over the new placement,
    i < j). ``tilings``/``items``: per stage its ConvTiling and tiles (row
    kinds, :func:`conv_tiling`) or its EwTiling and chunks (elementwise and
    concat, one unit a thread). ``counter_bytes``: the level tickets, then
    ``n_barriers`` grid barrier counters, at the workspace start.
    ``region_bytes``: the regions after them. ``staged``: an arena input of
    the last level meets an arena output of it, so its chunks stage their
    results before one more barrier. ``grid``: CTAs, all resident."""
    stages: Tuple[OpSpec, ...]
    terminal: Tuple[int, ...]
    levels: Tuple[Tuple[int, ...], ...]
    edges: Tuple[Tuple[int, int, str], ...]
    tilings: Tuple[NamedTuple, ...]
    items: Tuple[int, ...]
    regions: Tuple[Tuple[int, int, int], ...]
    unit: int
    counter_bytes: int
    n_barriers: int
    region_bytes: int
    staged: bool
    grid: int


def _units_of(st: OpSpec, i: Optional[int]) -> int:
    """Extent of operand ``i`` (None: the output) in the spec's offset
    units: bytes of the tensor (flat), rows of its block (blocked)."""
    nblk = operand_addr(st, i)[6]
    return nblk // st.rowlen if st.rowlen else nblk * _isz(st.dtype)


def _span(st: OpSpec, i: Optional[int]) -> Tuple[int, int]:
    off = st.out_off if i is None else st.in_off[i]
    return off, off + _units_of(st, i)


def _chain_terminal(spec: OpSpec) -> List[int]:
    """The stages whose output is the chain's: those that write the arena
    (flag 0), or in the streaming program the last writers of the output
    slot, which must tile it exactly (its copy back then moves only what
    they wrote)."""
    stages = spec.stages
    if stream_form(spec) != "fused":
        return [j for j, st in enumerate(stages) if not st.out_scratch]
    slot = (spec.out_slot, spec.out_slot + spec.out_rows[0])
    term = [j for j, st in enumerate(stages)
            if _meets(_span(st, None), slot) and not any(
                _meets(_span(stages[k], None), _span(st, None))
                for k in range(j + 1, len(stages)))]
    spans = sorted(_span(stages[j], None) for j in term)
    if not spans or spans[0][0] != slot[0] or spans[-1][1] != slot[1] or \
            any(a[1] != b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError(f"the chain's last writers {spans} do not tile its "
                         f"output slot {slot}")
    return term


def _repoint(spec: OpSpec, terminal: Sequence[int],
             region: Dict[int, int]) -> List[OpSpec]:
    """The stages with every scratch operand re-pointed (see
    :class:`ChainSchedule`); ``region``: each non-terminal stage's region
    offset."""
    stages = spec.stages
    stream = stream_form(spec) == "fused"
    out = []
    for k, st in enumerate(stages):
        offs, flags = list(st.in_off), list(st.in_scratch or
                                             (0,) * len(st.in_off))
        for i, flag in enumerate(flags):
            if not flag:
                continue
            lo, hi = _span(st, i)
            writers = [j for j in range(k) if (stream or
                       stages[j].out_scratch)
                       and _meets(_span(stages[j], None), (lo, hi))]
            if writers:
                j = writers[-1]
                wlo, whi = _span(stages[j], None)
                if j in terminal or not wlo <= lo < hi <= whi:
                    raise ValueError(
                        f"stage {k} reads scratch {(lo, hi)} that stage {j} "
                        f"wrote only in part, or the chain's output")
                offs[i], flags[i] = region[j] + lo - wlo, 1
                continue
            ext = [e for e, s in enumerate(spec.in_slots)
                   if s <= lo and hi <= s + spec.in_rows[e][0]] \
                if stream else []
            if not ext:
                raise ValueError(f"stage {k} reads scratch {(lo, hi)} that "
                                 "no stage wrote")
            e = ext[0]
            offs[i], flags[i] = spec.in_off[e] + lo - spec.in_slots[e], 0
        if k in terminal:
            o_off, o_flag = (spec.out_off + st.out_off - spec.out_slot, 0) \
                if stream else (st.out_off, 0)
        else:
            o_off, o_flag = region[k], 1
        out.append(dataclasses.replace(
            st, in_off=tuple(offs), in_scratch=tuple(flags),
            out_off=o_off, out_scratch=o_flag))
    return out


def _chain_edges(stages: Sequence[OpSpec]) -> List[Tuple[int, int, str]]:
    """(i, j, kind) for stages i < j whose byte ranges in one address space
    (flag 1: the workspace, 0: the arena) meet: j reads what i wrote
    ("raw"), j writes what i read ("war"), both write ("waw")."""
    def reads(st):
        flags = st.in_scratch or (0,) * len(st.in_off)
        return [(f, *_span(st, i)) for i, f in enumerate(flags)]

    def writes(st):
        return [(st.out_scratch, *_span(st, None))]

    def meet(xs, ys):
        return any(a[0] == b[0] and _meets(a[1:], b[1:])
                   for a in xs for b in ys)
    edges = []
    for j, b in enumerate(stages):
        for i in range(j):
            a = stages[i]
            for kind, x, y in (("raw", writes(a), reads(b)),
                               ("war", reads(a), writes(b)),
                               ("waw", writes(a), writes(b))):
                if meet(x, y):
                    edges.append((i, j, kind))
    return edges


def _chain_chunks(st: OpSpec, cap: Optional[int] = None) -> EwTiling:
    """A chain stage's chunks: one unit a thread (:func:`_ew_vec`,
    :func:`_concat_vec`), at most ``cap`` chunks."""
    vec = _ew_vec(st) if st.kind == "elementwise" else _concat_vec(st)
    units = operand_addr(st, None)[6] // vec
    chunks = max(1, -(-units // CHAIN_THREADS))
    if cap is not None:
        chunks = max(1, min(chunks, cap))
    per = -(-units // chunks)
    return EwTiling(vec, units, per, -(-units // per))


@functools.lru_cache(maxsize=256)
def chain_schedule(spec: OpSpec) -> ChainSchedule:
    """The kernel's schedule of a fused spec, flat, blocked or streaming
    (:class:`ChainSchedule`). Raises ValueError on a chain it cannot run:
    a stage reading the chain's output or scratch no stage wrote, terminal
    stages writing over each other, a row-kind terminal stage that would
    have to stage its output, more than :data:`MAX_LEVELS` levels."""
    if spec.kind != "fused":
        raise ValueError(f"{spec.kind}: not a fused chain")
    isz = _isz(spec.dtype)
    unit = spec.rowlen * isz if spec.rowlen else 1
    align = 16 // math.gcd(16, unit)    # units a 16-byte boundary takes
    terminal = _chain_terminal(spec)
    region, cur = {}, 0
    for j, st in enumerate(spec.stages):
        if j not in terminal:
            region[j] = cur
            cur = _round_up(cur + _units_of(st, None), align)
    stages = _repoint(spec, terminal, region)
    edges = _chain_edges(stages)
    level = [0] * len(stages)
    staged = False
    for i, j, kind in edges:
        if i in terminal and (j not in terminal or kind != "war"):
            raise ValueError(f"stage {j} {kind} against terminal stage {i}")
        if i in terminal:
            staged = True
        else:
            level[j] = max(level[j], level[i] + 1)
    outs = [_span(stages[t], None) for t in terminal]
    for j in terminal:      # an arena input under a terminal output
        st = stages[j]
        for i, f in enumerate(st.in_scratch or (0,) * len(st.in_off)):
            staged |= not f and any(_meets(_span(st, i), o) for o in outs)
    last = max([level[j] + 1 for j in range(len(stages))
                if j not in terminal] + [level[j] for j in terminal])
    for j in terminal:
        level[j] = last
    levels = tuple(tuple(j for j in range(len(stages)) if level[j] == lv)
                   for lv in range(last + 1))
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels exceed {MAX_LEVELS}")
    tilings, fps, wts = [], [0], [0]
    for j, st in enumerate(stages):
        if st.kind in ROW_KINDS:
            if staged and j in terminal:
                raise ValueError(f"terminal {st.kind} over an arena input "
                                 "it would overwrite")
            t = conv_tiling(st)
            fps.append(t.fp)
            wts.append(2 * t.ch * t.to * isz)
        else:
            t = _chain_chunks(st)
        tilings.append(t)
    glob = max(fps) > CONV_SMEM_BUDGET
    smem = (0 if glob else _round_up(max(fps), 16)) + _round_up(max(wts), 16)
    cap = CONV_SMS * max(1, min(CHAIN_CTAS_PER_SM, SM_SMEM // (smem + 1024)))
    if glob:
        cap = min(cap, CONV_SLICES)
    items = [t.ntiles if st.kind in ROW_KINDS else t.chunks
             for st, t in zip(stages, tilings)]
    grid = max(1, min(cap, max(sum(items[j] for j in lvl)
                                for lvl in levels)))
    if staged and sum(items[j] for j in terminal) > grid:
        if len(terminal) > grid:
            raise ValueError(f"{len(terminal)} staged terminal stages on "
                             f"{grid} CTAs")
        for j in terminal:    # every terminal chunk on a CTA of its own
            tilings[j] = _chain_chunks(stages[j], grid // len(terminal))
            items[j] = tilings[j].chunks
    n_barriers = len(levels) - 1 + int(staged)
    counter_bytes = _round_up(4 * (len(levels) + n_barriers), align * unit)
    base = counter_bytes // unit
    stages = [dataclasses.replace(
        st, out_off=st.out_off + base if st.out_scratch else st.out_off,
        in_off=tuple(o + base if f else o for o, f in zip(
            st.in_off, st.in_scratch or (0,) * len(st.in_off))))
        for st in stages]
    regions = tuple((j, region[j] + base, _units_of(stages[j], None) * unit)
                    for j in sorted(region))
    return ChainSchedule(tuple(stages), tuple(terminal), levels,
                         tuple(edges), tuple(tilings), tuple(items), regions,
                         unit, counter_bytes, n_barriers, cur * unit, staged,
                         grid)


def chain_grid(spec: OpSpec) -> Tuple[int, int, int]:
    """(CTAs, CTAs that must run at once, counter bytes) of a fused spec:
    every CTA of the schedule's grid resident (a cooperative launch the
    entry point refuses, never shrinks, on a card that cannot hold it)
    and its counters, which the entry point zeroes."""
    s = chain_schedule(spec)
    return s.grid, s.grid, s.counter_bytes


def chain_plain(arena: torch.Tensor, spec: OpSpec,
                wblob: torch.Tensor) -> None:
    """The chain run by its schedule on the kernel's placement (a mirror of
    the kernel for the tests): levels in order, the stages of a level in
    reverse graph order, every stage's plain version over the arena and a
    zeroed workspace of the schedule's counters and regions; the streaming
    program's stages address the arena directly. A missing dependency
    between two stages of one level shows as a difference from
    :func:`fused_chain_plain` / :func:`stream_fused_plain`."""
    s = chain_schedule(spec)
    n = s.counter_bytes + s.region_bytes
    if spec.rowlen:
        ws = torch.zeros((n // s.unit, spec.rowlen),
                         dtype=_TORCH_DTYPE[spec.dtype], device=arena.device)
    else:
        ws = torch.zeros(n, dtype=torch.uint8, device=arena.device)
    for lvl in s.levels:
        for j in reversed(lvl):
            _run_stage(arena, s.stages[j], wblob,
                       weight_offsets(spec)[0][j], ws)


# ---------------------------------------------------------------------------
# Buffers: where a kernel's row buffer, staging buffer and scratch live
# ---------------------------------------------------------------------------


class BufferPlan(NamedTuple):
    """Dynamic shared bytes of the launch, bytes of the global workspace
    (0: none), and per buffer ``(name, in the global workspace?, byte
    offset)``."""
    smem: int
    gbytes: int
    parts: Tuple[Tuple[str, bool, int], ...]

    def on_global(self, name: str) -> bool:
        return any(n == name and g for n, g, _ in self.parts)


def _row_bytes(spec: OpSpec) -> int:
    return _elems(spec.out_shape[-2:]) * _isz(spec.dtype)


def _buffer_needs(spec: OpSpec) -> Tuple[Tuple[str, int], ...]:
    """Buffers the spec's kernel needs, in the order they claim shared
    memory. A tile kernel's counters, footprint and filter chunks; a
    chunk walk nothing, or for order 2 its barrier counter and one chunk's
    staging; the product grid body its counters, its partial sums
    (global: other CTAs sum them; none for a matmul's row blocks of one
    slice) and, an FC, one CTA's warp sums; a softmax, for order 2, its
    counter and every result, and for a CTA row its buffer; a fused chain
    (any program) its counters, its stages' regions, the largest footprint
    and filter chunks of its row stages and, staged, one terminal chunk a
    CTA."""
    if kernel_of(spec) in TILE_KERNELS:
        tl = conv_tiling(spec)
        return (("ctr", conv_counter_bytes(spec)), ("tile", tl.fp),
                ("wts", 2 * tl.ch * tl.to * _isz(spec.dtype)))
    if runs_chunk_walk(spec):
        t, order = chunk_of(spec)
        if order != EW_OVERLAP:
            return ()
        return (("ctr", EW_COUNTER_BYTES),
                ("chunk", t.per * t.vec * _isz(spec.dtype)))
    if runs_product_grid(spec):  # partials: an int32 or f32 a slice, output
        m, _, n = _product_geometry(spec)
        t = fc_tiling(spec)
        part = 0 if mm_direct(spec) else 4 * t.nks * m * n
        return (("ctr", fc_counter_bytes(spec)), ("part", part)) + (
            (("red", 4 * FC_WARPS * FC_COLS),) if not t.rm else ())
    if runs_softmax_grid(spec):
        rows, last = _softmax_geometry(spec)
        needs = ()
        if softmax_order(spec) == EW_OVERLAP:
            needs = (("ctr", EW_COUNTER_BYTES),
                     ("results", rows * last * _isz(spec.dtype)))
        if softmax_tiling(spec).mode == SM_CTA:
            needs += (("rowbuf", 4 * last),)
        return needs
    if spec.kind != "fused":
        raise NotImplementedError(f"{spec.kind} has no grid kernel here")
    s = chain_schedule(spec)
    tiles = [t for st, t in zip(s.stages, s.tilings)
             if st.kind in ROW_KINDS]
    needs = (("ctr", s.counter_bytes), ("regions", s.region_bytes),
             ("tile", max((t.fp for t in tiles), default=0)),
             ("wts", max((2 * t.ch * t.to * _isz(spec.dtype)
                          for t in tiles), default=0)))
    if not s.staged:
        return needs
    return needs + (("term", max(     # one staged chunk a CTA
        s.tilings[j].per * s.tilings[j].vec
        for j in s.terminal) * _isz(spec.dtype)),)


@functools.lru_cache(maxsize=1024)
def buffer_plan(spec: OpSpec) -> BufferPlan:
    """Each buffer takes dynamic shared memory (16-byte aligned) when it
    fits beside the ones before it within :data:`SMEM_LIMIT` (less
    :data:`STREAM_STATIC_SMEM` for a streaming launch), else the global
    workspace. A grid kernel's counters are always global, at its
    workspace's start, and so are a product's partial sums, a softmax's
    order-2 results and a fused chain's regions (right after its counters,
    where :func:`chain_schedule` placed them); a tile kernel's footprint
    (a chain's largest) takes shared memory within
    :data:`CONV_SMEM_BUDGET`, else one global slice per CTA
    (:data:`CONV_SLICES`); a chunk walk's staging likewise within
    :data:`EW_SMEM_BUDGET`, else one global slice a chunk, and a softmax's
    staged row one global slice a CTA; a chain's staged terminal chunks one
    global slice a CTA."""
    smem = gbytes = 0
    parts = []
    limit = SMEM_LIMIT - (STREAM_STATIC_SMEM if spec.win_rows else 0)
    for name, n in _buffer_needs(spec):
        n = _round_up(n, 16)
        if name in ("ctr", "part", "regions", "results") or (
                name == "tile" and n > CONV_SMEM_BUDGET):
            parts.append((name, True, gbytes))
            gbytes += n * (CONV_SLICES if name == "tile" else 1)
        elif name == "term":   # a chain's staged terminal: a slice a CTA
            parts.append((name, True, gbytes))
            gbytes += n * chain_schedule(spec).grid
        elif name == "chunk" and n > EW_SMEM_BUDGET:
            parts.append((name, True, gbytes))
            gbytes += n * chunk_of(spec)[0].chunks
        elif name == "rowbuf" and n > EW_SMEM_BUDGET:  # a slice a CTA
            parts.append((name, True, gbytes))
            gbytes += n * softmax_grid(spec)[0]
        elif smem + n <= limit:
            parts.append((name, False, smem))
            smem += n
        else:
            parts.append((name, True, gbytes))
            gbytes += n
    return BufferPlan(smem, gbytes, tuple(parts))


_WORKSPACES: "collections.OrderedDict" = collections.OrderedDict()
_WORKSPACE_CACHE = 256


def workspace(spec: OpSpec, device) -> Optional[torch.Tensor]:
    """The spec's global workspace on ``device`` (None when every buffer
    fits shared memory), allocated once per spec and cached."""
    n = buffer_plan(spec).gbytes
    if not n:
        return None
    key = (spec, torch.device(device))
    t = _WORKSPACES.get(key)
    if t is None:
        t = _WORKSPACES[key] = torch.empty(n, dtype=torch.uint8,
                                           device=device)
        while len(_WORKSPACES) > _WORKSPACE_CACHE:
            _WORKSPACES.popitem(last=False)
    return t


@functools.lru_cache(maxsize=1024)
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
    fused chain a header (word 0 = stage count) and then every stage's.
    The op's words, or the header, carry the buffer placement. A streaming
    spec's descriptor is its stream block, then its body's descriptor (a
    rolling or staged op's body at its arena offsets). A tile kernel's, a
    chunk walk's, the product's
    or the softmax grid body's (last) op descriptor carries its order word
    and tiling."""
    bp = buffer_plan(spec)
    if spec.kind == "fused":
        words = _chain_words(spec, bp)
        if spec.win_rows:
            words = np.concatenate([_stream_words(spec), words])
        return words
    if not spec.win_rows:
        words = _body_words(spec, bp)
    else:
        words = np.concatenate([_stream_words(spec),
                                _body_words(_stream_body(spec), bp)])
    body = words[-DESC_WORDS:]
    if kernel_of(spec) in TILE_KERNELS:
        body[D_ORDER] = conv_order(spec)
        tl = conv_tiling(spec)
        body[D_TILING:D_TILING + len(tl)] = tl
    elif runs_chunk_walk(spec):
        t, body[D_ORDER] = chunk_of(spec)
        body[D_TILING:D_TILING + len(t)] = t
    elif runs_product_grid(spec):
        body[D_ORDER] = product_order(spec)
        body[D_TILING:D_TILING + len(FcTiling._fields)] = fc_tiling(spec)
        if spec.kind == "matmul":
            body[D_VECB] = int(_mm_vec_b(spec))
    elif runs_softmax_grid(spec):
        body[D_ORDER] = softmax_order(spec)
        t = softmax_tiling(spec)
        body[D_TILING:D_TILING + len(t)] = t
    return words


def _stream_words(spec: OpSpec) -> np.ndarray:
    """A streaming spec's stream block (see :data:`S_COPY0`), padded to
    whole 32-word groups; the body's descriptor follows it. A staged op or
    a chain runs in place: its block holds only the body's offset."""
    w = [0] * S_COPY0
    if stream_form(spec) == "roll":
        tr, tile_ar = _tile_geom(spec)
        w[S_IN_ROW] = spec.in_off[0]
        w[S_WIN_IN], w[S_TR] = spec.win_rows - tile_ar, tr
        w[S_T], w[S_OH] = len(spec.win_starts), spec.out_shape[-3]
        w += spec.win_starts
    w += [0] * (_round_up(len(w), 32) - len(w))
    w[S_BODY] = len(w)
    return np.asarray(w, np.int32)


def _body_words(spec: OpSpec, bp: BufferPlan) -> np.ndarray:
    """One op's descriptor, with the buffer placement words of ``bp``."""
    head = _op_words(spec)
    _place(head, bp)
    return np.asarray(head, np.int32)


def _place(head: List[int], bp: BufferPlan) -> None:
    for name, glob, off in bp.parts:
        if name in BUFFER_WORD:
            head[BUFFER_WORD[name]:BUFFER_WORD[name] + 2] = (int(glob), off)


def _chain_words(spec: OpSpec, bp: BufferPlan) -> np.ndarray:
    """A fused chain's descriptor (:func:`chain_schedule`): a header (the
    stage and level counts, each level's first stage and tickets, the
    buffer placement words), then each stage's descriptor in level order,
    graph order within a level, on the re-pointed operands, with its
    tiling, its order word (2 for a staged terminal stage, else 0) and its
    first ticket and tickets in its level."""
    s = chain_schedule(spec)
    offs, _ = weight_offsets(spec)
    head = [0] * DESC_WORDS
    head[H_NS], head[H_NL] = len(s.stages), len(s.levels)
    needs = dict(_buffer_needs(spec))
    head[H_FP] = _round_up(needs["tile"], 16)
    head[H_TERM] = _round_up(needs.get("term", 0), 16)
    words, first = [head], 0
    for lv, lvl in enumerate(s.levels):
        t0 = 0
        for j in lvl:
            st, t = s.stages[j], s.tilings[j]
            if st.kind not in FUSED_STAGE_KINDS:
                raise NotImplementedError(
                    f"fused stage kind {st.kind!r} has no CUDA routine")
            w = _op_words(st, offs[j] or 0)
            w[D_ORDER] = EW_OVERLAP if s.staged and j in s.terminal else 0
            w[D_TILING:D_TILING + len(t)] = t
            w[D_T0], w[D_NT] = t0, s.items[j]
            t0 += s.items[j]
            words.append(w)
        head[H_LEVEL0 + 2 * lv:H_LEVEL0 + 2 * lv + 2] = first, t0
        first += len(lvl)
    _place(head, bp)
    return np.asarray([x for ws in words for x in ws], np.int32)


def descriptor(spec: OpSpec, device) -> torch.Tensor:
    """The spec's descriptor uploaded to ``device`` (callers cache it per
    spec, so repeated executions upload nothing)."""
    return torch.from_numpy(descriptor_words(spec)).to(device)


_DESCRIPTORS: "collections.OrderedDict" = collections.OrderedDict()


def _cached_descriptor(spec: OpSpec, device) -> torch.Tensor:
    """The descriptor of a wrapper called without one (the standalone
    entry points), uploaded once per spec and device and cached."""
    key = (spec, torch.device(device))
    t = _DESCRIPTORS.get(key)
    if t is None:
        t = _DESCRIPTORS[key] = descriptor(spec, device)
        while len(_DESCRIPTORS) > _WORKSPACE_CACHE:
            _DESCRIPTORS.popitem(last=False)
    return t


def pack_weights(spec: OpSpec, weights: Sequence[torch.Tensor],
                 device=None) -> torch.Tensor:
    """A fused chain's stage filters, in stage order, packed into one uint8
    blob at :func:`weight_offsets` (the layout the fused kernel reads), on
    ``device`` (default: the filters')."""
    offs, total = weight_offsets(spec)
    stages = [st for st in spec.stages if st.kind in WEIGHTED_KINDS]
    if len(weights) != len(stages):
        raise ValueError(f"fused chain takes {len(stages)} filters, got "
                         f"{len(weights)}")
    if device is None:
        device = weights[0].device if weights else "cpu"
    blob = torch.zeros(total, dtype=torch.uint8, device=device)
    for st, w, off in zip(stages, weights,
                          [o for o in offs if o is not None]):
        _check_weight(st, w)
        flat = w.contiguous().reshape(-1).view(torch.uint8)
        blob[off:off + flat.numel()].copy_(flat)
    return blob


def _check_weight(spec: OpSpec, w: torch.Tensor) -> None:
    want = torch.int8 if spec.dtype == "i8" else torch.float32
    if w is None or w.dtype != want or \
            tuple(w.shape) != _weight_shape(spec):
        got = None if w is None else (tuple(w.shape), w.dtype)
        raise ValueError(f"{spec.kind}: filter {got}, expected "
                         f"{_weight_shape(spec)} {want}")


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


class _FlatMem:
    """The flat byte arena (the reference's ``_FlatMem``): typed views at
    byte offsets. Given a fused chain's ``scratch``, operands whose stage
    flag is set resolve to it (the reference's ``_RoutedFlatMem``)."""

    def __init__(self, arena: torch.Tensor, spec: OpSpec,
                 scratch: Optional[torch.Tensor] = None):
        self.arena, self.spec, self.scratch = arena, spec, scratch
        self.q = spec.dtype == "i8"

    def _in_ref(self, i: int) -> torch.Tensor:
        flags = self.spec.in_scratch
        return self.scratch if flags and flags[i] else self.arena

    def _out_ref(self) -> torch.Tensor:
        return self.scratch if self.spec.out_scratch else self.arena

    def read_t(self, i: int) -> torch.Tensor:
        """A copy of input ``i`` in its view shape (whole-block ops read
        every input before they write)."""
        shape = self.spec.in_shape[i]
        return _typed(self._in_ref(i), self.spec.in_off[i], _elems(shape),
                      self.q).clone().reshape(shape)

    def read_row(self, i: int, iy: int) -> torch.Tensor:
        """Image row ``iy`` (W*C elements) of input ``i``, a view."""
        n = _elems(self.spec.in_shape[i][-2:])
        return _typed(self._in_ref(i),
                      self.spec.in_off[i] + iy * n * _isz(self.spec.dtype),
                      n, self.q)

    def write(self, y: torch.Tensor) -> None:
        _typed(self._out_ref(), self.spec.out_off, y.numel(),
               self.q).copy_(y.reshape(-1))

    def write_row(self, oy: int, y: torch.Tensor) -> None:
        n = y.numel()
        _typed(self._out_ref(), self.spec.out_off + oy * n
               * _isz(self.spec.dtype), n, self.q).copy_(y.reshape(-1))


class _BlockMem(_FlatMem):
    """The typed ``(rows, rowlen)`` arena (the reference's ``_BlockMem``
    with ``_dec_row``, ``_dec_block``, ``_enc_block`` and ``_pad_cols``;
    routed to a fused chain's typed scratch like ``_RoutedBlockMem``)."""

    def _row_slice(self, ref, row0: int, iy: int, triple, n: int):
        """A flat view of image row ``iy``'s ``n`` elements and of the
        arena elements its store covers (packed: just its lane phase)."""
        c, k, rl = triple
        L = self.spec.rowlen
        if c > 1:
            phase = (iy % c) * rl
            row = ref[row0 + iy // c, phase:phase + n]
            return row, row
        span = ref[row0 + iy * k:row0 + (iy + 1) * k].reshape(-1)
        return span[:n], span

    def read_t(self, i: int) -> torch.Tensor:
        spec = self.spec
        rows, used = spec.in_rows[i]
        shape = spec.in_shape[i]
        block = self._in_ref(i)[spec.in_off[i]:spec.in_off[i] + rows]
        _, k, rl = _triple(spec, i)
        if k > 1:
            flat = block.reshape(rows // k, k * spec.rowlen)[:, :rl]
        else:
            flat = block[:, :used]
        return flat.reshape(-1)[:_elems(shape)].clone().reshape(shape)

    def read_row(self, i: int, iy: int) -> torch.Tensor:
        n = _elems(self.spec.in_shape[i][-2:])
        return self._row_slice(self._in_ref(i), self.spec.in_off[i], iy,
                               _triple(self.spec, i), n)[0]

    def write(self, y: torch.Tensor) -> None:
        spec = self.spec
        rows, used = spec.out_rows
        L = spec.rowlen
        _, k, rl = _triple(spec, None)
        h, w = (rows // k, rl) if k > 1 else (rows, used)
        flat = torch.zeros(h * w, dtype=y.dtype, device=y.device)
        flat[:y.numel()] = y.reshape(-1)
        block = torch.zeros((h, k * L if k > 1 else L), dtype=y.dtype,
                            device=y.device)
        block[:, :w] = flat.reshape(h, w)
        self._out_ref()[spec.out_off:spec.out_off + rows] = \
            block.reshape(rows, L)

    def write_row(self, oy: int, y: torch.Tensor) -> None:
        row, span = self._row_slice(self._out_ref(), self.spec.out_off, oy,
                                    _triple(self.spec, None), y.numel())
        row.copy_(y.reshape(-1))
        span[y.numel():] = 0


def _mem(arena: torch.Tensor, spec: OpSpec,
         scratch: Optional[torch.Tensor] = None) -> _FlatMem:
    return (_BlockMem if spec.rowlen else _FlatMem)(arena, spec, scratch)


class _WindowMem(_BlockMem):
    """One output-row tile of a rolling streaming op (the reference's
    ``_StreamRollMem``): input arena row ``r`` is read at row ``r - base``
    of the fetched window, clamped into it as the reference's dynamic slice
    clamps; output arena row ``r`` of the operand is stored at row ``r -
    a0`` of the tile's output slot."""

    def __init__(self, win: torch.Tensor, slot: torch.Tensor, spec: OpSpec,
                 base: int, a0: int):
        super().__init__(slot, spec)
        self.win, self.base, self.a0 = win, base, a0

    def read_row(self, i: int, iy: int) -> torch.Tensor:
        c, k, rl = _triple(self.spec, i)
        n = _elems(self.spec.in_shape[i][-2:])
        span = 1 if c > 1 else k
        r = self.spec.in_off[i] - self.base + (iy // c if c > 1 else iy * k)
        r = min(max(r, 0), self.win.shape[0] - span)
        if c > 1:
            phase = (iy % c) * rl
            return self.win[r, phase:phase + n]
        return self.win[r:r + span].reshape(-1)[:n]

    def write_row(self, oy: int, y: torch.Tensor) -> None:
        row, span = self._row_slice(self.arena, -self.a0, oy,
                                    _triple(self.spec, None), y.numel())
        row.copy_(y.reshape(-1))
        span[y.numel():] = 0


def conv_plain(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
               scratch: Optional[torch.Tensor] = None) -> None:
    """conv2d / depthwise, rows ascending, each row's taps read before its
    store; taps at ``iy = oy*sh - ph + fy*dh`` outside the input count
    zero (after the zero-point shift in int8)."""
    _conv_rows(_mem(arena, spec, scratch), spec, w,
               range(spec.out_shape[-3]), arena.device)


def _conv_rows(mem: _FlatMem, spec: OpSpec, w: torch.Tensor, rows,
               dev: torch.device) -> None:
    """conv_plain's output rows ``rows`` through the accessor ``mem``."""
    ih, iw, ic, oh, ow, oc = _row_geometry(spec)
    kh, kw, sh, sw, dh, dw, ph, pw, mult = spec.meta
    q = spec.dtype == "i8"
    wt = w.to(torch.int32) if q else w
    if q:
        x_zp, amult, y_zp = spec.qmeta
    cols = torch.arange(ow, device=dev)
    for oy in rows:
        acc = torch.zeros((ow, oc), dtype=torch.int32 if q else torch.float32,
                          device=dev)
        for fy in range(kh):
            iy = oy * sh - ph + fy * dh
            if not 0 <= iy < ih:
                continue
            row = mem.read_row(0, iy).reshape(iw, ic)
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
        mem.write_row(oy, _requant(acc, amult, y_zp) if q else acc)


def pool_plain(arena: torch.Tensor, spec: OpSpec,
               scratch: Optional[torch.Tensor] = None) -> None:
    """max pool (mode "max") or average pool (any other mode, as in the
    reference), rows ascending like conv; avg divides by the valid taps;
    ``ph``/``pw`` are the leading pads (TF SAME pads unevenly)."""
    _pool_rows(_mem(arena, spec, scratch), spec, range(spec.out_shape[-3]),
               arena.device)


def _pool_rows(mem: _FlatMem, spec: OpSpec, rows, dev: torch.device) -> None:
    """pool_plain's output rows ``rows`` through the accessor ``mem``."""
    ih, iw, c, oh, ow, _ = _row_geometry(spec)
    kh, kw, sh, sw, ph, pw, mode = spec.meta
    is_max = mode == "max"
    q = spec.dtype == "i8"
    cols = torch.arange(ow, device=dev)
    for oy in rows:
        if q:
            acc = torch.full((ow, c), -2147483647 if is_max else 0,
                             dtype=torch.int32, device=dev)
        else:
            acc = torch.full((ow, c), -float("inf") if is_max else 0.0,
                             dtype=torch.float32, device=dev)
        cnt = torch.zeros((ow, 1), dtype=torch.float32, device=dev)
        for fy in range(kh):
            iy = oy * sh - ph + fy
            if not 0 <= iy < ih:
                continue
            row = mem.read_row(0, iy).reshape(iw, c)
            if q:
                row = row.to(torch.int32)
            for fx in range(kw):
                ix = cols * sw - pw + fx
                valid = ((ix >= 0) & (ix < iw))[:, None]
                taps = row[ix.clamp(0, iw - 1)]
                if is_max:
                    acc = torch.where(valid, torch.maximum(acc, taps), acc)
                else:
                    acc = acc + torch.where(valid, taps,
                                            torch.zeros((), dtype=acc.dtype))
                    cnt = cnt + valid.to(torch.float32)
        if q:
            x_zp, amult, y_zp = spec.qmeta
            val = (acc - x_zp if is_max else
                   acc.to(torch.float32) / cnt.clamp_min(1.0) - x_zp)
            out = _requant(val, amult, y_zp)
        else:
            out = acc if is_max else acc / cnt.clamp_min(1.0)
        mem.write_row(oy, out)


#: torch mirrors of the reference's _ELEMENTWISE table (same maths).
ELEMENTWISE_TORCH = {
    "relu": lambda a: torch.clamp_min(a, 0.0),
    "relu6": lambda a: torch.clamp(a, 0.0, 6.0),
    "sigmoid": lambda a: 1.0 / (1.0 + torch.exp(-a)),
    "identity": lambda a: a,
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "sub": lambda a, b: a - b,
}


def elementwise_plain(arena: torch.Tensor, spec: OpSpec,
                      scratch: Optional[torch.Tensor] = None) -> None:
    """Every operand read (int8: dequantised at its params), the second
    broadcast when its element count differs, then the f32 result written
    (int8: quantised at the output's params)."""
    bcast = _ew_broadcast(spec)[0]
    q = spec.dtype == "i8"
    mem = _mem(arena, spec, scratch)
    xs = [mem.read_t(i) for i in range(len(spec.in_shape))]
    if q:
        in_q, (ys, yzp) = spec.qmeta
        xs = [_dequant(x, s, zp) for x, (s, zp) in zip(xs, in_q)]
    if bcast:
        xs[1] = torch.broadcast_to(xs[1], xs[0].shape)
    v = ELEMENTWISE_TORCH[spec.meta[0]](*xs).to(torch.float32)
    mem.write(_quant(v, ys, yzp) if q else v)


def matmul_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    """(M, K) x (K, N) of two arena operands; int8 with two zero points."""
    m, k, n = _matmul_geometry(spec)
    mem = _mem(arena, spec)
    a = mem.read_t(0).reshape(m, k)
    b = mem.read_t(1)
    if spec.dtype == "i8":
        a_zp, b_zp, amult, y_zp = spec.qmeta
        acc = ((a.to(torch.int32) - a_zp)[:, :, None]
               * (b.to(torch.int32) - b_zp)[None]).sum(1, dtype=torch.int32)
        y = _requant(acc, amult, y_zp)
    else:
        y = a @ b
    mem.write(y)


def pad_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    """Constant pad: 0 in f32; int8 pads with x_zp, then rescales the
    padded tensor to the output's params."""
    _pad_geometry(spec)
    q = spec.dtype == "i8"
    mem = _mem(arena, spec)
    x = mem.read_t(0)
    fill = spec.qmeta[0][0] if q else 0
    y = torch.full(tuple(spec.out_shape), fill, dtype=x.dtype,
                   device=arena.device)
    y[tuple(slice(lo, lo + n) for (lo, _), n in
            zip(spec.meta[0], x.shape))] = x
    if q:
        (x_zp, mult), (y_zp,) = spec.qmeta
        y = _requant(y.to(torch.int32) - x_zp, mult, y_zp)
    mem.write(y)


def mean_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    q = spec.dtype == "i8"
    shape = tuple(spec.in_shape[0])
    mem = _mem(arena, spec)
    x = mem.read_t(0)
    axes = tuple(sorted(a % len(shape) for a in spec.meta[0]))
    if q:
        x_zp, amult, y_zp = spec.qmeta
        cnt = _elems(shape[a] for a in axes)
        acc = x.to(torch.int32).sum(dim=axes, dtype=torch.int32)
        y = _requant(acc.to(torch.float32) / _f32(cnt) - x_zp, amult, y_zp)
    else:
        y = x.mean(dim=axes)
    mem.write(y)


def fully_connected_plain(arena: torch.Tensor, spec: OpSpec,
                          w: torch.Tensor) -> None:
    q = spec.dtype == "i8"
    idim = spec.in_shape[0][-1]
    mem = _mem(arena, spec)
    x = mem.read_t(0).reshape(-1, idim)
    if q:
        x_zp, amult, y_zp = spec.qmeta
        acc = ((x.to(torch.int32) - x_zp)[:, :, None]
               * w.to(torch.int32)[None]).sum(1, dtype=torch.int32)
        y = _requant(acc, amult, y_zp)
    else:
        y = x @ w
    mem.write(y)


def softmax_plain(arena: torch.Tensor, spec: OpSpec) -> None:
    q = spec.dtype == "i8"
    last = spec.in_shape[0][-1]
    mem = _mem(arena, spec)
    x = mem.read_t(0).reshape(-1, last)
    if q:
        (xs, xzp), (ys, yzp) = spec.qmeta
        x = _dequant(x, xs, xzp)
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    y = e / e.sum(dim=-1, keepdim=True)
    mem.write(_quant(y, ys, yzp) if q else y)


def concat_plain(arena: torch.Tensor, spec: OpSpec,
                 scratch: Optional[torch.Tensor] = None) -> None:
    """concat along ``meta[0]``, int8 inputs rescaled to the output's
    params; every input is read before the output is written."""
    mem = _mem(arena, spec, scratch)
    xs = [mem.read_t(i) for i in range(len(spec.in_shape))]
    if spec.dtype == "i8":
        in_q, (y_zp,) = spec.qmeta
        xs = [_requant(x.to(torch.int32) - zp, mult, y_zp)
              for x, (zp, mult) in zip(xs, in_q)]
    mem.write(torch.cat(xs, dim=spec.meta[0]))


def _scratch(spec: OpSpec, device) -> torch.Tensor:
    """A fused chain's zeroed scratch: ``scratch_rows`` bytes (flat) or a
    typed ``(scratch_rows, rowlen)`` block (row-blocked)."""
    if not spec.rowlen:
        return torch.zeros(spec.scratch_rows, dtype=torch.uint8,
                           device=device)
    return torch.zeros((spec.scratch_rows, spec.rowlen),
                       dtype=_TORCH_DTYPE[spec.dtype], device=device)


def fused_chain_plain(arena: torch.Tensor, spec: OpSpec,
                      wblob: torch.Tensor) -> None:
    """Every stage in order against the arena and a scratch buffer; stage
    filters come from the packed blob (:func:`pack_weights`)."""
    _run_stages(arena, spec, wblob, _scratch(spec, arena.device))


def _run_stages(arena: torch.Tensor, spec: OpSpec, wblob: torch.Tensor,
                scratch: torch.Tensor) -> None:
    offs, _ = weight_offsets(spec)
    for st, off in zip(spec.stages, offs):
        _run_stage(arena, st, wblob, off, scratch)


def _run_stage(arena: torch.Tensor, st: OpSpec, wblob: torch.Tensor,
               off: Optional[int], scratch: torch.Tensor) -> None:
    """One chain stage's plain version; its filter at byte ``off`` of the
    blob, its flagged operands in ``scratch``."""
    if st.kind == "concat":
        concat_plain(arena, st, scratch)
    elif st.kind == "elementwise":
        elementwise_plain(arena, st, scratch)
    elif st.kind == "pool":
        pool_plain(arena, st, scratch)
    else:
        shape = _weight_shape(st)
        w = _typed(wblob, off, _elems(shape),
                   st.dtype == "i8").reshape(shape)
        conv_plain(arena, st, w, scratch)


def stream_roll_plain(arena: torch.Tensor, spec: OpSpec,
                      w: Optional[torch.Tensor] = None) -> None:
    """A rolling streaming conv, depthwise or pool: per output-row tile
    ``t``, ``win_in`` arena rows from ``win_starts[t]`` are copied into a
    window and the tile's output arena rows into a slot, the tile's rows
    ``[t*tr, min((t+1)*tr, oh))`` are computed from the window into the
    slot, and the slot is copied back; tiles ascending."""
    _check_stream(spec, arena.shape[0])
    body = _stream_body(spec)
    tr, tile_ar = _tile_geom(spec)
    win_in = spec.win_rows - tile_ar
    oh = spec.out_shape[-3]
    for t, start in enumerate(spec.win_starts):
        y0, y1 = t * tr, min((t + 1) * tr, oh)
        a0, a1 = _tile_rows(spec, y0, y1)
        dst = slice(spec.out_off + a0, spec.out_off + a1)
        mem = _WindowMem(arena[start:start + win_in].clone(),
                         arena[dst].clone(), body, start, a0)
        if spec.kind == "pool":
            _pool_rows(mem, body, range(y0, y1), arena.device)
        else:
            _conv_rows(mem, body, w, range(y0, y1), arena.device)
        arena[dst] = mem.arena


def stream_stage_plain(arena: torch.Tensor, spec: OpSpec,
                       w: Optional[torch.Tensor] = None) -> None:
    """A staged streaming op: its blocked plain version on the arena, in
    place as the kernel runs it (:func:`runs_in_place`). The reference
    copies every operand block into its window slot
    (:func:`~repro_torch.core.planner.staged_slots`), runs there and copies
    the output block back; every block is read before the output is
    written in both, so the arenas agree."""
    _check_stream(spec, arena.shape[0])
    apply_plain(arena, _blocked(spec), w)


def stream_fused_plain(arena: torch.Tensor, spec: OpSpec,
                       wblob: torch.Tensor) -> None:
    """A streaming band chain: the external input blocks copied into their
    scratch slots (``in_slots``), every stage run inside the scratch, the
    terminal output block (``out_slot``) copied back."""
    _check_stream(spec, arena.shape[0])
    body = _stream_body(spec)
    scratch = _scratch(body, arena.device)
    for off, slot, (rows, _) in zip(spec.in_off, spec.in_slots,
                                    spec.in_rows):
        scratch[slot:slot + rows] = arena[off:off + rows]
    _run_stages(scratch, body, wblob, scratch)
    rows = spec.out_rows[0]
    arena[spec.out_off:spec.out_off + rows] = \
        scratch[spec.out_slot:spec.out_slot + rows]


def apply_plain(arena: torch.Tensor, spec: OpSpec,
                w: Optional[torch.Tensor] = None) -> None:
    """The plain version of any lowered spec, on the arena's device (the
    yardstick the card's kernels are held against)."""
    form = stream_form(spec)
    if form is not None:
        _STREAM_PLAIN[form](arena, spec, w)
        return
    k = spec.kind
    if k in ("conv2d", "depthwise_conv2d"):
        conv_plain(arena, spec, w)
    elif k == "fully_connected":
        fully_connected_plain(arena, spec, w)
    elif k == "fused":
        fused_chain_plain(arena, spec, w)
    elif k in _UNWEIGHTED_PLAIN:
        _UNWEIGHTED_PLAIN[k](arena, spec)
    else:
        raise NotImplementedError(f"op kind {k!r} has no plain version")


_UNWEIGHTED_PLAIN = {"pool": pool_plain, "elementwise": elementwise_plain,
                     "matmul": matmul_plain, "pad": pad_plain,
                     "concat": concat_plain, "mean": mean_plain,
                     "softmax": softmax_plain}
_STREAM_PLAIN = {"roll": stream_roll_plain, "stage": stream_stage_plain,
                 "fused": stream_fused_plain}


# ---------------------------------------------------------------------------
# Wrappers: checks, then the plain version on a CPU arena or the kernel on
# a CUDA arena
# ---------------------------------------------------------------------------


def _on_card(arena: torch.Tensor, spec: OpSpec, *tensors) -> bool:
    """Check the operands; True when the kernel must launch (CUDA arena),
    False for the plain version (CPU arena). The flat program takes a
    contiguous 1-D uint8 arena, the row-blocked one a contiguous typed
    ``(rows, spec.rowlen)`` arena of the spec's tier; a streaming spec
    must also fit that arena (:func:`_check_stream`)."""
    if not spec.rowlen and not spec.win_rows:
        if arena.dtype != torch.uint8 or arena.dim() != 1 \
                or not arena.is_contiguous():
            raise ValueError("the flat arena must be a contiguous 1-D uint8 "
                             "tensor")
    elif arena.dtype != _TORCH_DTYPE[spec.dtype] or arena.dim() != 2 \
            or arena.shape[1] != spec.rowlen or not arena.is_contiguous():
        raise ValueError(
            f"the row-blocked arena must be a contiguous (rows, "
            f"{spec.rowlen}) {_TORCH_DTYPE[spec.dtype]} tensor, got "
            f"{tuple(arena.shape)} {arena.dtype}")
    if spec.win_rows:
        _check_stream(spec, arena.shape[0])
    if arena.numel() * arena.element_size() >= 2 ** 31:
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


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (``"cpu"``, the plain versions) or for ``"meta"`` (shapes
    only, the dry run's: the plain versions on tensors without data);
    None without a card raises rather than fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the kernels run on the card and no CUDA device is "
                "visible; pass device='cpu' to run the kernels' plain "
                "PyTorch versions instead")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "visible")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the kernels run on 'cuda', 'cpu' or 'meta', not "
                         f"{dev}")
    return dev


def _expect(spec: OpSpec, name: str) -> None:
    if kernel_of(spec) != name:
        form = stream_form(spec)
        raise ValueError(f"{name} cannot run {spec.kind!r}"
                         + (f" in the streaming program ({form})" if form
                            else ""))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, arena: torch.Tensor, spec: OpSpec,
            w: Optional[torch.Tensor], desc: Optional[torch.Tensor],
            grid: Tuple[int, int, int]) -> None:
    """Launch kernel ``name`` on the arena's current stream and count it;
    ``grid``: the launch-shape arguments of a kernel over the whole card
    (:data:`build.GRID_ARGTYPES`)."""
    from repro_torch.kernels import build
    if desc is None:
        desc = _cached_descriptor(spec, arena.device)
    elif desc.dtype != torch.int32 or desc.device != arena.device:
        raise ValueError("descriptor must be int32 on the arena's device")
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    build.check(build.entry(name)(
        arena.data_ptr(), desc.data_ptr(), _ptr(w),
        _ptr(workspace(spec, arena.device)), buffer_plan(spec).smem, *grid,
        stream), name)
    LAUNCHES[name] += 1


def conv_grid(spec: OpSpec) -> Tuple[int, int, int]:
    """(CTAs to launch at most, tiles that must run at once, counter bytes)
    of a tile kernel's spec: one CTA a tile, or one a global staging
    slice; the kernel's entry point lowers the count to the CTAs the card
    holds at once, which must cover one row's tiles (a rolling spec of
    order :data:`ORDER_ROWS`: one streaming tile's), and zeroes the
    counters."""
    tl = conv_tiling(spec)
    glob = buffer_plan(spec).on_global("tile")
    group = tl.tpr
    if stream_form(spec) == "roll" and conv_order(spec) == ORDER_ROWS:
        group *= min(_tile_geom(spec)[0], spec.out_shape[-3])
    return (min(tl.ntiles, CONV_SLICES) if glob else tl.ntiles, group,
            conv_counter_bytes(spec))


def arena_conv(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
               desc: Optional[torch.Tensor] = None) -> None:
    """conv2d / depthwise_conv2d in place on the arena."""
    _expect(spec, "arena_conv")
    _check_weight(spec, w)
    if not _on_card(arena, spec, w):
        conv_plain(arena, spec, w)
        return
    _launch("arena_conv", arena, spec, w, desc, conv_grid(spec))


def arena_pool(arena: torch.Tensor, spec: OpSpec,
               desc: Optional[torch.Tensor] = None) -> None:
    """max / avg pool in place on the arena, over the whole card in row
    tiles (:func:`conv_tiling`, :func:`conv_order`)."""
    _expect(spec, "arena_pool")
    if not _on_card(arena, spec):
        pool_plain(arena, spec)
        return
    _launch("arena_pool", arena, spec, None, desc, conv_grid(spec))


def _check_ew_arena(arena: torch.Tensor) -> None:
    """A chunk walk's 16-byte units and a matmul's 16-byte loads of b need
    the arena at a 16-byte boundary (every allocation is; a view into one
    need not be)."""
    if arena.data_ptr() % 16:
        raise ValueError("the chunk walk and the matmul need an arena that "
                         "starts at a 16-byte boundary")


def arena_elementwise(arena: torch.Tensor, spec: OpSpec,
                      desc: Optional[torch.Tensor] = None) -> None:
    """relu, relu6, sigmoid, identity, add, mul or sub on the arena, over
    the whole card (:func:`ew_tiling`, :func:`ew_order`)."""
    _expect(spec, "arena_elementwise")
    _ew_broadcast(spec)
    if not _on_card(arena, spec):
        elementwise_plain(arena, spec)
        return
    _check_ew_arena(arena)
    _launch("arena_elementwise", arena, spec, None, desc, chunk_grid(spec))


def arena_matmul(arena: torch.Tensor, spec: OpSpec,
                 desc: Optional[torch.Tensor] = None) -> None:
    """(M, K) x (K, N) of two arena operands, over the whole card on the
    fully connected grid (:func:`fc_tiling`, :func:`matmul_order`)."""
    _expect(spec, "arena_matmul")
    _matmul_geometry(spec)
    if not _on_card(arena, spec):
        matmul_plain(arena, spec)
        return
    _check_ew_arena(arena)
    _launch("arena_matmul", arena, spec, None, desc, fc_grid(spec))


def arena_pad(arena: torch.Tensor, spec: OpSpec,
              desc: Optional[torch.Tensor] = None) -> None:
    """Constant pad (then, int8, rescale) on the arena, over the whole
    card (:func:`pad_tiling`, :func:`pad_order`)."""
    _expect(spec, "arena_pad")
    _pad_geometry(spec)
    if not _on_card(arena, spec):
        pad_plain(arena, spec)
        return
    _check_ew_arena(arena)
    _launch("arena_pad", arena, spec, None, desc, chunk_grid(spec))


def arena_concat(arena: torch.Tensor, spec: OpSpec,
                 desc: Optional[torch.Tensor] = None) -> None:
    """A standalone concat (int8 inputs rescaled) on the arena, over the
    whole card (:func:`concat_tiling`, :func:`concat_order`)."""
    _expect(spec, "arena_concat")
    if len(spec.in_shape) > MAX_CAT:
        raise ValueError(f"concat of {len(spec.in_shape)} inputs exceeds "
                         f"{MAX_CAT}")
    if not _on_card(arena, spec):
        concat_plain(arena, spec)
        return
    _check_ew_arena(arena)
    _launch("arena_concat", arena, spec, None, desc, chunk_grid(spec))


def arena_mean(arena: torch.Tensor, spec: OpSpec,
               desc: Optional[torch.Tensor] = None) -> None:
    """A mean over axes on the arena, one output a thread over the whole
    card (:func:`mean_tiling`, :func:`mean_order`)."""
    _expect(spec, "arena_mean")
    _mean_geometry(spec)
    if not _on_card(arena, spec):
        mean_plain(arena, spec)
        return
    _launch("arena_mean", arena, spec, None, desc, chunk_grid(spec))


def arena_fully_connected(arena: torch.Tensor, spec: OpSpec, w: torch.Tensor,
                          desc: Optional[torch.Tensor] = None) -> None:
    """y = x . W on the arena, over the whole card (:func:`fc_tiling`,
    :func:`fc_order`)."""
    _expect(spec, "arena_fully_connected")
    _check_weight(spec, w)
    if not _on_card(arena, spec, w):
        fully_connected_plain(arena, spec, w)
        return
    _launch("arena_fully_connected", arena, spec, w, desc, fc_grid(spec))


def arena_softmax(arena: torch.Tensor, spec: OpSpec,
                  desc: Optional[torch.Tensor] = None) -> None:
    """Softmax over the last axis on the arena, its rows over the whole
    card (:func:`softmax_tiling`, :func:`softmax_order`)."""
    _expect(spec, "arena_softmax")
    _softmax_geometry(spec)
    if not _on_card(arena, spec):
        softmax_plain(arena, spec)
        return
    _launch("arena_softmax", arena, spec, None, desc, softmax_grid(spec))


def _check_chain(spec: OpSpec, wblob: torch.Tensor) -> None:
    if wblob is None or wblob.dtype != torch.uint8 or \
            wblob.numel() != weight_offsets(spec)[1]:
        raise ValueError("wblob must be the chain's packed uint8 filters")
    for st in spec.stages:
        if st.kind not in FUSED_STAGE_KINDS:
            raise NotImplementedError(
                f"fused stage kind {st.kind!r} has no CUDA routine")
        if st.kind == "elementwise":
            _ew_broadcast(st)
    chain_schedule(spec)


def arena_fused_chain(arena: torch.Tensor, spec: OpSpec, wblob: torch.Tensor,
                      desc: Optional[torch.Tensor] = None) -> None:
    """A fused band chain in one launch over the whole card, its stages in
    levels (:func:`chain_schedule`); ``wblob`` is :func:`pack_weights`'
    blob of the stage filters."""
    _expect(spec, "arena_fused_chain")
    _check_chain(spec, wblob)
    if not _on_card(arena, spec, wblob):
        fused_chain_plain(arena, spec, wblob)
        return
    _check_ew_arena(arena)
    _launch("arena_fused_chain", arena, spec, wblob, desc, chain_grid(spec))


def arena_stream_roll(arena: torch.Tensor, spec: OpSpec,
                      w: Optional[torch.Tensor] = None,
                      desc: Optional[torch.Tensor] = None) -> None:
    """A conv2d, depthwise or pool of the streaming program, its rows read
    through their streaming tile's window (``w``: the filter; None for
    pool)."""
    _expect(spec, "arena_stream_roll")
    if spec.kind != "pool":
        _check_weight(spec, w)
    if not _on_card(arena, spec, w):
        stream_roll_plain(arena, spec, w)
        return
    _launch("arena_stream_roll", arena, spec, w, desc, conv_grid(spec))


def arena_stream_stage(arena: torch.Tensor, spec: OpSpec,
                       w: Optional[torch.Tensor] = None,
                       desc: Optional[torch.Tensor] = None) -> None:
    """A whole-block op of the streaming program (``w``: a fully connected
    op's filter) in place on the arena over the whole card: the grid
    bodies of :func:`arena_elementwise`, :func:`arena_concat`,
    :func:`arena_mean`, :func:`arena_pad`, :func:`arena_fully_connected`,
    :func:`arena_matmul` and :func:`arena_softmax`."""
    _expect(spec, "arena_stream_stage")
    if spec.kind == "fully_connected":
        _check_weight(spec, w)
    if not _on_card(arena, spec, w):
        stream_stage_plain(arena, spec, w)
        return
    if runs_chunk_walk(spec) or spec.kind == "matmul":
        _check_ew_arena(arena)
    if runs_chunk_walk(spec):
        grid = chunk_grid(spec)
    elif runs_product_grid(spec):
        grid = fc_grid(spec)
    else:
        grid = softmax_grid(spec)
    _launch("arena_stream_stage", arena, spec, w, desc, grid)


def arena_stream_fused(arena: torch.Tensor, spec: OpSpec,
                       wblob: torch.Tensor,
                       desc: Optional[torch.Tensor] = None) -> None:
    """A fused band chain of the streaming program, on the same grid as
    :func:`arena_fused_chain`: its external inputs read and its output
    written in place on the arena, no window (:func:`chain_schedule`);
    ``wblob`` is :func:`pack_weights`' blob of the stage filters."""
    _expect(spec, "arena_stream_fused")
    _check_chain(spec, wblob)
    if not _on_card(arena, spec, wblob):
        stream_fused_plain(arena, spec, wblob)
        return
    _check_ew_arena(arena)
    _launch("arena_stream_fused", arena, spec, wblob, desc, chain_grid(spec))


_WRAPPERS = {"pool": arena_pool, "elementwise": arena_elementwise,
             "matmul": arena_matmul, "pad": arena_pad,
             "concat": arena_concat, "mean": arena_mean,
             "softmax": arena_softmax}
_STREAM_WRAPPERS = {"roll": arena_stream_roll, "stage": arena_stream_stage,
                    "fused": arena_stream_fused}


def apply_op(arena: torch.Tensor, spec: OpSpec,
             w: Optional[torch.Tensor] = None,
             desc: Optional[torch.Tensor] = None) -> None:
    """Run one lowered op in place on the arena through its wrapper. ``w``
    is the filter of a weighted op, or a fused chain's packed blob. A
    streaming spec (``win_rows > 0``) goes to its form's wrapper."""
    form = stream_form(spec)
    if form is not None:
        _STREAM_WRAPPERS[form](arena, spec, w, desc)
        return
    k = spec.kind
    if k in ("conv2d", "depthwise_conv2d"):
        arena_conv(arena, spec, w, desc)
    elif k == "fully_connected":
        arena_fully_connected(arena, spec, w, desc)
    elif k == "fused":
        arena_fused_chain(arena, spec, w, desc)
    elif k in _WRAPPERS:
        _WRAPPERS[k](arena, spec, desc)
    else:
        raise NotImplementedError(f"op kind {k!r} has no CUDA kernel")
