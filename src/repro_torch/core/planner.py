"""Tensor-arena planners (paper §II.D + §IV).

Strategies:

- ``naive``          — classic greedy heap in execution order (allocate at
                       first use, free at last use, lowest-address-first).
                       This is the "Original" column of Table III.
- ``modified_heap``  — the paper's heuristic ordering: repeatedly allocate,
                       out of the frontier of unallocated tensors whose scope
                       overlaps an allocated one, the tensor that heap-packs
                       lowest. Forwards or backwards.
- ``dmo``            — modified heap, *backwards* (reverse execution order),
                       with the diagonal overlap relaxation: an op's input may
                       overlap the tail of the op's output by ``O_s`` bytes.

All planners return a :class:`Plan` mapping storage tensors to byte offsets,
with the peak arena size and a safety validator.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from repro_torch.core.graph import Graph, Op, Tensor, op_pads
from repro_torch.core import overlap as overlap_mod

OverlapFn = Callable[[Op, int], int]


def _default_overlap(method: str = "auto", profile: str = "paper") -> OverlapFn:
    return lambda op, idx: overlap_mod.safe_overlap(op, idx, method=method,
                                                    profile=profile)


@dataclasses.dataclass(frozen=True)
class TensorLayout:
    """Byte-granular placement of one arena tensor view: the dtype width, the
    byte offset the planner chose for its storage, and the (derived) element
    offset. This is the layout contract between the planner and the executor
    backends — kernels index the flat *byte* arena with it, so mixed-dtype
    plans (int8 next to f32) need no implicit element size."""

    name: str
    shape: Tuple[int, ...]
    dtype_bytes: int
    byte_offset: int

    @property
    def elem_offset(self) -> int:
        return self.byte_offset // self.dtype_bytes

    @property
    def elems(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def nbytes(self) -> int:
        return self.elems * self.dtype_bytes


@dataclasses.dataclass(frozen=True)
class OpLayout:
    """Lowering record for one executed op: the op plus the layout of every
    data input (``None`` for non-arena weight inputs) and of the output."""

    op: Op
    inputs: Tuple[Optional[TensorLayout], ...]
    output: TensorLayout


@dataclasses.dataclass
class Plan:
    graph: Graph
    order: List[Op]
    offsets: Dict[Tensor, int]
    overlaps: Dict[Tuple[int, int], int]  # (op index, input index) -> O_s bytes
    strategy: str = ""

    def __getstate__(self):
        # derived state (the memoised default-tiling legalisation) must not
        # inflate pickled plans (disk plan cache)
        d = dict(self.__dict__)
        d.pop("_block_cache", None)
        d.pop("_window_cache", None)
        return d

    @property
    def peak_bytes(self) -> int:
        return max((off + t.nbytes for t, off in self.offsets.items()), default=0)

    def peak_bytes_by_dtype(self) -> Dict[int, int]:
        """Arena peak extent per dtype width (bytes): for each dtype, the
        highest end offset of any tensor of that width. Sums need not equal
        ``peak_bytes`` — dtypes share the one arena and may interleave."""
        out: Dict[int, int] = {}
        for t, off in self.offsets.items():
            out[t.dtype_bytes] = max(out.get(t.dtype_bytes, 0), off + t.nbytes)
        return out

    _DTYPE_NAMES = {1: "i8", 2: "f16", 4: "f32"}

    def dtype_peaks_report(self) -> str:
        """Human-readable per-dtype peaks, e.g. ``"i8:64KB"`` or
        ``"i8:1KB+f32:12KB"`` (the single formatter the benchmarks share)."""
        return "+".join(
            f"{self._DTYPE_NAMES.get(db, f'{db}B')}:{peak / 1024:.0f}KB"
            for db, peak in sorted(self.peak_bytes_by_dtype().items()))

    def offset_of(self, t: Tensor) -> int:
        return self.offsets[t.storage()]

    def _layout(self, t: Tensor) -> TensorLayout:
        s = t.storage()
        off = self.offsets[s]
        assert off % s.dtype_bytes == 0, \
            f"{s.name}: byte offset {off} not {s.dtype_bytes}-byte aligned"
        return TensorLayout(s.name, tuple(t.shape), s.dtype_bytes, off)

    def op_layouts(self) -> List[OpLayout]:
        """Flat-arena lowering metadata, one :class:`OpLayout` per executed op
        in order. Layouts carry per-tensor ``dtype_bytes`` alongside byte and
        element offsets, so backends execute mixed-dtype plans over a single
        flat byte arena. Aliases resolve to their storage owner, weight inputs
        (which live outside the arena) yield ``None``, and aliasing no-ops
        (``reshape``) are omitted — they move no bytes. Every offset is
        asserted ``dtype_bytes``-aligned (the placement invariant
        :func:`_lowest_feasible` maintains)."""
        out: List[OpLayout] = []
        for op in self.order:
            if op.kind == "reshape":
                continue
            ins: List[Optional[TensorLayout]] = []
            for t in op.inputs:
                if t.storage().kind == "weight":
                    ins.append(None)
                    continue
                ins.append(self._layout(t))
            out.append(OpLayout(op, tuple(ins), self._layout(op.output)))
        return out

    def validate(self, granularity: int = 1) -> None:
        """Assert no live value can be clobbered under the overlap rules.

        ``granularity`` is the clobber unit in bytes: 1 checks the paper's
        byte-granular invariant; a unit > 1 additionally requires every
        offset to be unit-aligned, rounds sizes up to whole units, and
        rounds an overlap's required input/output distance (``|out| -
        O_s``) *up* to whole units — the conservative direction for a
        runtime that clobbers whole blocks. Note this pads *byte* sizes,
        i.e. it models densely packed tensors; :class:`BlockPlan` overrides
        with the exact per-tensor row footprints."""
        g = max(1, int(granularity))
        pad = lambda n: -(-n // g) * g
        scopes = self.graph.scopes(self.order)
        tensors = list(self.offsets)
        if g > 1:
            for t in tensors:
                if self.offsets[t] % g:
                    raise AssertionError(
                        f"{t.name}: offset {self.offsets[t]} not aligned to "
                        f"the {g}-byte row")
        for i, a in enumerate(tensors):
            sa, ea = scopes[a]
            xa, na = self.offsets[a], pad(a.nbytes)
            for b in tensors[i + 1:]:
                sb, eb = scopes[b]
                if ea < sb or eb < sa:
                    continue  # time-disjoint
                xb, nb = self.offsets[b], pad(b.nbytes)
                if xa + na <= xb or xb + nb <= xa:
                    continue  # space-disjoint
                os_ = self._allowed_overlap(a, b, scopes)
                if os_ is None:
                    raise AssertionError(
                        f"plan clobbers: {a.name}@{xa} vs {b.name}@{xb}")
                inp, outp = os_
                xi, xo = self.offsets[inp], self.offsets[outp]
                dist = pad(outp.nbytes - os_bytes(self, inp, outp))
                if xi < xo + dist:
                    raise AssertionError(
                        f"overlap beyond O_s: {inp.name}@{xi} vs {outp.name}@{xo}")

    def _allowed_overlap(self, a: Tensor, b: Tensor, scopes):
        """If (a, b) are an (input, output) pair of some op with a recorded
        O_s, return them ordered (input, output); else None."""
        for (oi, ii), _ in self.overlaps.items():
            op = self.order[oi]
            inp = op.inputs[ii].storage()
            outp = op.output.storage()
            if {inp, outp} == {a, b}:
                return inp, outp
        return None

    def report(self) -> str:
        lines = [f"# plan {self.strategy}: peak {self.peak_bytes} bytes"]
        scopes = self.graph.scopes(self.order)
        for t in sorted(self.offsets, key=lambda t: self.offsets[t]):
            s, e = scopes[t]
            lines.append(
                f"  {t.name:32s} off={self.offsets[t]:>10d} size={t.nbytes:>10d}"
                f" scope=[{s},{e}]")
        return "\n".join(lines)


def os_bytes(plan: Plan, inp: Tensor, outp: Tensor) -> int:
    for (oi, ii), v in plan.overlaps.items():
        op = plan.order[oi]
        if op.inputs[ii].storage() is inp and op.output.storage() is outp:
            return v
    return 0


# ---------------------------------------------------------------------------
# Row-blocked (tiled) layout legalisation
# ---------------------------------------------------------------------------

#: Per-dtype-width VMEM tile (sublanes, lanes): the minor arena axis must be
#: a lanes multiple and row offsets land on sublane-tile boundaries — the
#: (8, 128) f32 / (32, 128) int8 native TPU tilings.
TPU_TILES: Dict[int, Tuple[int, int]] = {4: (8, 128), 2: (16, 128),
                                         1: (32, 128)}

#: Op kinds whose kernels stream output rows (and therefore read/write the
#: arena one whole row at a time — the shapes the row-granular O_s covers).
_ROW_STREAMING_KINDS = frozenset({"conv2d", "depthwise_conv2d", "pool"})


def pack_geometry(rowlen: int, arena_rowlen: int) -> Tuple[int, int]:
    """Packed addressing geometry ``(cols_per_row, row_span)`` for an image
    row of ``rowlen`` elements in an arena of ``arena_rowlen``-element rows:
    narrow image rows pack ``cols_per_row`` per arena row; an image row wider
    than the arena row spans ``row_span`` consecutive arena rows. Exactly one
    of the two factors exceeds 1 (both are 1 when ``rowlen`` fills the arena
    row)."""
    if rowlen <= arena_rowlen:
        return max(1, arena_rowlen // rowlen), 1
    return 1, -(-rowlen // arena_rowlen)


def _ar_of(r: int, c: int, k: int) -> int:
    """First arena row (block-relative) holding image row ``r`` under the
    packed geometry ``(c, k)``."""
    return r // c if c > 1 else r * k


def _ar_top(r: int, c: int, k: int) -> int:
    """Last arena row (block-relative) image row ``r`` touches."""
    return r // c if c > 1 else (r + 1) * k - 1


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Row-blocked placement of one arena tensor: the tensor occupies
    ``rows`` consecutive arena rows starting at ``row_offset``, using the
    first ``rowlen`` elements of each row. Conv/pool operands keep image-row
    structure; on a legacy layout that is one image row per arena row
    (``rows = H``, ``rowlen = W*C``), on a packed layout ``cols_per_row``
    narrow image rows share each arena row (``rows = ceil(H/c)``, ``rowlen =
    c*(W*C)``) or one wide image row spans ``row_span`` arena rows (``rows =
    H*k``, ``rowlen`` = the full arena row). Every other tensor packs
    densely (``rowlen`` = the full arena row). The tail of each row — and of
    the final dense row — is tiling padding, accounted by
    :meth:`BlockPlan.padded_peak_bytes`."""

    name: str
    shape: Tuple[int, ...]
    dtype_bytes: int
    row_offset: int
    rows: int
    rowlen: int              # elements of each arena row this tensor uses
    cols_per_row: int = 1    # image rows packed per arena row
    row_span: int = 1        # arena rows spanned by one image row
    #: Leading batch axis: the block holds ``batch`` per-image sub-blocks of
    #: ``rows // batch`` arena rows each, back to back (each image is packed
    #: and padded independently, so image ``b`` starts at its own arena row
    #: — the per-image addressability the batched lowering relies on).
    batch: int = 1

    @property
    def elems(self) -> int:
        n = self.batch
        for s in self.shape:
            n *= int(s)
        return n

    @property
    def image_rows(self) -> int:
        """Arena rows of ONE image's sub-block."""
        return self.rows // self.batch

    def image_row_offset(self, b: int) -> int:
        """First arena row of image ``b``'s sub-block."""
        return self.row_offset + b * self.image_rows

    @property
    def image_rowlen(self) -> int:
        """Elements of one *image* row (= ``W*C`` for image layouts; the
        used row length for dense/legacy ones)."""
        if self.cols_per_row > 1:
            return self.rowlen // self.cols_per_row
        if self.row_span > 1:
            return int(self.shape[-2]) * int(self.shape[-1])
        return self.rowlen

    def addr(self, r: int, col: int) -> Tuple[int, int]:
        """(block-relative arena row, lane offset) of image-row element
        ``(r, col)`` — the packed addressing every kernel route uses."""
        if self.cols_per_row > 1:
            rl = self.rowlen // self.cols_per_row
            return r // self.cols_per_row, (r % self.cols_per_row) * rl + col
        if self.row_span > 1:
            return r * self.row_span + col // self.rowlen, col % self.rowlen
        return r, col

    def image_addr(self, ar: int, lane: int) -> Tuple[int, int]:
        """Inverse of :meth:`addr`: the ``(image_row, col)`` stored at
        block-relative arena row ``ar``, lane ``lane``."""
        if self.cols_per_row > 1:
            rl = self.rowlen // self.cols_per_row
            return ar * self.cols_per_row + lane // rl, lane % rl
        if self.row_span > 1:
            return (ar // self.row_span,
                    (ar % self.row_span) * self.rowlen + lane)
        return ar, lane


@dataclasses.dataclass
class BlockPlan(Plan):
    """A byte :class:`Plan` legalised onto the row-blocked arena grid.

    Still a valid byte-granular plan — ``offsets`` hold the (row-aligned)
    byte offsets and ``overlaps`` the row-rounded effective O_s, so the
    numpy backend and ``validate()`` work unchanged — plus the block-level
    contract the compiled Pallas program lowers from: per-tensor
    :class:`BlockLayout` records over a shared ``(total_rows, arena_rowlen)``
    arena. ``validate()`` additionally re-checks the no-clobber invariant at
    *row* granularity (a blocked kernel clobbers whole rows)."""

    source: Optional[Plan] = None      #: the byte-granular plan legalised
    tiling: Tuple[int, int] = (8, 128)  #: (sublanes, lanes) for the dtype
    arena_rowlen: int = 128            #: arena row length in elements
    total_rows: int = 0                #: arena rows (sublane-rounded)
    layouts: Dict[Tensor, "BlockLayout"] = dataclasses.field(
        default_factory=dict)
    row_overlaps: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)          #: (op idx, input idx) -> O_s in rows
    packing: str = "legacy"            #: "legacy" | "packed" row layout
    legacy_padded_bytes: int = 0       #: one-image-row-per-arena-row peak
    legacy_window_rows: int = 0        #: legacy streaming max_window_rows

    @property
    def dtype_bytes(self) -> int:
        return (next(iter(self.layouts.values())).dtype_bytes
                if self.layouts else 4)

    @property
    def row_bytes(self) -> int:
        return self.arena_rowlen * self.dtype_bytes

    @property
    def padded_peak_bytes(self) -> int:
        """The arena footprint a row-blocked runtime actually allocates:
        every reserved row at full (lane-tiled) width."""
        return self.total_rows * self.row_bytes

    @property
    def padding_overhead_pct(self) -> float:
        """Tiling cost: legalised (row-blocked) peak over the byte-granular
        source peak, as +%."""
        base = (self.source or self).peak_bytes
        if base == 0:
            return 0.0
        return 100.0 * (self.padded_peak_bytes / base - 1.0)

    @property
    def row_align(self) -> int:
        """Row-offset alignment of this layout's placements: the sublane
        tile on legacy layouts; packed layouts place at a finer 8-row grain
        (a whole sublane tile of slack per int8 tensor would give back much
        of the packing win — DMA and in-kernel ``pl.dslice`` addressing take
        arbitrary row offsets)."""
        sub = self.tiling[0]
        return min(sub, 8) if self.packing == "packed" else sub

    @property
    def legacy_padding_overhead_pct(self) -> float:
        """The one-image-row-per-arena-row (legacy) layout's padding
        overhead over the byte-granular source peak — what
        :attr:`padding_overhead_pct` was before packing. Equal to the packed
        overhead when the never-regress fallback kept the legacy layout."""
        base = (self.source or self).peak_bytes
        legacy = self.legacy_padded_bytes or self.padded_peak_bytes
        if base == 0:
            return 0.0
        return 100.0 * (legacy / base - 1.0)

    def layout_of(self, t: Tensor) -> "BlockLayout":
        return self.layouts[t.storage()]

    def validate(self, granularity: Optional[int] = None) -> None:
        """Byte-granular check plus the exact block-footprint check: live
        tensors never share an arena *row* beyond their row-granular O_s
        distance. The generic ``Plan.validate(granularity)`` pads byte
        sizes, which under-counts image-layout footprints (H arena rows at
        ``rowlen < arena_rowlen`` hold fewer bytes than they reserve), so
        this override walks the real :class:`BlockLayout` row extents."""
        super().validate()
        if granularity is not None:
            super().validate(granularity)
        self._validate_rows()

    def _os_rows(self, inp: Tensor, outp: Tensor) -> int:
        for (oi, ii), v in self.row_overlaps.items():
            op = self.order[oi]
            if op.inputs[ii].storage() is inp \
                    and op.output.storage() is outp:
                return v
        return 0

    def _validate_rows(self) -> None:
        """No-clobber at arena-row granularity over the BlockLayout
        footprints (a blocked kernel clobbers whole reserved rows)."""
        scopes = self.graph.scopes(self.order)
        lays = self.layouts
        tensors = list(lays)
        for i, a in enumerate(tensors):
            sa, ea = scopes[a]
            xa, na = lays[a].row_offset, lays[a].rows
            for b in tensors[i + 1:]:
                sb, eb = scopes[b]
                if ea < sb or eb < sa:
                    continue  # time-disjoint
                xb, nb = lays[b].row_offset, lays[b].rows
                if xa + na <= xb or xb + nb <= xa:
                    continue  # row-disjoint
                os_ = self._allowed_overlap(a, b, scopes)
                if os_ is None:
                    raise AssertionError(
                        f"block plan clobbers rows: {a.name}@r{xa} "
                        f"vs {b.name}@r{xb}")
                inp, outp = os_
                xi = lays[inp].row_offset
                xo = lays[outp].row_offset
                dist = lays[outp].rows - self._os_rows(inp, outp)
                if xi < xo + dist:
                    raise AssertionError(
                        f"row overlap beyond O_s: {inp.name}@r{xi} "
                        f"vs {outp.name}@r{xo} (need distance {dist})")

    def window_schedule(self) -> "WindowSchedule":
        """The streaming live-window schedule for this legalisation
        (memoised — reports, the streaming backend and the benchmarks all
        ask for the same schedule)."""
        cached = self.__dict__.get("_window_cache")
        if cached is None:
            cached = window_schedule(self)
            self.__dict__["_window_cache"] = cached
        return cached

    def report(self) -> str:
        base = (self.source or self).peak_bytes
        ws = self.window_schedule()
        lines = [super().report(),
                 f"  row-blocked: {self.total_rows} rows x "
                 f"{self.arena_rowlen} elems ({self.padded_peak_bytes} bytes,"
                 f" tile {self.tiling[0]}x{self.tiling[1]}) = "
                 f"+{self.padding_overhead_pct:.1f}% padding over "
                 f"byte-granular peak {base}"]
        if self.packing == "packed":
            lines.append(
                f"  packed rows: +{self.padding_overhead_pct:.1f}% vs "
                f"legacy +{self.legacy_padding_overhead_pct:.1f}% "
                f"({self.legacy_padded_bytes} bytes, "
                f"max window {self.legacy_window_rows} rows)")
        lines.append("  " + ws.summary())
        return "\n".join(lines)


def _min_row_distance(op: Op, ci: int = 1, ki: int = 1,
                      co: int = 1, ko: int = 1) -> int:
    """Smallest safe input/output *arena-row* distance for a row-streaming
    op: writing output image row ``i`` (which clobbers the whole arena rows
    it touches, padding and co-packed neighbours included) must leave every
    input row that rows ``> i`` still read intact. Exact by enumeration over
    output rows — the analytic byte O_s rounded to rows can overstate the
    safe overlap when the output's dense rows are narrower than the input's
    (e.g. width-strided convs), so the legaliser takes the max of both
    distances. ``(ci, ki)`` / ``(co, ko)`` are the operands' packed
    ``(cols_per_row, row_span)`` geometries; the defaults reproduce the
    legacy one-image-row-per-arena-row distance exactly."""
    if op.kind not in _ROW_STREAMING_KINDS:
        return 0
    ih = op.inputs[0].shape[-3]
    oh = op.output.shape[-3]
    kh = op.params["kernel"][0]
    sh = op.params.get("stride", (1, 1))[0]
    dh = op.params.get("dilation", (1, 1))[0]
    ph = op_pads(op)[0]  # band-aware: banded ops enumerate band-local rows
    d = 0
    for nxt in range(1, oh):
        lo = None
        for fy in range(kh):
            iy = nxt * sh - ph + fy * dh
            if 0 <= iy < ih:
                lo = iy
                break
        if lo is None:
            continue
        d = max(d, _ar_top(nxt - 1, co, ko) - _ar_of(lo, ci, ki) + 1)
    return d


def _image_layouts(plan: Plan) -> Dict[Tensor, Tuple[int, int]]:
    """Storage tensors that must keep one *image* row per arena row (they
    feed or come out of a row-streaming kernel): storage -> (H, W*C)."""
    image: Dict[Tensor, Tuple[int, int]] = {}
    for op in plan.order:
        if op.kind not in _ROW_STREAMING_KINDS:
            continue
        for t in (op.inputs[0], op.output):
            shp = tuple(t.shape)
            lead = 1
            for s in shp[:-3]:
                lead *= int(s)
            if len(shp) < 3 or lead != 1:
                raise ValueError(
                    f"{op.name}: operand {t.name} shape {shp} has no "
                    "batch-1 HWC row structure to block")
            s = t.storage()
            rows_used = (int(shp[-3]), int(shp[-2]) * int(shp[-1]))
            if image.setdefault(s, rows_used) != rows_used:
                raise ValueError(
                    f"{s.name}: conflicting image-row layouts "
                    f"{image[s]} vs {rows_used} (aggregated views cannot "
                    "be row-blocked)")
    return image


def _legalise_at(plan: Plan, sub: int, lanes: int, db: int,
                 image: Dict[Tensor, Tuple[int, int]], arena_rowlen: int,
                 packed: bool) -> BlockPlan:
    """One legalisation at a fixed ``arena_rowlen``. ``packed=False`` is the
    legacy layout (one image row per arena row, sublane-aligned placement,
    byte O_s distance rounded to whole rows — bit-identical to the pre-
    packing legaliser); ``packed=True`` derives per-tensor
    ``(cols_per_row, row_span)`` geometry from :func:`pack_geometry`, the
    O_s distance in packed arena-row units, and places at the finer packed
    row alignment."""
    tensors = list(plan.offsets)
    row_bytes = arena_rowlen * db

    # Per-image geometry times the batch: each image's sub-block is packed
    # and padded independently (rows = batch * per-image rows), so image b
    # of any operand starts at its own arena row — the addressability the
    # batched per-image lowering and the batched row O_s both rely on.
    rows: Dict[Tensor, int] = {}
    img_rows: Dict[Tensor, int] = {}
    rowlen: Dict[Tensor, int] = {}
    addr: Dict[Tensor, Tuple[int, int]] = {}
    for t in tensors:
        if t in image:
            h, rl = image[t]
            c, k = pack_geometry(rl, arena_rowlen) if packed else (1, 1)
            addr[t] = (c, k)
            img_rows[t] = -(-h // c) if c > 1 else h * k
            rowlen[t] = c * rl if k == 1 else arena_rowlen
        else:
            addr[t] = (1, 1)
            img_rows[t] = -(-t.image_elems // arena_rowlen)
            rowlen[t] = arena_rowlen
        rows[t] = t.batch * img_rows[t]

    # row-granular O_s per recorded overlap: the *per-image* byte distance
    # re-derived in (packed) arena-row units, stiffened by the exact
    # row-streaming bound, then scaled to the batch exactly like
    # :func:`batched_os_bytes` — D_B = D_1 + (B-1) * max(0, out - in)
    # per-image arena rows (batch-major per-image execution over the
    # per-image-padded sub-blocks)
    row_overlaps: Dict[Tuple[int, int], int] = {}
    for (oi, ii), v in plan.overlaps.items():
        op = plan.order[oi]
        outp = op.output.storage()
        inp = op.inputs[ii].storage()
        B = outp.batch
        v1 = v  # per-image byte O_s (undo the batched_os_bytes scaling)
        if B > 1:
            v1 = max(0, v - (B - 1) * min(inp.image_nbytes,
                                          outp.image_nbytes))
        if not packed:
            dist = -(-(outp.image_nbytes - v1) // row_bytes)
            dist = max(dist, _min_row_distance(op))
        else:
            co, ko = addr[outp]
            # last clobber-endangered element -> its last packed arena row
            last = -(-(outp.image_nbytes - v1) // db) - 1
            if outp in image:
                h, rl = image[outp]
                dist = _ar_top(min(last // rl, h - 1), co, ko) + 1
            else:
                dist = last // arena_rowlen + 1
            ci, ki = addr.get(inp, (1, 1))
            dist = max(dist, _min_row_distance(op, ci, ki, co, ko))
        if B > 1:
            dist += (B - 1) * max(0, img_rows[outp] - img_rows.get(inp, 0))
        row_overlaps[(oi, ii)] = max(0, rows[outp] - dist)

    align = min(sub, 8) if packed else sub
    scopes = plan.graph.scopes(plan.order)
    placed: Dict[Tensor, int] = {}
    for t in sorted(tensors, key=lambda t: (plan.offsets[t], -t.nbytes)):
        placed[t] = _lowest_feasible(t, placed, scopes, plan.order,
                                     row_overlaps, sizes=rows, align=align)
    total = max((placed[t] + rows[t] for t in tensors), default=0)
    total = -(-total // sub) * sub

    layouts = {
        t: BlockLayout(t.name, tuple(t.shape), db, placed[t], rows[t],
                       rowlen[t], cols_per_row=addr[t][0],
                       row_span=addr[t][1], batch=t.batch)
        for t in tensors
    }
    # the legalised plan re-expressed in bytes: offsets are row-aligned and
    # each O_s is the row-rounded effective overlap (>= 0), so byte-level
    # validate()/numpy execution see a normal — just padded — plan
    offsets = {t: placed[t] * row_bytes for t in tensors}
    overlaps: Dict[Tuple[int, int], int] = {}
    for (oi, ii), os_rows in row_overlaps.items():
        outp = plan.order[oi].output.storage()
        dist_b = (rows[outp] - os_rows) * row_bytes
        overlaps[(oi, ii)] = max(0, outp.nbytes - dist_b)
    return BlockPlan(plan.graph, list(plan.order), offsets, overlaps,
                     plan.strategy + "+blocks", source=plan,
                     tiling=(sub, lanes), arena_rowlen=arena_rowlen,
                     total_rows=total, layouts=layouts,
                     row_overlaps=row_overlaps,
                     packing="packed" if packed else "legacy")


def _packed_candidates(image: Dict[Tensor, Tuple[int, int]], lanes: int,
                       legacy_rowlen: int) -> List[int]:
    """Candidate packed arena rowlens: each distinct image rowlen rounded to
    lanes (packing is densest when the arena row is a small multiple of the
    image rows it holds), the 1.5x points between them (two narrow rows plus
    half a wider one — the winner on layer pyramids whose widths halve), the
    lane tile and its double, and the legacy rowlen itself (pure re-derive:
    span-free, but packed O_s and alignment). Wider-than-legacy rows can
    only add padding, so candidates cap at ``legacy_rowlen``."""
    rls = sorted({used for _, used in image.values()})
    cands = {-(-rl // lanes) * lanes for rl in rls}
    cands |= {-(-(3 * rl) // (2 * lanes)) * lanes for rl in rls}
    cands |= {legacy_rowlen, lanes, 2 * lanes}
    return sorted(c for c in cands if 0 < c <= legacy_rowlen)


def _best_packed(plan: Plan, sub: int, lanes: int, db: int,
                 image: Dict[Tensor, Tuple[int, int]], legacy_rowlen: int,
                 legacy_bp: BlockPlan, force: bool) -> Optional[BlockPlan]:
    """Sweep the packed candidate rowlens and return the best packed
    legalisation, or ``None`` when none beats the legacy layout (the
    never-regress fallback). "Beats" is lexicographic (padded peak, max
    streaming window): a candidate must not regress either metric vs legacy
    and must strictly improve at least one. ``force=True`` (the
    ``packing="packed"`` override) returns the best candidate even when
    legacy wins."""
    if not image:
        return None
    legacy_padded = legacy_bp.padded_peak_bytes
    legacy_win = legacy_bp.window_schedule().max_window_rows
    best: Optional[BlockPlan] = None
    best_key = None
    for rowlen in _packed_candidates(image, lanes, legacy_rowlen):
        bp = _legalise_at(plan, sub, lanes, db, image, rowlen, packed=True)
        key = (bp.padded_peak_bytes, bp.window_schedule().max_window_rows)
        if not force and (key[0] > legacy_padded or key[1] > legacy_win):
            continue
        if best_key is None or key < best_key:
            best, best_key = bp, key
    if best is None:
        return None
    if not force and best_key >= (legacy_padded, legacy_win):
        return None
    best.legacy_padded_bytes = legacy_padded
    best.legacy_window_rows = legacy_win
    return best


def legalise_for_blocks(plan: Plan,
                        tiling: Optional[Mapping[int, Tuple[int, int]]] = None,
                        packing: str = "auto") -> BlockPlan:
    """Legalise a byte-granular plan onto the row-blocked arena grid.

    Every arena tensor gets a ``(rows, rowlen)`` block shape and an aligned
    row offset (per-dtype tiles: (8, 128) f32, (32, 128) int8); each op's
    diagonal distance is re-derived at row granularity — the byte distance
    ``|out| - O_s`` rounded *up* to whole rows (the ``dmo_arena_dwconv``
    rule), stiffened by the exact row-streaming bound of
    :func:`_min_row_distance`. Placement re-runs the lowest-feasible-offset
    allocator in row units over the same liveness scopes, inserting tensors
    in the source plan's (byte-offset) order, so the legalised plan keeps
    the source's packing structure.

    ``packing`` selects the row layout family:

    - ``"legacy"`` — one image row per lane-tiled arena row whose length is
      set by the widest image row (the pre-packing layout, bit-identical);
    - ``"packed"`` — pack ``cols_per_row`` narrow image rows per arena row
      (or span wide rows over ``row_span`` arena rows) at the best candidate
      rowlen, cutting the lane-padding tax;
    - ``"auto"`` (default) — packed when it beats legacy on (padded peak,
      max streaming window), else the legacy layout: never regress.

    Raises ``ValueError`` for plans no row-blocked arena can express
    (mixed-dtype plans — one typed 2-D buffer has one element size —
    unsupported dtype widths, or aggregated concat-removal views), and
    ``AssertionError`` when the *source* plan is itself unsafe: the
    legaliser re-places tensors, so it must refuse to silently repair a
    clobbering layout."""
    if packing not in ("auto", "packed", "legacy"):
        raise ValueError(f"unknown packing {packing!r}: "
                         "expected auto|packed|legacy")
    if tiling is None:
        # memoised per plan: executors, reports and benchmarks all legalise
        # the same plan, and the candidate sweep + O(T^2) validates per call
        # would otherwise skew execution timings
        cached = plan.__dict__.get("_block_cache")
        if cached is not None and packing in cached:
            return cached[packing]
    tiles = dict(TPU_TILES) if tiling is None else dict(tiling)
    tensors = list(plan.offsets)
    widths = {t.dtype_bytes for t in tensors}
    if len(widths) > 1:
        raise ValueError(
            f"mixed-dtype plan ({sorted(widths)}-byte tensors) cannot be "
            "row-blocked: a typed (rows, rowlen) arena has one element size")
    db = widths.pop() if widths else 4
    if db not in tiles:
        raise ValueError(f"no block tiling for {db}-byte tensors "
                         f"(tilings: {sorted(tiles)})")
    if any(t.alias_of is not None and t.elems != t.storage().elems
           for t in plan.graph.tensors):
        raise ValueError("aggregated views (strided offsets) cannot be "
                         "row-blocked")
    plan.validate()
    sub, lanes = tiles[db]
    image = _image_layouts(plan)

    # legacy arena row length: every image row must fit one arena row
    need = max([lanes] + [used for _, used in image.values()])
    legacy_rowlen = -(-need // lanes) * lanes

    bp = _legalise_at(plan, sub, lanes, db, image, legacy_rowlen,
                      packed=False)
    if packing != "legacy":
        packed_bp = _best_packed(plan, sub, lanes, db, image, legacy_rowlen,
                                 bp, force=(packing == "packed"))
        if packed_bp is not None:
            bp = packed_bp
    bp.validate()
    if tiling is None:
        plan.__dict__.setdefault("_block_cache", {})[packing] = bp
    return bp


# ---------------------------------------------------------------------------
# Streaming live-window schedules
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def staged_slots(in_rows: Sequence[int], out_rows: int, sub: int,
                 ) -> Tuple[Tuple[int, ...], int, int]:
    """Scratch packing for a staged (whole-tensor) streaming op: operand
    blocks packed back-to-back, output last, total rounded up to the
    sublane tile. Returns ``(input slot row offsets, output slot row
    offset, total scratch rows)``. Blocks pack *tight* — the arena-side DMA
    offsets stay tile-aligned (placement guarantees it) and that is the
    side alignment matters on — so a staged op costs the sum of its block
    heights, not the span between scattered placements. The kernel layer
    and the planner both derive the packing from this one function, so the
    scratch a kernel allocates always matches the resident rows the
    schedule reports."""
    offs: List[int] = []
    cur = 0
    for r in in_rows:
        offs.append(cur)
        cur += int(r)
    out_slot = cur
    cur += int(out_rows)
    return tuple(offs), out_slot, _round_up(cur, sub)


def fused_slots(members: Sequence[Op], size_of, align: int = 1,
                round_to: int = 1, include_io: bool = False,
                ) -> Tuple[Dict[Tensor, int], int]:
    """Scratch-slot packing for one fused band chain.

    The chain's internal tensors (every member output except the last
    member's — the terminal, arena-written concat) live only inside the
    fused kernel's VMEM scratch. This runs the lowest-feasible-offset
    allocator over *member-local* liveness scopes (units are whatever
    ``size_of`` returns — rows for the blocked/streaming programs, bytes
    for the flat one), so a mid band's slot is reused as soon as its
    consumer band has read it, while the per-band outputs accumulate until
    the concat. ``include_io=True`` additionally packs the chain's external
    inputs and its terminal output into the scratch (the streaming program
    stages *everything* in VMEM: inputs are DMA'd up front, the output is
    DMA'd back at the end) — and since an external input dies at its last
    in-chain read, the output slot can reuse its space.

    Slots pack tight (like :func:`staged_slots` — the arena-side DMA
    offsets are the aligned side); only the total is rounded up to
    ``round_to``. Returns ``(slot offset per tensor, total scratch
    units)``. The kernel layer, the window schedule and the FusePass budget
    estimate all derive the packing from this one function."""
    n = len(members)
    internal = {op.output.storage() for op in members[:-1]}
    first: Dict[Tensor, int] = {}
    last: Dict[Tensor, int] = {}
    tensors: List[Tensor] = []

    def touch(s: Tensor, i: int) -> None:
        if s not in first:
            first[s] = i
            tensors.append(s)
        last[s] = max(last.get(s, i), i)

    for i, op in enumerate(members):
        for t in op.inputs:
            s = t.storage()
            if s.kind == "weight":
                continue
            if s in internal:
                touch(s, i)
            elif include_io:
                touch(s, 0)        # resident from the up-front DMA
                last[s] = max(last[s], i)
        s = op.output.storage()
        if s in internal:
            touch(s, i)
        elif include_io:
            touch(s, i)
            last[s] = n - 1        # held until the write-back DMA
    scopes = {s: (first[s], last[s]) for s in tensors}
    sizes = {s: int(size_of(s)) for s in tensors}
    placed: Dict[Tensor, int] = {}
    for s in tensors:              # first-touch (production) order
        placed[s] = _lowest_feasible(s, placed, scopes, list(members), {},
                                     sizes=sizes, align=align)
    total = max((placed[s] + sizes[s] for s in tensors), default=0)
    return placed, _round_up(total, max(1, round_to))


def _roll_geometry(op: Op) -> Tuple[int, int, int, int]:
    """(kh, sh, dh, ph) of a row-streaming op, band-aware."""
    kh = op.params["kernel"][0]
    sh = op.params.get("stride", (1, 1))[0]
    dh = (op.params.get("dilation", (1, 1))[0]
          if op.kind != "pool" else 1)
    ph = op_pads(op)[0]
    return kh, sh, dh, ph


def tile_rows(co: int, ko: int, sub: int) -> int:
    """Output *image* rows per streaming grid tile under the packed output
    geometry ``(co, ko)``: the smallest multiple of ``cols_per_row`` that
    covers ``sub`` image rows, so every arena row's lane phases complete
    within one tile while the per-tile *input* span (and with it the rolling
    window) stays at its legacy size instead of scaling with the packing
    factor. ``sub`` image rows on a legacy layout."""
    if co > 1:
        return -(-sub // co) * co
    return max(1, sub // ko)


def tile_arena_rows(co: int, ko: int, sub: int) -> int:
    """Arena rows one streaming output tile occupies (sublane-rounded):
    ``sub`` unless one image row spans more than a sublane tile."""
    tr = tile_rows(co, ko, sub)
    return _round_up(_ar_top(tr - 1, co, ko) + 1, sub)


def rolling_starts(op: Op, xi: int, xo: int, ih: int, oh: int, sub: int,
                   total_rows: int,
                   in_addr: Tuple[int, int] = (1, 1),
                   out_addr: Tuple[int, int] = (1, 1),
                   ) -> Tuple[Tuple[int, ...], int]:
    """Per-tile input-window fetch starts for a row-streaming op.

    The op walks output rows in tiles of ``sub`` rows (the dtype's sublane
    tile). The tile covering output rows ``[a, b)`` needs the input rows
    its taps may touch — ``iy = oy*sh - ph + fy*dh`` clamped exactly like
    the kernels clamp it — a contiguous input band whose height is bounded
    by ``tile*stride + kernel halo``, independent of where the placement
    put the operands. Output rows live in their own scratch tile, so the
    resident window is ``win_in + sub`` rows however far apart input and
    output were placed.

    Fetches are fixed-size (``win_in`` rows, sublane-rounded) starting at
    ``starts[t]`` (arena rows, aligned), clamped so the fetch never runs
    past the arena; over-fetched rows are never read unmasked (reads
    outside the valid input rows are the kernels' clamped+masked taps) and
    never written back (write-back covers exactly the computed rows).

    The O_s row invariant makes split input/output staging exact: an op's
    write to output row ``oy`` only ever clobbers arena input rows no
    later tap re-reads (that is what the diagonal distance guarantees), so
    no read inside the op can observe its own writes and staging the input
    band separately from the output tile preserves blocked-mode semantics
    row for row.

    ``ih``/``oh`` are *image* heights; ``in_addr``/``out_addr`` the packed
    ``(cols_per_row, row_span)`` geometries (legacy defaults: one image row
    per arena row, tiles of ``sub`` rows). Returns
    ``(starts per tile, win_in)`` in arena rows."""
    kh, sh, dh, ph = _roll_geometry(op)
    ci, ki = in_addr
    co, ko = out_addr
    tr = tile_rows(co, ko, sub)
    in_arena_rows = -(-ih // ci) if ci > 1 else ih * ki
    need, tiles = 0, []
    for a in range(0, oh, tr):
        b = min(a + tr, oh)
        iy_lo = min(max(a * sh - ph, 0), ih - 1)
        iy_hi = min(max((b - 1) * sh - ph + (kh - 1) * dh, 0), ih - 1)
        s_t = (_ar_of(iy_lo, ci, ki) // sub) * sub
        tiles.append(s_t)
        need = max(need, _ar_top(iy_hi, ci, ki) - s_t + 1)
    win_in = min(_round_up(need, sub), _round_up(in_arena_rows, sub))
    starts = tuple(max(0, min(xi + s_t, total_rows - win_in))
                   for s_t in tiles)
    return starts, win_in


@dataclasses.dataclass(frozen=True)
class OpWindow:
    """One op's live window in the streaming schedule: the contiguous
    arena-row extent ``[lo, hi)`` it may touch, the live-window rows
    (``win_rows``) and the scratch rows its streaming program allocates
    (``resident_rows`` — the rolling input window is double-buffered, so
    resident exceeds the live window by one input-window slot).
    ``starts`` is the per-output-tile fetch start table for rolling
    (conv / depthwise / pool) ops; empty for staged whole-tensor ops."""

    op_name: str
    kind: str
    lo: int
    hi: int
    win_rows: int
    resident_rows: int
    starts: Tuple[int, ...] = ()

    @property
    def rolling(self) -> bool:
        return bool(self.starts)


@dataclasses.dataclass(frozen=True)
class WindowSchedule:
    """The live-window row schedule of a :class:`BlockPlan`: per executed op
    (reshapes excluded, same order the backends lower), the arena rows it
    may touch and the rows its streaming program keeps resident in VMEM,
    plus the whole-program bound ``max_window_rows`` — the quantity that
    replaces ``total_rows`` as the streaming executor's VMEM ceiling."""

    windows: Tuple[OpWindow, ...]
    total_rows: int
    arena_rowlen: int
    dtype_bytes: int

    @property
    def row_bytes(self) -> int:
        return self.arena_rowlen * self.dtype_bytes

    @property
    def max_window_rows(self) -> int:
        return max((w.win_rows for w in self.windows), default=0)

    @property
    def max_resident_bytes(self) -> int:
        """Peak scratch footprint of any one streaming op (all slots,
        double-buffering included)."""
        return max((w.resident_rows * self.row_bytes
                    for w in self.windows), default=0)

    def summary(self) -> str:
        pct = (100.0 * self.max_window_rows / self.total_rows
               if self.total_rows else 0.0)
        return (f"streaming windows: max {self.max_window_rows} rows live "
                f"of {self.total_rows} arena rows ({pct:.1f}%), "
                f"peak scratch {self.max_resident_bytes} bytes")

    def report(self) -> str:
        lines = [f"# window schedule: {self.summary()}"]
        for w in self.windows:
            tag = "roll" if w.rolling else "stage"
            lines.append(
                f"  {w.op_name:32s} {tag:5s} [{w.lo:>5d},{w.hi:>5d}) "
                f"live={w.win_rows:>5d} resident={w.resident_rows:>5d} rows")
        return "\n".join(lines)


def chain_addr_of(bplan: BlockPlan):
    """Packed geometry resolver for fused-chain operands: ``f(tensor
    storage) -> (cols_per_row, row_span)``. Arena tensors answer from their
    :class:`BlockLayout`; chain-internal scratch tensors (no layout) derive
    theirs from :func:`pack_geometry` on their image rowlen — the ONE rule
    the planner's windows, the backend's fused specs and the kernels'
    scratch addressing all share. Legacy layouts keep every operand at
    ``(1, 1)`` (one image row per scratch row)."""
    packed = bplan.packing == "packed"

    def addr_of(s: Tensor) -> Tuple[int, int]:
        lay = bplan.layouts.get(s)
        if lay is not None:
            return lay.cols_per_row, lay.row_span
        if not packed:
            return 1, 1
        rl = int(s.shape[-2]) * int(s.shape[-1])
        return pack_geometry(rl, bplan.arena_rowlen)

    return addr_of


def chain_rows_of(bplan: BlockPlan):
    """Arena/scratch row resolver for fused-chain operands: ``f(tensor
    storage) -> rows``, packed-geometry-aware via :func:`chain_addr_of`."""
    addr_of = chain_addr_of(bplan)

    def rows_of(s: Tensor) -> int:
        lay = bplan.layouts.get(s)
        if lay is not None:
            return lay.rows
        c, k = addr_of(s)
        h = int(s.shape[-3])
        return -(-h // c) if c > 1 else h * k

    return rows_of


def chain_image_rows_of(bplan: BlockPlan):
    """Per-IMAGE row resolver for fused-chain operands: like
    :func:`chain_rows_of` but for one image's sub-block — the unit the
    batched per-image fused lowering stages in VMEM. Identical to
    :func:`chain_rows_of` on batch-1 plans."""
    addr_of = chain_addr_of(bplan)

    def rows_of(s: Tensor) -> int:
        lay = bplan.layouts.get(s)
        if lay is not None:
            return lay.image_rows
        c, k = addr_of(s)
        h = int(s.shape[-3])
        return -(-h // c) if c > 1 else h * k

    return rows_of


def _fused_window(bplan: BlockPlan, members: Sequence[Op],
                  sub: int) -> OpWindow:
    """One staged window for a fused band chain. The streaming fused
    kernel DMAs every external-input block into VMEM up front, runs all
    chain stages inside the scratch buffer and writes only the terminal
    block back — so the resident rows are the ``include_io``
    :func:`fused_slots` packing (chain scratch plus the staged I/O blocks),
    and the row extent spans the external operands' arena placements.
    Chain-internal tensors have no layouts; their scratch rows come from
    the shared :func:`chain_image_rows_of` rule (one arena row per image
    row on legacy layouts, packed geometry on packed ones). A batched
    chain stages ALL images at once (its stages run op-major inside the
    one kernel, so every image of a member's output is live before the
    next member runs) — the VMEM window scales with the batch and the
    budget gate polices that honestly."""
    internal = {op.output.storage() for op in members[:-1]}
    irows_of = chain_image_rows_of(bplan)

    def rows_of(s: Tensor) -> int:
        return irows_of(s) * (s.batch if s.batch > 1 else 1)

    _, total = fused_slots(members, rows_of, round_to=sub, include_io=True)
    ext: List[BlockLayout] = []
    for op in members:
        for t in op.inputs:
            s = t.storage()
            if s.kind != "weight" and s not in internal:
                ext.append(bplan.layouts[s])
    ext.append(bplan.layouts[members[-1].output.storage()])
    lo = min(l.row_offset for l in ext)
    hi = max(l.row_offset + l.rows for l in ext)
    return OpWindow(members[-1].params["fuse_chain"], "fused",
                    (lo // sub) * sub, _round_up(hi, sub),
                    win_rows=total, resident_rows=total)


def window_schedule(bplan: BlockPlan) -> "WindowSchedule":
    """Derive the live-window schedule from a legalised plan.

    Row-streaming ops (conv / depthwise / pool) get a rolling input window
    plus a one-tile output slot via :func:`rolling_starts`; every other
    kind stages whole operand blocks via :func:`staged_slots` (each block
    is contiguous, so a scattered multi-operand extent — e.g. a
    band-reassembling concat — costs only the sum of its block heights,
    not the span between them). A fused band chain contributes ONE staged
    window (at the first member's position, named after the chain) sized by
    :func:`_fused_window`."""
    sub = bplan.tiling[0]
    windows: List[OpWindow] = []
    chains: Dict[str, List[Op]] = {}
    for op in bplan.order:
        cname = op.params.get("fuse_chain")
        if cname is not None:
            chains.setdefault(cname, []).append(op)
    emitted: set = set()
    for op in bplan.order:
        if op.kind == "reshape":
            continue
        batch = op.output.storage().batch
        cname = op.params.get("fuse_chain")
        if cname is not None:
            if cname not in emitted:
                emitted.add(cname)
                windows.append(_fused_window(bplan, chains[cname], sub))
            continue
        # one window per IMAGE (batch-major, same order the backends lower
        # their per-image specs): the streaming VMEM ceiling is per-image,
        # so it does not scale with the batch
        ins = [t for t in op.inputs if t.storage().kind != "weight"]
        lays = [bplan.layout_of(t) for t in ins]
        out = bplan.layout_of(op.output)
        for b in range(batch):
            offs = [l.image_row_offset(b if l.batch == batch else 0)
                    for l in lays]
            out_off = out.image_row_offset(b)
            lo_e = min(offs + [out_off])
            hi_e = max([o + l.image_rows for o, l in zip(offs, lays)]
                       + [out_off + out.image_rows])
            if op.kind in _ROW_STREAMING_KINDS and len(lays) == 1:
                in_addr = (lays[0].cols_per_row, lays[0].row_span)
                out_addr = (out.cols_per_row, out.row_span)
                starts, win_in = rolling_starts(
                    op, offs[0], out_off,
                    int(op.inputs[0].shape[-3]), int(op.output.shape[-3]),
                    sub, bplan.total_rows, in_addr=in_addr,
                    out_addr=out_addr)
                out_ar = tile_arena_rows(*out_addr, sub)
                lo = (min(min(starts), lo_e) // sub) * sub
                hi = _round_up(max(max(s + win_in for s in starts), hi_e),
                               sub)
                windows.append(OpWindow(op.name, op.kind, lo, hi,
                                        win_rows=win_in + out_ar,
                                        resident_rows=2 * win_in + out_ar,
                                        starts=starts))
            else:
                _, _, total = staged_slots([l.image_rows for l in lays],
                                           out.image_rows, sub)
                windows.append(OpWindow(
                    op.name, op.kind, (lo_e // sub) * sub,
                    _round_up(hi_e, sub), win_rows=total,
                    resident_rows=total))
    return WindowSchedule(tuple(windows), bplan.total_rows,
                          bplan.arena_rowlen, bplan.dtype_bytes)


# ---------------------------------------------------------------------------
# Constraint machinery
# ---------------------------------------------------------------------------


def batched_os_bytes(os_image: int, inp: Tensor, outp: Tensor) -> int:
    """Scale a per-image byte ``O_s`` to the batched tensors' layout.

    Batched execution is batch-major and per-image independent: image ``b``
    of the op reads only image ``b`` of the input and writes only image
    ``b`` of the output, images in ascending order. Writing output image
    ``b`` must leave input image ``b`` intact up to the per-image overlap
    (the ordinary per-image condition, worst at the last image when
    ``|out| > |in|``) and must not touch the still-unread input images
    ``> b``. Solving both for the smallest safe input/output distance gives

        ``D_B = (|out| - O_s_1) + (B - 1) * max(0, |out| - |in|)``

    (per-image byte sizes), i.e. the batched overlap

        ``O_s_B = O_s_1 + (B - 1) * min(|in|, |out|)``.

    Valid for any per-image ``O_s_1 >= 0`` — the batched term only relies
    on image ``b`` of the input being dead once image ``b`` is computed.
    Tensors with mismatched batches (e.g. a broadcast operand shared by
    every image, which must survive until the last image) get no batched
    relaxation."""
    B = outp.batch
    if B == 1:
        return os_image
    if inp.batch != B:
        return 0
    return os_image + (B - 1) * min(inp.image_nbytes, outp.image_nbytes)


def _compute_overlaps(order: List[Op], overlap_fn: Optional[OverlapFn],
                      scopes) -> Dict[Tuple[int, int], int]:
    """O_s for every (op, input) pair where the relaxation is legal: the input
    is an intermediate whose *last* use is this op (paper §II.D). Per-image
    overlaps from ``overlap_fn`` are scaled to the batch via
    :func:`batched_os_bytes`."""
    if overlap_fn is None:
        return {}
    out: Dict[Tuple[int, int], int] = {}
    for oi, op in enumerate(order):
        if not op.outputs:
            continue
        if op.output.storage().kind == "scratch":
            # fused-chain internal write: the tensor has no arena placement
            # (and no scope entry) — there is nothing to relax
            continue
        if op.output.alias_of is not None:
            # §II.C removal: this op writes into an aggregated view — its
            # write offsets shift, so the overlap relaxation is dropped
            # (the conservative O_s=0 route the paper describes)
            continue
        for ii, t in enumerate(op.inputs):
            s = t.storage()
            if s.kind in ("weight", "output", "scratch"):
                continue
            if t.alias_of is not None:
                continue
            if scopes[s][1] != oi:  # value needed later: no overwrite allowed
                continue
            if s is op.output.storage():
                continue
            v = batched_os_bytes(overlap_fn(op, ii), s, op.output.storage())
            if v > 0:
                out[(oi, ii)] = v
        # multiple overlappable inputs of one op would collide with each
        # other inside the overlap region; keep only the largest O_s.
        cand = [(k, v) for k, v in out.items() if k[0] == oi]
        if len(cand) > 1:
            cand.sort(key=lambda kv: -kv[1])
            for k, _ in cand[1:]:
                del out[k]
    return out


def _forbidden_intervals(t: Tensor, placed: Dict[Tensor, int], scopes,
                         order: List[Op],
                         overlaps: Dict[Tuple[int, int], int],
                         sizes: Optional[Mapping[Tensor, int]] = None,
                         ) -> List[Tuple[int, int]]:
    """Intervals of start offsets forbidden for tensor ``t``. Offsets, sizes
    and O_s values share one unit: bytes by default, or whatever unit the
    ``sizes`` map (and the matching ``overlaps`` values) are expressed in —
    the row-blocked legaliser passes row counts through the same machinery."""
    size = (lambda x: x.nbytes) if sizes is None else sizes.__getitem__
    # map (input storage, output storage) -> O_s for quick lookup
    relax: Dict[Tuple[Tensor, Tensor], int] = {}
    for (oi, ii), v in overlaps.items():
        op = order[oi]
        relax[(op.inputs[ii].storage(), op.output.storage())] = v
    sa, ea = scopes[t]
    out: List[Tuple[int, int]] = []
    nt = size(t)
    for b, xb in placed.items():
        sb, eb = scopes[b]
        if ea < sb or eb < sa:
            continue
        nb = size(b)
        if (t, b) in relax:        # t is input overlapping output b's tail
            hi = xb + nb - relax[(t, b)]
        elif (b, t) in relax:      # t is the output; b the (placed) input:
            # constraint: xb >= x_t + n_t - O_s  ->  x_t <= xb - n_t + O_s,
            # i.e. forbidden to START in (xb - n_t + O_s, xb + nb) unless
            # fully above b.  Lower edge of forbidden zone:
            hi = xb + nb           # fully-above bound handled below
            lo = xb - nt + relax[(b, t)]
            if lo < hi:
                out.append((lo + 1, xb + nb))
            continue
        else:
            hi = xb + nb
        lo = xb - nt
        if lo < hi:
            out.append((lo + 1, hi))  # forbidden start offsets [lo+1, hi)
    return out


def _lowest_feasible(t: Tensor, placed, scopes, order, overlaps,
                     sizes: Optional[Mapping[Tensor, int]] = None,
                     align: Optional[int] = None) -> int:
    """Lowest conflict-free start offset for ``t``, rounded up to the
    tensor's ``dtype_bytes`` alignment so executor backends can view the byte
    arena at the planned offset (an f32 tensor packed after an odd-sized int8
    tensor must not land on an unaligned byte). All-f32 graphs are unaffected:
    every boundary there is already a multiple of 4. The row-blocked
    legaliser reuses this with ``sizes`` in rows and ``align`` the sublane
    tile, so offsets land on per-dtype tile boundaries."""
    a = align if align is not None else max(1, t.dtype_bytes)
    iv = sorted(_forbidden_intervals(t, placed, scopes, order, overlaps,
                                     sizes))
    x = 0
    for lo, hi in iv:
        if x < lo:
            break
        x = max(x, hi)
        x = -(-x // a) * a  # next aligned start at or above the interval end
    return x


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


def plan_naive(graph: Graph, order: Optional[Sequence[Op]] = None) -> Plan:
    """Greedy heap in forward execution order, no overlap."""
    order = list(order or graph.ops)
    scopes = graph.scopes(order)
    placed: Dict[Tensor, int] = {}
    overlaps: Dict[Tuple[int, int], int] = {}
    # allocate exactly when the executor would: model inputs up front, then
    # each op's outputs at the moment the op runs (TFLite heap behaviour)
    alloc_order: List[Tensor] = [t for t in scopes if t.kind == "input"]
    for op in order:
        for t in op.outputs:
            s = t.storage()
            if s in scopes and s not in alloc_order:
                alloc_order.append(s)
    for t in scopes:  # stragglers (defensive)
        if t not in alloc_order:
            alloc_order.append(t)
    for t in alloc_order:
        placed[t] = _lowest_feasible(t, placed, scopes, order, overlaps)
    return Plan(graph, order, placed, overlaps, "naive")


def plan_greedy_size(graph: Graph, order: Optional[Sequence[Op]] = None,
                     overlap_fn: Optional[OverlapFn] = None) -> Plan:
    """TFLite-Micro-style greedy pre-allocator: place buffers largest-first at
    the lowest conflict-free offset, optionally with the DMO overlap
    relaxation. Without overlap this is the strongest non-overlapping
    baseline; with overlap it recovers the paper's diagonal cascades on the
    sequential models (big consumer outputs are placed first, and every input
    then tucks into its consumer's tail)."""
    order = list(order or graph.ops)
    scopes = graph.scopes(order)
    overlaps = _compute_overlaps(order, overlap_fn, scopes)
    placed: Dict[Tensor, int] = {}
    for t in sorted(scopes, key=lambda t: (-t.nbytes, scopes[t][0])):
        placed[t] = _lowest_feasible(t, placed, scopes, order, overlaps)
    name = "greedy_size+dmo" if overlap_fn else "greedy_size"
    return Plan(graph, order, placed, overlaps, name)


def plan_reverse_heap(graph: Graph, order: Optional[Sequence[Op]] = None,
                      overlap_fn: Optional[OverlapFn] = None) -> Plan:
    """The paper's §II.D DMO allocator: heap allocation in *reverse execution
    order* (each op's output, then its inputs), so that every input can be
    placed overlapping the tail of its consumer's already-placed output.
    Produces the diagonal cascade of Fig. 2b."""
    order = list(order or graph.ops)
    scopes = graph.scopes(order)
    overlaps = _compute_overlaps(order, overlap_fn, scopes)
    placed: Dict[Tensor, int] = {}
    for op in reversed(order):
        cands = [t.storage() for t in op.outputs]
        cands += sorted((t.storage() for t in op.intermediate_inputs()),
                        key=lambda s: -s.nbytes)
        for s in cands:
            if s.kind == "weight" or s in placed or s not in scopes:
                continue
            placed[s] = _lowest_feasible(s, placed, scopes, order, overlaps)
    for s in scopes:  # unconsumed stragglers
        if s not in placed:
            placed[s] = _lowest_feasible(s, placed, scopes, order, overlaps)
    name = "dmo_reverse" if overlap_fn else "reverse_heap"
    return Plan(graph, order, placed, overlaps, name)


def plan_modified_heap(graph: Graph, order: Optional[Sequence[Op]] = None,
                       overlap_fn: Optional[OverlapFn] = None,
                       direction: str = "backward") -> Plan:
    """The paper's modified heap (§IV), optionally with DMO overlap."""
    order = list(order or graph.ops)
    scopes = graph.scopes(order)
    overlaps = _compute_overlaps(order, overlap_fn, scopes)
    todo = list(scopes.keys())
    if not todo:
        return Plan(graph, order, {}, overlaps, "modified_heap")
    # seed: output buffer (backward) / input buffer (forward) at offset 0
    key = (lambda t: scopes[t][1]) if direction == "backward" else (
        lambda t: -scopes[t][0])
    seed = max(todo, key=lambda t: (key(t), t.nbytes))
    placed: Dict[Tensor, int] = {seed: 0}
    todo.remove(seed)
    while todo:
        frontier = [
            t for t in todo
            if any(scopes[t][0] <= scopes[p][1] and scopes[p][0] <= scopes[t][1]
                   for p in placed)
        ] or todo
        best, best_x = None, None
        for t in frontier:
            x = _lowest_feasible(t, placed, scopes, order, overlaps)
            if best_x is None or x < best_x or (x == best_x and t.nbytes > best.nbytes):
                best, best_x = t, x
        placed[best] = best_x
        todo.remove(best)
    name = "dmo" if overlap_fn is not None else f"modified_heap_{direction}"
    return Plan(graph, order, placed, overlaps, name)


def _plan_scaled_batch1(graph: Graph, order: Optional[Sequence[Op]],
                        method: str, profile: str) -> Optional[Plan]:
    """Batched candidate: plan the per-image (batch-1) graph, then scale
    every byte offset by the batch B. Always valid: for any overlapping
    (input, output) pair the scaled distance is ``B * (|out|_1 - O_s_1)``
    and the batched requirement is ``B*|out|_1 - O_s_1 - (B-1)*min(|in|_1,
    |out|_1)``, so validity reduces to ``O_s_1 <= min(|in|_1, |out|_1)`` —
    true by construction (an overlap of two buffers cannot exceed either
    size) — while disjoint pairs stay disjoint under uniform scaling.
    Guarantees ``peak(B) <= B * peak(1)``: the batch never costs more than
    B independent copies, whatever the heap heuristics do at batch B."""
    from repro_torch.core.graph import with_batch
    B = getattr(graph, "batch", 1)
    if B <= 1:
        return None
    g1 = with_batch(graph, 1)
    order1 = None
    if order is not None:
        pos = {id(op): i for i, op in enumerate(graph.ops)}
        order1 = [g1.ops[pos[id(op)]] for op in order]
    p1 = plan_dmo(g1, order1, method, profile)
    by_name = {t.name: t for t in graph.tensors}
    offsets = {by_name[t.name]: off * B for t, off in p1.offsets.items()}
    fn = _default_overlap(method, profile)
    ord_b = list(order or graph.ops)
    overlaps = _compute_overlaps(ord_b, fn, graph.scopes(ord_b))
    plan = Plan(graph, ord_b, offsets, overlaps,
                p1.strategy + f"+scaled_b{B}")
    try:
        plan.validate()
    except AssertionError:  # pragma: no cover - defensive; see docstring
        return None
    return plan


def plan_dmo(graph: Graph, order: Optional[Sequence[Op]] = None,
             method: str = "auto", profile: str = "paper") -> Plan:
    """Diagonal memory optimisation: the better of the strict reverse-order
    heap (§II.D) and the modified-heap frontier heuristic (§IV), both with
    the O_s overlap relaxation. Batched graphs add the scaled batch-1
    candidate (:func:`_plan_scaled_batch1`), bounding the batched peak by
    ``B x`` the per-image peak."""
    fn = _default_overlap(method, profile)
    plans = [
        plan_greedy_size(graph, order, fn),
        plan_reverse_heap(graph, order, fn),
        plan_modified_heap(graph, order, fn, direction="backward"),
    ]
    scaled = _plan_scaled_batch1(graph, order, method, profile)
    if scaled is not None:
        plans.append(scaled)
    return min(plans, key=lambda p: p.peak_bytes)


def plan_search(graph: Graph, order: Optional[Sequence[Op]] = None,
                method: str = "auto", budget_s: float = 10.0,
                seed: int = 0, with_overlap: bool = True,
                profile: str = "paper") -> Plan:
    """Beyond-paper: iterated local search over the *insertion order* of the
    lowest-feasible-offset allocator (with DMO overlap constraints).

    The buffer-placement problem is NP-hard (paper §IV); greedy orders get
    trapped when an overlap partner is placed before its constraint becomes
    visible. ILS over insertion orders escapes those traps and recovers the
    paper's optimal diagonal cascades (e.g. MobileNet v1's 33.3 %).
    """
    import random
    import time as _time

    order = list(order or graph.ops)
    scopes = graph.scopes(order)
    overlap_fn = (_default_overlap(method, profile)
                  if with_overlap else None)
    overlaps = _compute_overlaps(order, overlap_fn, scopes)
    tensors = list(scopes)

    def evaluate(insertion: List[Tensor]):
        placed: Dict[Tensor, int] = {}
        for t in insertion:
            placed[t] = _lowest_feasible(t, placed, scopes, order, overlaps)
        peak = max((x + t.nbytes for t, x in placed.items()), default=0)
        return peak, placed

    seeds = [
        sorted(tensors, key=lambda t: (-t.nbytes, scopes[t][0])),
        sorted(tensors, key=lambda t: (-t.nbytes, -scopes[t][1])),
        sorted(tensors, key=lambda t: (-scopes[t][1], -t.nbytes)),
        sorted(tensors, key=lambda t: (scopes[t][0], -t.nbytes)),
    ]
    best_peak, best_placed, best_ins = None, None, None
    for ins in seeds:
        p, placed = evaluate(ins)
        if best_peak is None or p < best_peak:
            best_peak, best_placed, best_ins = p, placed, list(ins)

    rng = random.Random(seed)
    cur = list(best_ins)
    cur_peak = best_peak
    t0 = _time.time()
    n = len(tensors)
    while _time.time() - t0 < budget_s and n > 2:
        nxt = list(cur)
        for _ in range(rng.randint(1, 3)):
            i, j = rng.randrange(n), rng.randrange(n)
            if rng.random() < 0.5:
                nxt[i], nxt[j] = nxt[j], nxt[i]
            else:
                nxt.insert(j, nxt.pop(i))
        p, placed = evaluate(nxt)
        if p <= cur_peak:
            cur, cur_peak = nxt, p
            if p < best_peak:
                best_peak, best_placed, best_ins = p, placed, list(nxt)
        elif rng.random() < 0.02:  # occasional uphill restart from best
            cur, cur_peak = list(best_ins), best_peak
    return Plan(graph, order, best_placed, overlaps,
                "search+dmo" if with_overlap else "search")


# ---------------------------------------------------------------------------
# Joint execution-order x overlap search (beyond-paper)
# ---------------------------------------------------------------------------


def live_bytes_profile(graph: Graph, order: Sequence[Op]) -> List[int]:
    """Naive live-byte total at every execution step of ``order`` — a
    prefix-sum sweep over the liveness scopes, O(ops + tensors). This is the
    *floor* a non-overlapping allocator can reach at each step; the DMO peak
    may sit below it (overlap) or above it (fragmentation)."""
    scopes = graph.scopes(order)
    n = len(order)
    diff = [0] * (n + 1)
    for s, (a, b) in scopes.items():
        diff[a] += s.nbytes
        diff[b + 1] -= s.nbytes
    out: List[int] = []
    acc = 0
    for k in range(n):
        acc += diff[k]
        out.append(acc)
    return out


class LivePeakEstimator:
    """Incremental naive live-byte peak of an execution order.

    The joint search screens thousands of candidate linearisations; a full
    placement evaluation costs O(T^2) per candidate, but an *adjacent
    transposition* only changes which tensors are live at the two swapped
    steps. This estimator maintains the per-step live-byte profile under
    adjacent swaps in O(degree of the two ops) — mirroring
    :meth:`Graph.scopes` semantics exactly, so after any sequence of swaps
    the profile is bit-identical to a fresh :func:`live_bytes_profile` of
    the current order. ``swap(i)`` is its own inverse (undo = re-swap)."""

    def __init__(self, graph: Graph, order: Sequence[Op]):
        self.graph = graph
        # static structure: who reads / writes each arena storage (the same
        # kind filters Graph.scopes applies)
        self._readers: Dict[Tensor, List[Op]] = {}
        self._writers: Dict[Tensor, List[Op]] = {}
        for op in graph.ops:
            for t in op.inputs:
                s = t.storage()
                if s.kind in ("weight", "scratch"):
                    continue
                self._readers.setdefault(s, []).append(op)
            for t in op.outputs:
                s = t.storage()
                if s.kind == "scratch":
                    continue
                self._writers.setdefault(s, []).append(op)
        self.reset(order)

    def reset(self, order: Sequence[Op]) -> None:
        self.order = list(order)
        self.n = len(self.order)
        self._pos = {op: i for i, op in enumerate(self.order)}
        self._bytes_at = live_bytes_profile(self.graph, self.order)
        self._peak = max(self._bytes_at, default=0)
        self._dirty = False

    @property
    def peak(self) -> int:
        if self._dirty:
            self._peak = max(self._bytes_at, default=0)
            self._dirty = False
        return self._peak

    def _scope(self, s: Tensor) -> Tuple[int, int]:
        """[first, last] liveness of storage ``s`` under the current
        positions — the closed form of Graph.scopes' sweep: inputs are live
        from 0, outputs to the end, otherwise first touch to last read (or
        the first write when never read)."""
        reads = [self._pos[op] for op in self._readers.get(s, ())]
        writes = [self._pos[op] for op in self._writers.get(s, ())]
        first = 0 if s.kind == "input" else min(reads + writes)
        if s.kind == "output":
            last = self.n - 1
        else:
            last = max(reads) if reads else min(writes)
        return first, last

    def swap(self, i: int) -> int:
        """Adjacent transposition of ``order[i]`` and ``order[i+1]``;
        returns the (possibly stale-free) new peak."""
        a, b = self.order[i], self.order[i + 1]
        touched: List[Tensor] = []
        seen = set()
        for op in (a, b):
            for t in list(op.inputs) + list(op.outputs):
                s = t.storage()
                if s.kind in ("weight", "scratch") or id(s) in seen:
                    continue
                if s not in self._readers and s not in self._writers:
                    continue
                seen.add(id(s))
                touched.append(s)
        old = {id(s): self._scope(s) for s in touched}
        self._pos[a], self._pos[b] = i + 1, i
        self.order[i], self.order[i + 1] = b, a
        for s in touched:
            f1, l1 = old[id(s)]
            f2, l2 = self._scope(s)
            if (f1, l1) == (f2, l2):
                continue
            for k in (i, i + 1):
                d = s.nbytes * ((f2 <= k <= l2) - (f1 <= k <= l1))
                if d:
                    was = self._bytes_at[k]
                    self._bytes_at[k] = was + d
                    if was + d > self._peak:
                        self._peak = was + d
                    elif was == self._peak and d < 0:
                        self._dirty = True
        return self.peak


def plan_joint(graph: Graph, orders: Optional[Sequence[Sequence[Op]]] = None,
               *, method: str = "auto", profile: str = "paper",
               budget_s: float = 2.0, seed: int = 0,
               allow_order_moves: bool = True, order_move_prob: float = 0.25,
               max_rounds: Optional[int] = None,
               promote: bool = True) -> Tuple[Plan, Dict[str, Any]]:
    """Joint search over (linearisation, placement) — beyond every paper in
    PAPERS.md, which each optimise one axis at a time.

    ILS over the *product* space: order moves (adjacent transpositions kept
    dependency-respecting by :class:`serialise.OrderMoves`) interleave with
    the insertion-order placement moves of :func:`plan_search`. An order
    move is pre-screened by the incremental :class:`LivePeakEstimator`
    (floor-raising moves are usually skipped — but not always, because order
    and diagonal overlap trade off against each other) and by a
    (order-signature -> best peak) memo so repeated neighbourhoods are free;
    survivors get the full O(T^2) placement evaluation, and a winning order
    that differs from every seed is promoted to a full :func:`plan_dmo` in
    case the greedy planner family packs it better than the insertion ILS
    did. On a sequential graph (no legal swap) the loop degenerates to
    exactly the placement-only ILS, preserving ``plan_search``'s wins.

    Returns ``(plan, stats)`` — the best plan found (strategy ``joint+dmo``,
    or ``joint:<strategy>`` when the promotion won) and a telemetry dict.
    """
    import random
    import time as _time

    from repro_torch.core.serialise import OrderMoves
    from repro_torch.core.serialise import candidate_orders as _cand_orders

    t0 = _time.time()
    moves = OrderMoves(graph)
    src = [list(o) for o in (orders if orders is not None
                             else [list(graph.ops)] + _cand_orders(graph))]
    seeds_o: List[List[Op]] = []
    seen_sigs = set()
    for o in src:
        sig = moves.signature(o)
        if sig not in seen_sigs:
            seen_sigs.add(sig)
            seeds_o.append(o)

    overlap_fn = _default_overlap(method, profile)
    fn_cache: Dict[Tuple[int, int], int] = {}

    def ov(op: Op, ii: int) -> int:
        k = (id(op), ii)
        v = fn_cache.get(k)
        if v is None:
            v = fn_cache[k] = overlap_fn(op, ii)
        return v

    # per-order evaluation context: O_s values depend only on the op, but
    # *eligibility* (is this the input's last use?) depends on the order
    ctx: Dict[Tuple[int, ...], Tuple[List[Op], Dict, Dict]] = {}

    def context(order: List[Op], sig: Tuple[int, ...]):
        c = ctx.get(sig)
        if c is None:
            scopes = graph.scopes(order)
            overlaps = _compute_overlaps(order, ov, scopes)
            c = ctx[sig] = (list(order), scopes, overlaps)
        return c

    stats: Dict[str, Any] = {
        "orders_tried": 0, "order_moves": 0, "order_accepts": 0,
        "screened_out": 0, "memo_skips": 0, "placement_moves": 0,
        "evals": 0, "promotions": 0,
    }
    memo: Dict[Tuple[int, ...], int] = {}

    def place(order: List[Op], sig: Tuple[int, ...],
              insertion: List[Tensor]):
        o, scopes, overlaps = context(order, sig)
        placed: Dict[Tensor, int] = {}
        for t in insertion:
            placed[t] = _lowest_feasible(t, placed, scopes, o, overlaps)
        peak = max((x + t.nbytes for t, x in placed.items()), default=0)
        stats["evals"] += 1
        prev = memo.get(sig)
        memo[sig] = peak if prev is None else min(prev, peak)
        return peak, placed

    best = None  # (peak, sig, order, insertion, placed)
    for o in seeds_o:
        sig = moves.signature(o)
        _, scopes, _ = context(o, sig)
        tensors = list(scopes)
        stats["orders_tried"] += 1
        for ins in (
            sorted(tensors, key=lambda t: (-t.nbytes, scopes[t][0])),
            sorted(tensors, key=lambda t: (-t.nbytes, -scopes[t][1])),
            sorted(tensors, key=lambda t: (-scopes[t][1], -t.nbytes)),
            sorted(tensors, key=lambda t: (scopes[t][0], -t.nbytes)),
        ):
            p, placed = place(o, sig, ins)
            if best is None or p < best[0]:
                best = (p, sig, list(o), list(ins), placed)
    seed_peak = best[0]  # best achievable without leaving the seed orders

    cur_peak, cur_sig = best[0], best[1]
    cur_order, cur_ins = list(best[2]), list(best[3])
    est = LivePeakEstimator(graph, cur_order)
    legal = moves.legal_swaps(cur_order) if allow_order_moves else []
    rng = random.Random(seed)
    n_t = len(cur_ins)
    rounds = 0
    while (n_t > 2 and _time.time() - t0 < budget_s
           and (max_rounds is None or rounds < max_rounds)):
        rounds += 1
        if legal and rng.random() < order_move_prob:
            stats["order_moves"] += 1
            i = legal[rng.randrange(len(legal))]
            cand = moves.swap(cur_order, i)
            sig = moves.signature(cand)
            floor_before = est.peak
            floor_after = est.swap(i)
            known = memo.get(sig)
            if known is not None and known > cur_peak:
                est.swap(i)  # undo: this neighbourhood is memoised worse
                stats["memo_skips"] += 1
                continue
            if (known is None and floor_after > floor_before
                    and rng.random() < 0.7):
                # the floor estimator says the move raises naive liveness;
                # usually skip, but sometimes explore anyway — a higher
                # floor can still enable a better diagonal overlap
                est.swap(i)
                stats["screened_out"] += 1
                continue
            p, placed = place(cand, sig, cur_ins)
            if p <= cur_peak:
                cur_order, cur_sig, cur_peak = cand, sig, p
                legal = moves.legal_swaps(cur_order)
                stats["order_accepts"] += 1
                if p < best[0]:
                    best = (p, sig, list(cand), list(cur_ins), placed)
            else:
                est.swap(i)
        else:
            stats["placement_moves"] += 1
            nxt = list(cur_ins)
            for _ in range(rng.randint(1, 3)):
                a, b = rng.randrange(n_t), rng.randrange(n_t)
                if rng.random() < 0.5:
                    nxt[a], nxt[b] = nxt[b], nxt[a]
                else:
                    nxt.insert(b, nxt.pop(a))
            p, placed = place(cur_order, cur_sig, nxt)
            if p <= cur_peak:
                cur_ins, cur_peak = nxt, p
                if p < best[0]:
                    best = (p, cur_sig, list(cur_order), list(nxt), placed)
            elif rng.random() < 0.02:  # occasional uphill restart from best
                cur_peak, cur_sig = best[0], best[1]
                cur_order, cur_ins = list(best[2]), list(best[3])
                est.reset(cur_order)
                legal = moves.legal_swaps(cur_order) if allow_order_moves \
                    else []

    p, sig, o, ins, placed = best
    _, _, overlaps = context(o, sig)
    plan = Plan(graph, list(o), placed, overlaps, "joint+dmo")
    if promote and sig not in seen_sigs and p < seed_peak:
        # the winning order is new AND strictly beat every seed order: the
        # greedy planner family may pack it better still than the insertion
        # ILS did (one bounded promotion — gated on a strict order-axis win
        # so big graphs never pay a full plan_dmo for a sideways drift)
        promoted = plan_dmo(graph, o, method=method, profile=profile)
        stats["promotions"] = 1
        if promoted.peak_bytes < plan.peak_bytes:
            plan = Plan(graph, promoted.order, promoted.offsets,
                        promoted.overlaps, f"joint:{promoted.strategy}")
    stats.update(
        rounds=rounds, peak=plan.peak_bytes, wall_s=_time.time() - t0,
        order_changed=sig != moves.signature(seeds_o[0]),
        legal_swaps=len(moves.legal_swaps(plan.order)),
    )
    return plan, stats


def plan_original(graph: Graph, order: Optional[Sequence[Op]] = None) -> Plan:
    """Best non-overlapping baseline (the paper's "Original" column): min of
    the first-fit heap, greedy-by-size, and both modified-heap directions."""
    plans = [
        plan_naive(graph, order),
        plan_greedy_size(graph, order),
        plan_modified_heap(graph, order, None, "forward"),
        plan_modified_heap(graph, order, None, "backward"),
    ]
    return min(plans, key=lambda p: p.peak_bytes)


def best_plan(graph: Graph, orders: Optional[Sequence[Sequence[Op]]] = None,
              strategy: str = "dmo", method: str = "auto") -> Plan:
    """Best (lowest-peak) plan over candidate serialisation orders, as the
    paper does with eager & lazy orders."""
    from repro_torch.core.serialise import candidate_orders

    orders = orders or candidate_orders(graph)
    plans = []
    for o in orders:
        if strategy == "dmo":
            plans.append(plan_dmo(graph, o, method))
        elif strategy == "naive":
            plans.append(plan_naive(graph, o))
        elif strategy == "modified_heap":
            plans.append(plan_modified_heap(graph, o))
        else:
            raise ValueError(strategy)
    return min(plans, key=lambda p: p.peak_bytes)
