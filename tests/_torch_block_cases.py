"""Helpers shared by the port's row-blocked and streaming kernel tests
(``tests/test_torch_blocks.py``, ``tests/test_torch_stream.py``): the chip
script as a module, hand-built row-blocked specs over every addressing,
seeded typed arenas and weights, and the whole-arena comparison."""
import dataclasses
import importlib.util
import pathlib

import numpy as np

from repro.kernels import arena_ops as R

from repro_torch.kernels import arena_ops as K

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    """The chip script as a module (its spec makers need no card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _ref_spec(spec: K.OpSpec) -> R.OpSpec:
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(K.OpSpec)}
    fields["stages"] = tuple(_ref_spec(s) for s in spec.stages)
    return R.OpSpec(**fields)


def _place(shape, how: str, L: int):
    """``((rows, used), triple)`` of one operand under an addressing:
    ``legacy``/``plain`` (one image row per arena row), ``packed``
    (``L // rl`` image rows per arena row), ``span`` (one image row over
    ``ceil(rl / L)`` arena rows) or ``dense`` (every arena row used)."""
    n = K._elems(shape)
    if how == "dense":
        return (-(-n // L), L), (1, 1, L)
    rl = K._elems(shape[-2:])
    h = n // rl
    if how in ("legacy", "plain"):
        assert rl <= L
        return (h, rl), (1, 1, rl)
    if how == "packed":
        c = L // rl
        assert c > 1
        return (-(-h // c), c * rl), (c, 1, rl)
    k = -(-rl // L)
    assert how == "span" and k > 1
    return (h * k, L), (1, k, rl)


def _block_spec(kind, L, ins, out, meta=(), legacy=False, dtype="f32",
                qmeta=()):
    """A row-blocked spec: ``ins`` and ``out`` are ``(shape, row offset,
    addressing)``; ``legacy`` drops the addressing triples (the
    reference's pre-packing specs)."""
    pin = [_place(s, how, L) for s, _, how in ins]
    pout = _place(out[0], out[2], L)
    extra = {} if legacy else dict(
        in_addr=tuple(p[1] for p in pin), out_addr=pout[1])
    return K.OpSpec(kind=kind, in_off=tuple(o for _, o, _ in ins),
                    in_shape=tuple(tuple(s) for s, _, _ in ins),
                    out_off=out[1], out_shape=tuple(out[0]), dtype=dtype,
                    meta=meta, qmeta=qmeta if dtype == "i8" else (),
                    rowlen=L, in_rows=tuple(p[0] for p in pin),
                    out_rows=pout[0], **extra)


def _rows(spec: K.OpSpec) -> int:
    """Arena rows a spec's operands reach."""
    ends = [o + r for o, (r, _) in zip(spec.in_off, spec.in_rows)]
    return max(ends + [spec.out_off + spec.out_rows[0]])


def _typed_arena(dtype: str, rows: int, L: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "i8":
        return rng.integers(-128, 128, (rows, L)).astype(np.int8)
    return rng.standard_normal((rows, L)).astype(np.float32)


def _weight(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    if dtype == "i8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 0.3).astype(np.float32)


def _compare_arena(spec: K.OpSpec, got: np.ndarray, want: np.ndarray):
    """Rows outside the written block equal; inside within tolerance."""
    lo, hi = spec.out_off, spec.out_off + spec.out_rows[0]
    outside = np.ones(got.shape[0], bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if spec.dtype == "i8":
        np.testing.assert_allclose(got[lo:hi].astype(np.int32),
                                   want[lo:hi].astype(np.int32), rtol=0,
                                   atol=CS.lsb_limit(spec))
    else:
        np.testing.assert_allclose(got[lo:hi], want[lo:hi], rtol=1e-4,
                                   atol=1e-4)


QM = (-3, float(np.float32(0.0123)), 5)
POOL_QM = (-3, float(np.float32(0.87)), 5)


def _ew_qmeta(fn: str, n_in: int):
    in_q = ((0.05, 3), (0.07, -2))[:n_in]
    out_q = (1 / 256, -128) if fn == "sigmoid" else (0.09, 1)
    return (tuple((float(np.float32(sc)), zp) for sc, zp in in_q),
            (float(np.float32(out_q[0])), out_q[1]))


_SOFTMAX_QM = ((float(np.float32(0.05)), 3), (float(np.float32(1 / 256)),
                                              -128))


def _elem_at(a, e):
    """``elem_at`` of the kernels over an array of tensor elements ``e``
    (``a``: :func:`arena_ops.operand_addr`)."""
    _, L, _, k, rl, used, _ = a
    if k > 1:
        return (e // rl) * k * L + e % rl
    return e if L == used else (e // used) * L + e % used


def _elem_of(a, b, n):
    """``elem_of`` of the kernels: the tensor element each output block
    element ``b`` holds, -1 for padding."""
    _, L, _, k, rl, used, _ = a
    r, j = b // L, b % L
    if k > 1:
        col = (r % k) * L + j
        e = np.where(col < rl, (r // k) * rl + col, -1)
    else:
        e = np.where(j < used, r * used + j, -1)
    return np.where(e < n, e, -1)


def check_ew_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of an elementwise spec the grid body
    runs; returns its order word after checking it and its tiling.

    - Order 0: no byte an input element is read from is written (output
      elements and the block's padding alike).
    - Order 1: every input element's bytes are unwritten or exactly the
      bytes of the same output element (so one thread reads and writes
      them); any spec that is neither has order 2.
    - The chunks cover the output block once; a 16-byte unit holds
      padding only or consecutive elements, each operand that is not
      broadcast reads them from one 16-byte aligned run; order 2 takes a
      resident grid, its counter and a chunk's staging, orders 0 and 1 no
      buffer."""
    assert K.runs_ew_grid(spec)
    isz = 1 if spec.dtype == "i8" else 4
    bcast, dims, strides = K._ew_broadcast(spec)
    n = K._elems(dims)
    oa = K.operand_addr(spec, None)
    nblk = oa[6]
    e_out = _elem_of(oa, np.arange(nblk), n)
    lo = min([oa[0]] + list(spec.in_off))
    hi = max(K._byte_range(spec, i)[1]
             for i in [None] + list(range(len(spec.in_off))))
    writer = np.full(hi - lo, -1, np.int64)     # tensor element, -2 padding
    pos = oa[0] - lo + np.arange(nblk) * isz
    for j in range(isz):
        writer[pos + j] = np.where(e_out >= 0, e_out, -2)
    e = np.arange(n)
    reads = []                                   # (byte, element) per input
    for i in range(len(spec.in_off)):
        src = e
        if i == 1 and bcast:
            coords = np.unravel_index(e, dims)
            src = sum(c * s for c, s in zip(coords, strides))
        at = K.operand_addr(spec, i)
        base = at[0] - lo + _elem_at(at, src) * isz
        reads.append(np.stack([writer[base + j] for j in range(isz)]))
    disjoint = all((r == -1).all() for r in reads)
    aligned = all(((r == -1) | (r == e)).all() and
                  ((r == -1).all(0) | (r == e).all(0)).all() for r in reads)
    order = int(K.descriptor_words(spec)[-K.DESC_WORDS + K.D_ORDER])
    assert order == K.ew_order(spec)
    if order == K.EW_DISJOINT:
        assert disjoint, spec
    elif order == K.EW_ALIGNED:
        assert aligned, spec
    if not disjoint and not aligned:
        assert order == K.EW_OVERLAP, spec
    t = K.ew_tiling(spec)
    words = K.descriptor_words(spec)[-K.DESC_WORDS:]
    assert tuple(words[K.D_TILING:K.D_TILING + 4]) == tuple(t)
    assert t.units * t.vec == nblk and t.vec in (1, 16 // isz)
    cover = np.zeros(t.units, np.int32)
    for c in range(t.chunks):
        cover[c * t.per:min((c + 1) * t.per, t.units)] += 1
    assert (cover == 1).all()
    if t.vec > 1:
        units = e_out.reshape(t.units, t.vec)
        pad = (units == -1).all(1)
        assert (pad | (units == units[:, :1] + np.arange(t.vec)).all(1)).all()
        first = units[~pad, 0]
        for i in [None] + list(range(len(spec.in_off))):
            if i == 1 and bcast:
                continue
            at = K.operand_addr(spec, i)
            run = _elem_at(at, first[:, None] + np.arange(t.vec))
            assert (run == run[:, :1] + np.arange(t.vec)).all()
            assert ((at[0] + run[:, 0] * isz) % 16 == 0).all()
    bp = K.buffer_plan(spec)
    grid, group, ctr = K.chunk_grid(spec)
    assert grid == t.chunks <= (K.EW_RESIDENT if order == K.EW_OVERLAP
                                else K.EW_GRID)
    if order == K.EW_OVERLAP:
        assert group == grid and ctr == K.EW_COUNTER_BYTES
        assert bp.parts[0] == ("ctr", True, 0) and bp.parts[1][0] == "chunk"
    else:
        assert (group, ctr) == (0, 0) and bp == K.BufferPlan(0, 0, ())
    return order


def check_grid_words(spec: K.OpSpec, order: int, t) -> None:
    """The descriptor, buffers and grid of a chunk-walk spec: the order
    word and the tiling in the (last) op descriptor, a streaming spec in
    place (no window, no copy, arena offsets); the chunks cover every unit
    once; orders 0 and 1 need no buffer and no waits, order 2 a resident
    grid, its counter and one chunk's staging."""
    words = K.descriptor_words(spec)
    body = words[-K.DESC_WORDS:]
    assert body[K.D_ORDER] == order
    assert tuple(body[K.D_TILING:K.D_TILING + 4]) == tuple(t)
    assert (body[K.D_IN_OFF], body[K.D_OUT_OFF]) == (
        K.operand_addr(spec, 0)[0], K.operand_addr(spec, None)[0])
    if spec.win_rows:
        assert K.kernel_of(spec) == "arena_stream_stage"
        assert words[K.S_BODY] == 32   # the stream block: no copy list
    cover = np.zeros(t.units, np.int32)
    for c in range(t.chunks):
        cover[c * t.per:min((c + 1) * t.per, t.units)] += 1
    assert (cover == 1).all()
    bp = K.buffer_plan(spec)
    grid, group, ctr = K.chunk_grid(spec)
    assert grid == t.chunks <= (K.EW_RESIDENT if order == K.EW_OVERLAP
                                else K.EW_GRID)
    if order == K.EW_OVERLAP:
        assert (group, ctr) == (grid, K.EW_COUNTER_BYTES)
        assert bp.parts[0] == ("ctr", True, 0) and bp.parts[1][0] == "chunk"
    else:
        assert (group, ctr) == (0, 0) and bp == K.BufferPlan(0, 0, ())


def arena_bytes(spec: K.OpSpec, i):
    """Arena bytes [lo, hi) of input i (None: the output), from the spec's
    fields alone."""
    isz = 1 if spec.dtype == "i8" else 4
    off = spec.out_off if i is None else spec.in_off[i]
    if not spec.rowlen:
        shape = spec.out_shape if i is None else spec.in_shape[i]
        return off, off + K._elems(shape) * isz
    rows = spec.out_rows[0] if i is None else spec.in_rows[i][0]
    row_b = spec.rowlen * isz
    return off * row_b, (off + rows) * row_b


def tile_conflicts(spec: K.OpSpec) -> bool:
    """Brute force over a tile kernel's tiles: does any tile's store (its
    columns and, for a row's last tile, the row's zeroed rest) meet the
    read footprint of a tile of a later row?"""
    tl = K.conv_tiling(spec)
    stores, reads = [], []
    for t in range(tl.ntiles):
        r, cols, _ = K.conv_tile_geometry(spec, t)
        lo, hi = K.conv_row_store(spec, r, cols)
        if t % tl.tpr == tl.tpr - 1:
            hi = max(hi, K.conv_row_store(spec, r)[1])
        stores.append((r, lo, hi))
        reads += [(r, a, b) for a, b in K.conv_row_reads(spec, r, cols)]
    if not reads:
        return False
    s, rd = np.array(stores), np.array(reads)
    meet = (s[:, None, 1] < rd[None, :, 2]) & (rd[None, :, 1] < s[:, None, 2])
    return bool((meet & (s[:, None, 0] < rd[None, :, 0])).any())


def check_tile_spec(spec: K.OpSpec) -> int:
    """A conv or pool spec of the flat or row-blocked program through the
    checks of its row tiles; returns its order word. The disjoint word is
    the byte ranges' disjointness; no tile's store meets the reads of a
    tile of a later row (the invariant the kernel's waits rely on), so no
    planner spec needs its rows run one after another; the tiles cover
    every output once; every footprint fits its shared memory budget or
    lies in per-CTA slices of the workspace, after the counters."""
    assert K.kernel_of(spec) in ("arena_conv", "arena_pool")
    (ilo, ihi), (olo, ohi) = arena_bytes(spec, 0), arena_bytes(spec, None)
    words = K.descriptor_words(spec)
    disjoint = ihi <= olo or ohi <= ilo
    assert (words[K.D_ORDER] == K.ORDER_DISJOINT) == disjoint
    assert not tile_conflicts(spec)
    assert words[K.D_ORDER] != K.ORDER_ROWS
    tl = K.conv_tiling(spec)
    assert tuple(words[K.D_TILING:K.D_TILING + len(tl)]) == tuple(tl)
    cover = np.zeros(spec.out_shape[-3:], np.int32)
    for t in range(tl.ntiles):
        r, (x0, x1), (o0, o1) = K.conv_tile_geometry(spec, t)
        cover[r, x0:x1, o0:o1] += 1
    assert (cover == 1).all()
    isz = 1 if spec.dtype == "i8" else 4
    kh = spec.meta[0]
    assert tl.fp >= kh * tl.fw * tl.ps * isz and tl.fp % 16 == 0
    # eight consecutive footprint columns start in distinct banks
    assert tl.ps >= tl.ib and len({(i * tl.ps * isz // 4) % 32
                                   for i in range(8)}) == 8
    bp = K.buffer_plan(spec)
    assert bp.parts[0] == ("ctr", True, 0)
    wbytes = 2 * tl.ch * tl.to * isz    # filter chunks, always shared
    assert tl.ch == (0 if tl.vo == 1 else min(
        spec.in_shape[0][-1], K.CONV_WCHUNK_BYTES // (tl.to * isz)))
    if tl.fp <= K.CONV_SMEM_BUDGET:
        assert bp.parts[1:] == (("tile", False, 0),
                                ("wts", False, tl.fp))
        assert bp.smem == tl.fp + -(-wbytes // 16) * 16
    else:
        assert bp.parts[2] == ("wts", False, 0)
        assert bp.on_global("tile") and bp.gbytes >= \
            K.conv_counter_bytes(spec) + K.CONV_SLICES * tl.fp
    grid, tpr, ctr = K.conv_grid(spec)
    assert tpr == tl.tpr <= grid <= tl.ntiles and ctr == \
        K.conv_counter_bytes(spec) >= 16 + 4 * spec.out_shape[-3]
    return int(words[K.D_ORDER])


def fc_items(t) -> np.ndarray:
    """How many items of FC tiling ``t`` read each W element (idim x odim
    from the caller's slice), by the kernel's mapping: item ``i`` is column
    block ``i // nks``, K slice ``i % nks``; warp ``w`` of it reads rows
    ``ks * bk + w * rpt ..`` (``rpt`` of them), lane ``l`` columns ``cb *
    bo + 4 * l ..`` (four)."""
    rows = t.nks * t.bk
    cols = t.ncb * t.bo
    count = np.zeros((rows, cols), np.int32)
    for i in range(t.ctas):
        cb, ks = divmod(i, t.nks)
        for w in range(K.FC_WARPS):
            k0 = ks * t.bk + w * t.rpt
            for lane in range(32):
                o0 = cb * t.bo + 4 * lane
                count[k0:k0 + t.rpt, o0:o0 + 4] += 1
    return count


def check_fc_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a fully connected spec the grid body
    runs; returns its order word after checking it, its tiling and its
    buffers.

    - Order 0 exactly when no byte of x lies in the output's block (its
      elements or its padding), which the kernel may write at any time;
      else order 2, whose every CTA reads x before the grid-wide barrier.
    - The tiling's items read every W element exactly once, within
      :data:`arena_ops.FC_GRID` CTAs where W has the rows for it.
    - The descriptor carries the order word and the tiling; the workspace
      holds the counters, then the partials (one 4-byte sum per K slice
      and output), and a CTA's warp sums take shared memory."""
    assert K.runs_product_grid(spec) and spec.kind == "fully_connected"
    isz = 1 if spec.dtype == "i8" else 4
    m, idim, odim = K._fc_geometry(spec)
    xa, oa = K.operand_addr(spec, 0), K.operand_addr(spec, None)
    x_bytes = xa[0] + (_elem_at(xa, np.arange(m * idim))[:, None] * isz
                       + np.arange(isz)).reshape(-1)
    lo, hi = oa[0], oa[0] + oa[6] * isz
    meets = bool(((x_bytes >= lo) & (x_bytes < hi)).any())
    order = K.fc_order(spec)
    assert order == (K.EW_OVERLAP if meets else K.EW_DISJOINT), spec
    t = K.fc_tiling(spec)
    count = fc_items(t)
    assert (count[:idim, :odim] == 1).all()
    assert t.ctas == t.ncb * t.nks and t.bo == K.FC_COLS
    assert t.ctas <= max(K.FC_GRID, t.ncb)
    words = K.descriptor_words(spec)
    if spec.win_rows:    # in place: no window, no copy, arena offsets
        assert words[K.S_BODY] == 32   # the stream block: no copy list
    body = words[-K.DESC_WORDS:]
    assert (body[K.D_KIND], body[K.D_IN_OFF], body[K.D_OUT_OFF]) == (
        K.K_FC, xa[0], oa[0])
    assert (body[K.D_M], body[K.D_IDIM], body[K.D_ODIM]) == (m, idim, odim)
    assert body[K.D_ORDER] == order
    assert tuple(body[K.D_TILING:K.D_TILING + len(t)]) == tuple(t)
    ctr = K.fc_counter_bytes(spec)
    assert ctr % 16 == 0 and (ctr >= 16 + 4 * t.ncb or (
        ctr == 0 and t.nks == 1 and order == K.EW_DISJOINT))
    part = 4 * t.nks * m * odim
    assert K.buffer_plan(spec) == K.BufferPlan(
        4 * K.FC_WARPS * K.FC_COLS, ctr + -(-part // 16) * 16,
        (("ctr", True, 0), ("part", True, ctr), ("red", False, 0)))
    assert tuple(body[K.BUFFER_WORD["part"]:][:2]) == (1, ctr)
    assert tuple(body[K.BUFFER_WORD["red"]:][:2]) == (0, 0)
    assert K.fc_grid(spec) == (t.ctas, t.ctas if order == K.EW_OVERLAP
                               else 0, ctr)
    return order
