"""The streaming program of the port against the JAX package's: window
schedules and streaming specs, each streaming kernel's plain version
against the reference Pallas kernel in interpret mode (whole typed arenas
compared), whole final arenas of the streaming route, the budget gate and
the verify pass.

Inputs are made from seeds with numpy and cross the packages as numpy
arrays. Schedules and specs must be exactly equal. Tolerances are those of
``tests/test_torch_blocks.py``: int8 bit-exact except softmax and sigmoid
(<= 1 LSB: exp differs by an ulp between the two libraries); f32 1e-4
absolute plus 1e-4 relative (the port's plain f32 products sum in
PyTorch's order, the reference's in XLA's). The port's streaming arena is
held bit-equal to its own row-blocked arena in both tiers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo as rzoo
from repro.core.exec import ops as RX
from repro.core.exec.pallas_backend import PallasExecutor, _fused_chains
from repro.core.graph import Graph as RGraph
from repro.core.pipeline import compile as r_compile
from repro.core.planner import legalise_for_blocks as r_legalise
from repro.kernels import arena_ops as R

from repro_torch.core import exec as TXE
from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import compare_outputs, get_backend
from repro_torch.core.exec import cuda_backend as CB
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.graph import Graph as TGraph
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.core.planner import legalise_for_blocks as t_legalise
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import (CS, POOL_QM, QM, _SOFTMAX_QM, _block_spec,
                                _compare_arena, _ew_qmeta, _ref_spec,
                                _rows, _typed_arena, _weight, check_ew_spec)


# ---------------------------------------------------------------------------
# window schedules and streaming specs
# ---------------------------------------------------------------------------

#: label -> (make(package zoo, graph class), compile kwargs): the
#: reference's tests/test_streaming.py _MODELS (stream_allops in both
#: tiers) and the flagship at batch 2
GRAPHS = {
    "mobilenet_v1_0.25_32_f32": (lambda z, G: z.mobilenet_v1(0.25, 32, 4),
                                 {}),
    "mobilenet_v2_0.35_32_f32": (lambda z, G: z.mobilenet_v2(0.35, 32, 4),
                                 {}),
    "mobilenet_v1_0.25_32_8bit": (lambda z, G: z.mobilenet_v1(0.25, 32, 1),
                                  {}),
    "mobilenet_v1_0.25_128_8bit": (
        lambda z, G: z.mobilenet_v1(0.25, 128, 1), {}),
    "mobilenet_v1_0.25_128_8bit_batch2": (
        lambda z, G: z.mobilenet_v1(0.25, 128, 1), {"batch": 2}),
    "stream_allops_f32": (lambda z, G: CS.stream_allops_graph(4, G), {}),
    "stream_allops_int8": (lambda z, G: CS.stream_allops_graph(1, G), {}),
}


def _compile_both(label):
    build, kw = GRAPHS[label]
    ref = r_compile(build(rzoo, RGraph), budget_s=0, verify="off", **kw)
    port = t_compile(build(tzoo, TGraph), budget_s=0, verify="off", **kw)
    return ref, port


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_window_schedules_equal(label):
    ref, port = _compile_both(label)
    want = r_legalise(ref.plan).window_schedule()
    got = t_legalise(port.plan).window_schedule()
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.max_resident_bytes == want.max_resident_bytes
    if label == "mobilenet_v1_0.25_128_8bit":
        forms = [w.kind if w.kind == "fused" else
                 "roll" if w.rolling else "stage" for w in got.windows]
        assert (forms.count("roll"), forms.count("stage"),
                forms.count("fused")) == (25, 3, 1)
        assert got.max_resident_bytes == 122_880


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_stream_specs_equal(label):
    ref, port = _compile_both(label)
    rw = RX.synth_weights(ref.graph, 0)
    rq = RX.calibrate(ref.graph, 0, rw) if RX.needs_quant(ref.graph) \
        else None
    tw = TX.synth_weights(port.graph, 0)
    tq = TX.calibrate(port.graph, 0, tw) if TX.needs_quant(port.graph) \
        else None
    want = PallasExecutor(mode="streaming", interpret=True).lower_stream(
        r_legalise(ref.plan), rq)
    be = CudaExecutor(device="cpu", mode="streaming")
    got = be.lower_stream(t_legalise(port.plan), tq)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert all(s.win_rows > 0 for s in got)
    # the blocked lowering stays streaming-free, and the route lowers the
    # same specs
    assert all(s.win_rows == 0 for s in be.lower_blocks(
        t_legalise(port.plan), tq))
    assert be.program(port, None, tw, quant=tq)[0] == got


# ---------------------------------------------------------------------------
# each streaming kernel's plain version against the reference kernel
# ---------------------------------------------------------------------------


def _rolling(spec: K.OpSpec, total_rows: int) -> K.OpSpec:
    """The spec with a rolling window over an arena of ``total_rows``
    rows, by the planner's rule (``planner.rolling_starts``: a tile of
    ``tile_rows`` output image rows fetches the sublane-aligned input rows
    its valid taps touch, a fixed ``win_in`` rows clamped to the arena's
    end)."""
    from repro_torch.core.planner import tile_arena_rows, tile_rows
    sub = K._sub(spec.dtype)
    conv = spec.kind != "pool"
    kh, sh = spec.meta[0], spec.meta[2]
    dh = spec.meta[4] if conv else 1
    ph = spec.meta[6] if conv else spec.meta[4]
    ci, ki, _ = spec.in_addr[0]
    co, ko, _ = spec.out_addr
    ih, oh = spec.in_shape[0][-3], spec.out_shape[-3]
    tr = tile_rows(co, ko, sub)
    in_rows = -(-ih // ci) if ci > 1 else ih * ki

    def ar_of(r):
        return r // ci if ci > 1 else r * ki

    def ar_top(r):
        return r // ci if ci > 1 else r * ki + ki - 1

    need, tiles = 0, []
    for a in range(0, oh, tr):
        b = min(a + tr, oh)
        lo = min(max(a * sh - ph, 0), ih - 1)
        hi = min(max((b - 1) * sh - ph + (kh - 1) * dh, 0), ih - 1)
        s_t = ar_of(lo) // sub * sub
        tiles.append(s_t)
        need = max(need, ar_top(hi) - s_t + 1)
    win_in = min(-(-need // sub) * sub, -(-in_rows // sub) * sub)
    starts = tuple(max(0, min(spec.in_off[0] + s, total_rows - win_in))
                   for s in tiles)
    return dataclasses.replace(
        spec, out_tile=tr, win_starts=starts,
        win_rows=win_in + tile_arena_rows(co, ko, sub))


def _staged(spec: K.OpSpec) -> K.OpSpec:
    from repro_torch.core.planner import staged_slots
    _, _, total = staged_slots([r for r, _ in spec.in_rows],
                               spec.out_rows[0], K._sub(spec.dtype))
    return dataclasses.replace(spec, win_rows=total)


def _unwritten_lanes(spec: K.OpSpec, shape) -> np.ndarray:
    """The arena elements a rolling op with a packed output carries back
    from its output slot without computing them: lanes past ``c * rl`` of
    each output arena row, and lane phases past the last image row. The
    reference's slot is uninitialised VMEM there (NaN or -128 in interpret
    mode, or a phase an earlier tile left), so its arena holds those bytes;
    the port's slot starts as a copy of the arena rows, so they keep the
    arena's bytes, as in the row-blocked program."""
    mask = np.zeros(shape, bool)
    c, _, rl = K._triple(spec, None)
    if K.stream_form(spec) != "roll" or c == 1:
        return mask
    oh = spec.out_shape[-3]
    for j in range(-(-oh // c)):
        row = mask[spec.out_off + j]
        row[c * rl:] = True
        for phase in range(c):
            if j * c + phase >= oh:
                row[phase * rl:(phase + 1) * rl] = True
    return mask


def _run_both(spec: K.OpSpec, arena: np.ndarray, weights, kernel: str,
              as_blocked: bool = True):
    """The port's plain streaming version against the reference kernel
    (interpret mode) on the same arena, and (``as_blocked``) against the
    port's own plain row-blocked version of the same op, bit for bit."""
    want = np.asarray(R.apply_op(
        jnp.asarray(arena), _ref_spec(spec),
        tuple(jnp.asarray(w) for w in weights), interpret=True))
    t = torch.from_numpy(arena.copy())
    tw = [torch.from_numpy(w) for w in weights]
    w = K.pack_weights(spec, tw) if spec.kind == "fused" else \
        (tw[0] if tw else None)
    assert K.kernel_of(spec) == kernel
    before = dict(K.LAUNCHES)
    K.apply_op(t, spec, w)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    got = t.numpy()
    unwritten = _unwritten_lanes(spec, got.shape)
    _compare_arena(spec, got, np.where(unwritten, got, want))
    blocked = torch.from_numpy(arena.copy())
    K.apply_plain(blocked, dataclasses.replace(
        spec, win_lo=0, win_rows=0, win_starts=(), in_slots=(), out_slot=0),
        w)
    if as_blocked and spec.kind != "fused":  # a chain's has no I/O slots
        np.testing.assert_array_equal(got, blocked.numpy())
    # the descriptor the kernel would read builds for every case
    words = K.descriptor_words(spec)
    assert words[K.S_BODY] % 32 == 0 and len(words) > words[K.S_BODY]
    if K.stream_form(spec) == "stage":  # in place: no copy, arena offsets
        assert K.runs_in_place(spec)
        body = words[words[K.S_BODY]:]
        rowb = spec.rowlen * (1 if spec.dtype == "i8" else 4)
        assert words[K.S_BODY] == 32 and \
            (body[K.D_IN_OFF], body[K.D_OUT_OFF]) == \
            (spec.in_off[0] * rowb, spec.out_off * rowb)
        assert body[K.D_ORDER] == (
            K.chunk_of(spec)[1] if K.runs_chunk_walk(spec)
            else K.softmax_order(spec) if K.runs_softmax_grid(spec)
            else K.product_order(spec))
    elif spec.kind == "fused":   # in place on the arena: no window, no copy
        assert words[K.S_BODY] == 32
        body = words[words[K.S_BODY]:]
        assert body[K.H_NS] == len(spec.stages) and \
            body[K.H_NL] == len(K.chain_schedule(spec).levels)


CONV3 = (3, 3, 1, 1, 1, 1, 1, 1, 1)

#: (id, kind, L, ins, out, meta, extra arena rows): ins/out are (shape,
#: row offset, addressing); the arena ends at the first sublane tile
#: boundary past the last block and the extra rows. Overlaps are the ones
#: the planner's O_s admits (an output below its input by at least the
#: taps' halo, or in place under a stride of 2): a write never reaches a
#: row a later tap reads, so the order of fetches and write-backs cannot
#: show.
ROLL_CASES = [
    ("conv_plain_below_input", "conv2d", 32,
     [((20, 6, 3), 4, "plain")], ((20, 6, 5), 0, "plain"), CONV3, 2),
    ("conv_s2_packed_in_place", "conv2d", 32,
     [((40, 4, 2), 0, "packed")], ((20, 4, 2), 0, "packed"),
     (3, 3, 2, 2, 1, 1, 1, 1, 1), 2),
    ("conv_band_neg_pad_span_out", "conv2d", 8,
     [((24, 4, 3), 0, "span")], ((9, 4, 4), 48, "span"),
     (3, 3, 1, 1, 1, 1, -4, 1, 1), 0),
    ("dw_packed_end_of_arena", "depthwise_conv2d", 64,
     [((70, 6, 4), 3, "packed")], ((70, 6, 4), 0, "packed"), CONV3, 0),
    ("dw_mult2_span_below_input", "depthwise_conv2d", 8,
     [((12, 5, 3), 40, "span")], ((12, 5, 6), 0, "span"),
     (3, 3, 1, 1, 1, 1, 1, 1, 2), 1),
    ("dw_dilated_plain", "depthwise_conv2d", 16,
     [((36, 4, 4), 40, "plain")], ((36, 4, 4), 0, "plain"),
     (3, 3, 1, 1, 2, 2, 2, 2, 1), 0),
    ("pool_max_s2_packed_below_input", "pool", 64,
     [((37, 9, 3), 2, "packed")], ((19, 9, 3), 0, "packed"),
     (3, 3, 2, 1, 1, 1, "max"), 3),
    ("pool_avg_span_below_input", "pool", 16,
     [((14, 6, 4), 8, "span")], ((14, 6, 4), 0, "span"),
     (3, 3, 1, 1, 1, 1, "avg"), 0),
    ("pool_avg_valid_plain", "pool", 32,
     [((34, 8, 4), 0, "plain")], ((17, 4, 4), 34, "plain"),
     (2, 2, 2, 2, 0, 0, "avg"), 0),
]


def _roll_case(case, dtype):
    _, kind, L, ins, out, meta, extra = case
    qm = POOL_QM if kind == "pool" else QM
    spec = _block_spec(kind, L, ins, out, meta, dtype=dtype, qmeta=qm)
    sub = K._sub(dtype)                 # arenas are whole sublane tiles
    rows = -(-(_rows(spec) + extra) // sub) * sub
    return _rolling(spec, rows), rows


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", ROLL_CASES, ids=[c[0] for c in ROLL_CASES])
def test_stream_roll_plain_matches_pallas(case, dtype):
    """Rolling conv2d, depthwise and pool over plain, packed and spanning
    rows, overlapped and in place, a negative-pad band, and fetches
    clamped at the arena's end."""
    spec, rows = _roll_case(case, dtype)
    kind = spec.kind
    ws = [] if kind == "pool" else [_weight(K._weight_shape(spec), dtype, 1)]
    _run_both(spec, _typed_arena(dtype, rows, spec.rowlen, 2), ws,
              "arena_stream_roll")


def test_stream_roll_cases_cover_tiles_and_clamped_fetches():
    """The rolling cases are not degenerate: several tiles in both tiers,
    and fetch starts the arena's end clamps."""
    clamped = set()
    for case in ROLL_CASES:
        for dtype in ("i8", "f32"):
            spec, rows = _roll_case(case, dtype)
            base = _rolling(spec, 10 ** 6)
            if spec.win_starts != base.win_starts:
                clamped.add(dtype)
    assert clamped == {"i8", "f32"}
    for dtype in ("i8", "f32"):
        assert sum(len(_roll_case(c, dtype)[0].win_starts) > 1
                   for c in ROLL_CASES) >= 3


def test_roll_window_clamps_stray_rows_into_the_window():
    """A valid tap row outside the fetched window (a start table the
    planner would never emit) reads the clamped window row, as the
    reference's dynamic slice clamps it, and addresses nothing outside
    the window."""
    case = ("conv_disjoint", "conv2d", 32, [((40, 6, 3), 0, "plain")],
            ((40, 6, 5), 40, "plain"), CONV3, 0)
    spec, rows = _roll_case(case, "f32")
    # a 24-row window from row 0 leaves the last tiles' rows outside it
    assert len(spec.win_starts) == 5 and spec.win_rows - 8 == 24
    bad = dataclasses.replace(spec, win_starts=(0,) * len(spec.win_starts))
    w = _weight(K._weight_shape(spec), "f32", 1)
    _run_both(bad, _typed_arena("f32", rows, spec.rowlen, 3), [w],
              "arena_stream_roll", as_blocked=False)


def test_long_start_table_survives_the_descriptor():
    """A tile is one image row when the output spans >= sub arena rows, so
    the table can outgrow the 26 free words of one descriptor block: the
    stream block carries it whole, any length, with the body after it."""
    spec = _block_spec("conv2d", 2, [((40, 4, 4), 320, "span")],
                       ((40, 4, 4), 0, "span"), CONV3)
    spec, rows = _rolling(spec, 640), 640
    assert spec.out_tile == 1 and len(spec.win_starts) == 40
    words = K.descriptor_words(spec)
    body = words[K.S_BODY]
    assert words[K.S_T] == 40 and body >= K.S_COPY0 + 40
    assert tuple(words[K.S_COPY0:K.S_COPY0 + 40]) == spec.win_starts
    # the body after the whole table: the op's words with the tile
    # kernel's order mode and tiling
    want = K._body_words(K._stream_body(spec), K.buffer_plan(spec))
    tl = K.conv_tiling(spec)
    want[K.D_ORDER] = K.conv_order(spec)
    want[K.D_TILING:K.D_TILING + len(tl)] = tl
    np.testing.assert_array_equal(words[body:], want)
    assert words[body + K.D_KIND] == K._KIND_CODE["conv2d"]
    assert tl.ntiles == 40 * tl.tpr and want[K.D_TILING + 9] == tl.tpr
    _run_both(spec, _typed_arena("f32", rows, 2, 4),
              [_weight((3, 3, 4, 4), "f32", 4)], "arena_stream_roll")


#: the streaming routes whose rolling specs the tile checks cover
ROLL_GRAPHS = {
    "flagship": lambda: tzoo.mobilenet_v1(0.25, 128, 1),
    "resnet50_v2_f32": lambda: tzoo.resnet50_v2(32, 4),
    "resnet50_v2_int8": lambda: tzoo.resnet50_v2(32, 1),
    "stream_allops_f32": lambda: CS.stream_allops_graph(4, TGraph),
    "stream_allops_int8": lambda: CS.stream_allops_graph(1, TGraph),
}
#: test_roll_window_clamps_stray_rows_into_the_window's case (f32: a
#: 24-row window)
STRAY = ("conv_stray_rows", "conv2d", 32, [((40, 6, 3), 0, "plain")],
         ((40, 6, 5), 40, "plain"), CONV3, 0)


#: a rolling depthwise conv in place: a row of streaming tile t + 1 reads
#: a row tile t stored, so its groups of tr rows run one after another
#: (order word 2; the planner never emits it, and the reference's
#: prefetch of tile t + 1 before tile t's write-back would race here)
IN_PLACE = ("dw_in_place_rows", "depthwise_conv2d", 32,
            [((20, 6, 4), 0, "plain")], ((20, 6, 4), 0, "plain"), CONV3, 0)


def _roll_specs(source):
    """The rolling specs of a streaming route, or a hand-built case (the
    stray case with a start table that leaves valid taps outside the
    window)."""
    if source in ROLL_GRAPHS:
        specs = CudaExecutor(device="cpu", mode="streaming").program(
            t_compile(ROLL_GRAPHS[source](), backend="numpy"))[0]
        return [s for s in specs if K.stream_form(s) == "roll"]
    name, dtype = source.rsplit("-", 1)
    case = next(c for c in ROLL_CASES + [STRAY, IN_PLACE] if c[0] == name)
    spec, _ = _roll_case(case, dtype)
    if case is STRAY:
        spec = dataclasses.replace(spec, win_starts=(0,) * len(
            spec.win_starts))
    return [spec]


@pytest.mark.parametrize("source", sorted(ROLL_GRAPHS) + [
    f"{c[0]}-{dt}" for c in ROLL_CASES + [IN_PLACE] for dt in ("i8", "f32")]
    + [f"{STRAY[0]}-f32"])
def test_roll_tiles_keep_the_window_and_the_row_order(source):
    """Every rolling spec of the streaming route (or a hand-built case),
    through the Python mirror of the tile kernel: each tile's staged rows
    are the rows its streaming tile's window gives (rebased on the fetch
    start, clamped into ``win_in`` rows) and lie inside that window; the
    tiles cover every output once; and no store meets a read that the
    order word lets run on the wrong side of it (a read of a later
    streaming tile must follow the store, any other read must precede
    it): brute force over every pair of tiles."""
    specs = _roll_specs(source)
    assert specs
    for spec in specs:
        tl = K.conv_tiling(spec)
        tr, tile_ar = K._tile_geom(spec)
        win_in = spec.win_rows - tile_ar
        rowb = spec.rowlen * (1 if spec.dtype == "i8" else 4)
        c, k, _ = K._triple(spec, 0)
        ih = spec.in_shape[0][-3]
        kh, _, sh, _, dh, _, ph, _, _ = K._conv_meta(spec)
        order = K.descriptor_words(spec)[-K.DESC_WORDS + K.D_ORDER]
        assert order == K.conv_order(spec)
        cover = np.zeros(spec.out_shape[-3:], np.int32)
        stores, reads, clamped = [], [], 0
        for t in range(tl.ntiles):
            r, (x0, x1), (o0, o1) = K.conv_tile_geometry(spec, t)
            cover[r, x0:x1, o0:o1] += 1
            start = spec.win_starts[r // tr]
            rows = []
            for fy in range(kh):
                iy = r * sh - ph + fy * dh
                if 0 <= iy < ih:
                    ar = spec.in_off[0] + (iy // c if c > 1 else iy * k)
                    n = 1 if c > 1 else k
                    rows.append(start + min(max(ar - start, 0), win_in - n))
                    clamped += rows[-1] != ar
            got = K.tile_reads(spec, t)
            assert not got or [lo // rowb for lo, _, _ in got] == rows
            for lo, hi, nbytes in got:
                assert start * rowb <= lo < hi <= (start + win_in) * rowb
                assert 0 < nbytes <= hi - lo
                reads.append((t, r, lo, hi))
            lo, hi = K.conv_row_store(spec, r, (x0, x1))
            if t % tl.tpr == tl.tpr - 1:
                hi = max(hi, K.conv_row_store(spec, r)[1])
            stores.append((t, r, lo, hi))
        assert (cover == 1).all()
        s, rd = np.array(stores), np.array(reads)
        meet = (s[:, None, 2] < rd[None, :, 3]) & \
            (rd[None, :, 2] < s[:, None, 3]) & \
            (s[:, None, 0] != rd[None, :, 0])   # another tile's read
        if order == K.ORDER_DISJOINT:
            assert not meet.any(), spec
        elif order == K.ORDER_STAGED:
            # stores wait for every tile of rows <= theirs to stage: a read
            # of a later row (in this streaming tile or a later one) races
            assert not (meet & (rd[None, :, 1] > s[:, None, 1])).any(), spec
        assert order in (K.ORDER_DISJOINT, K.ORDER_STAGED, K.ORDER_ROWS)
        # the grid must hold every tile that waits on another at once
        grid, group, ctr = K.conv_grid(spec)
        assert group == tl.tpr * (min(tr, spec.out_shape[-3])
                                  if order == K.ORDER_ROWS else 1)
        assert group <= grid <= tl.ntiles
        assert ctr == K.conv_counter_bytes(spec)
        if source in ROLL_GRAPHS:   # the planner's specs never need groups
            assert order != K.ORDER_ROWS
        if source.startswith("conv_stray_rows"):  # taps outside the window
            assert clamped > 0 and order == K.ORDER_DISJOINT
        if source.startswith("dw_in_place_rows"):
            assert order == K.ORDER_ROWS


S3 = (4, 5, 6)


#: (id, kind, L, ins, out, meta, int8 qmeta)
STAGE_CASES = [
    ("add_bcast_packed_to_dense", "elementwise", 64,
     [(S3, 0, "packed"), ((6,), 2, "dense")], (S3, 1, "dense"), ("add",),
     _ew_qmeta("add", 2)),
    ("sigmoid_span_in_place", "elementwise", 16,
     [(S3, 1, "span")], (S3, 1, "span"), ("sigmoid",),
     _ew_qmeta("sigmoid", 1)),
    ("concat_4_span_overlap", "concat", 8,
     [((3, 3, 2), 0, "plain"), ((3, 3, 1), 3, "packed"),
      ((3, 3, 4), 5, "span"), ((3, 3, 2), 11, "plain")],
     ((3, 3, 9), 2, "span"), (-1,),
     (tuple((zp, float(np.float32(m))) for zp, m in
            ((1, 0.5), (-2, 1.0), (0, 1.7), (5, 0.9))), (-1,))),
    ("pad_packed_overlap", "pad", 32,
     [((4, 4, 4), 0, "packed")], ((6, 6, 4), 1, "plain"),
     (((1, 1), (1, 1), (0, 0)),), ((-3, float(np.float32(0.9))), (4,))),
    ("matmul_dense_overlap", "matmul", 16,
     [((16, 8), 0, "dense"), ((8, 2), 9, "dense")], ((16, 2), 6, "dense"),
     (), (3, -2, float(np.float32(0.0123)), 5)),
    ("mean_span_in", "mean", 32,
     [((4, 4, 16), 0, "span")], ((16,), 3, "dense"), ((0, 1),),
     (-3, float(np.float32(1.7)), 2)),
    ("fc_dense_overlap", "fully_connected", 16,
     [((32,), 1, "dense")], ((20,), 0, "dense"), (),
     (4, float(np.float32(0.0021)), -1)),
    ("softmax_dense_in_place", "softmax", 16,
     [((50,), 1, "dense")], ((50,), 1, "dense"), (), _SOFTMAX_QM),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", STAGE_CASES,
                         ids=[c[0] for c in STAGE_CASES])
def test_stream_stage_plain_matches_pallas(case, dtype):
    """Staged elementwise, concat, pad, matmul, mean, fully_connected and
    softmax, in place on the arena, against the reference's staged kernel
    (every block copied into its window slot, the output block copied
    back) and the port's blocked plain version."""
    _, kind, L, ins, out, meta, qm = case
    spec = _staged(_block_spec(kind, L, ins, out, meta, dtype=dtype,
                               qmeta=qm))
    ws = ([_weight(K._weight_shape(spec), dtype, 3)]
          if kind == "fully_connected" else [])
    _run_both(spec, _typed_arena(dtype, _rows(spec) + 2, L, 4), ws,
              "arena_stream_stage")


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", [c for c in STAGE_CASES
                                  if c[1] == "elementwise"],
                         ids=[c[0] for c in STAGE_CASES
                              if c[1] == "elementwise"])
def test_ew_order_word_matches_the_byte_ranges(case, dtype):
    """The staged elementwise cases run the grid body in place on the
    arena: their order word from the arena byte ranges, brute force
    (``_torch_block_cases.check_ew_spec``); no window is staged."""
    _, kind, L, ins, out, meta, qm = case
    spec = _staged(_block_spec(kind, L, ins, out, meta, dtype=dtype,
                               qmeta=qm))
    assert K.stream_form(spec) == "stage" and K.runs_ew_grid(spec)
    order = check_ew_spec(spec)
    assert order == {"add_bcast_packed_to_dense": K.EW_OVERLAP,
                     "sigmoid_span_in_place": K.EW_ALIGNED}[case[0]]
    assert "win" not in {n for n, _, _ in K.buffer_plan(spec).parts}


def _flagship_stream_fused(bits: int):
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    g = cp.graph
    w = TX.synth_weights(g, 0)
    q = TX.calibrate(g, 0, w) if bits == 1 else None
    be = CudaExecutor(device="cpu", mode="streaming")
    bplan = be.legalised(cp.plan)
    (spec,) = [s for s in be.lower_stream(bplan, q) if s.kind == "fused"]
    members = [op for op in cp.plan.order if op.params.get("fuse_chain")]
    ws = [q.weights_q[id(op)]["filter"] if q is not None
          else w[id(op)]["filter"]
          for op in members if op.kind in K.WEIGHTED_KINDS]
    return spec, ws, bplan


@pytest.mark.parametrize("bits", [1, 4])
def test_stream_fused_plain_matches_pallas(bits):
    """The flagship's band chain in its streaming form (17 stages, every
    operand scratch-resident) on a seeded full-size arena; the reference's
    window is the include_io scratch (98,304 B int8, 229,376 B f32). The
    card's kernel keeps no window: its counters and the stages' regions
    take the global workspace, each tile's footprint and filter chunks
    shared memory."""
    spec, ws, bplan = _flagship_stream_fused(bits)
    assert len(spec.stages) == 17 and spec.win_rows == spec.scratch_rows
    assert all(all(st.in_scratch) and st.out_scratch for st in spec.stages)
    row_bytes = bplan.arena_rowlen * (1 if bits == 1 else 4)
    assert spec.win_rows * row_bytes == (98_304 if bits == 1 else 229_376)
    parts = {n: g for n, g, _ in K.buffer_plan(spec).parts}
    assert parts == {"ctr": True, "regions": True, "tile": False,
                     "wts": False}
    dtype = "i8" if bits == 1 else "f32"
    _run_both(spec, _typed_arena(dtype, bplan.total_rows,
                                 bplan.arena_rowlen, 5), ws,
              "arena_stream_fused")


# ---------------------------------------------------------------------------
# whole final arenas of the streaming route
# ---------------------------------------------------------------------------


def _ref_final_arena(cp, inputs, w, q) -> np.ndarray:
    """The reference's PallasExecutor(mode="streaming", interpret=True)
    program run on its seeded arena, returning the whole final arena
    (``execute`` returns only the outputs); weights in its execute's
    order."""
    be = PallasExecutor(mode="streaming", interpret=True)
    bplan = r_legalise(cp.plan)
    specs = be.lower_stream(bplan, q)

    def w_of(op):
        if q is not None and id(op) in q.weights_q:
            return jnp.asarray(q.weights_q[id(op)]["filter"], jnp.int8)
        return jnp.asarray(w[id(op)]["filter"], jnp.float32)

    wflat, emitted = [], set()
    chains = _fused_chains(cp.plan.order)
    for op in cp.plan.order:
        if op.kind == "reshape":
            continue
        cname = op.params.get("fuse_chain")
        members = [op]
        if cname is not None:
            if cname in emitted:
                continue
            emitted.add(cname)
            members = chains[cname]
        for m in members:
            if m.kind in R.WEIGHTED_KINDS:
                wflat += [w_of(m)] * m.output.storage().batch
    arena = be._seed_block_arena(bplan, cp.graph, inputs)
    return np.asarray(R.lower_program(specs, True)(jnp.asarray(arena),
                                                   *wflat))


def _port_final_arena(be, cp, inputs, w, q) -> np.ndarray:
    specs, ws, _, arena = be.program(cp, inputs, w, quant=q)
    for spec, wt in zip(specs, ws):
        K.apply_op(arena, spec, wt)
    return arena.numpy()


#: label -> (make(package zoo, graph class), compile kwargs)
ROUTE_GRAPHS = {
    "flagship_int8": (lambda z, G: z.mobilenet_v1(0.25, 128, 1), {}),
    "mobilenet_v1_0.25_32_f32": (lambda z, G: z.mobilenet_v1(0.25, 32, 4),
                                 {}),
    "mobilenet_v1_0.25_32_8bit_batch2": (
        lambda z, G: z.mobilenet_v1(0.25, 32, 1), {"batch": 2}),
    "stream_allops_f32": (lambda z, G: CS.stream_allops_graph(4, G), {}),
    "stream_allops_int8": (lambda z, G: CS.stream_allops_graph(1, G), {}),
}


@pytest.mark.parametrize("label", sorted(ROUTE_GRAPHS))
def test_streaming_route_final_arena(label):
    """get_backend("cuda", device="cpu", mode="streaming"): the final typed
    arena is bit-equal to the port's row-blocked arena (every tier) and to
    the reference's streaming arena (int8; f32 within tolerance), and the
    outputs match the numpy backend."""
    build, kw = ROUTE_GRAPHS[label]
    ref = r_compile(build(rzoo, RGraph), verify="off", **kw)
    port = t_compile(build(tzoo, TGraph), verify="off", **kw)
    rw = RX.synth_weights(ref.graph, 0)
    rq = RX.calibrate(ref.graph, 0, rw) if RX.needs_quant(ref.graph) \
        else None
    inputs = (RX.quant_inputs(ref.graph, rq, 0) if rq is not None
              else RX.random_inputs(ref.graph, 0))
    tw, tq = TX.params_from_reference(ref.graph, rw, rq, port.graph)
    st = get_backend("cuda", device="cpu", mode="streaming")
    got = _port_final_arena(st, port, inputs, tw, tq)
    blocked = _port_final_arena(CudaExecutor(device="cpu", layout="blocks"),
                                port, inputs, tw, tq)
    np.testing.assert_array_equal(got, blocked)
    want = _ref_final_arena(ref, inputs, rw, rq)
    assert got.shape == want.shape and got.dtype == want.dtype
    if rq is not None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    outs = st.execute(port, inputs, tw, quant=tq)
    compare_outputs(get_backend("numpy").execute(port, inputs, tw, quant=tq),
                    outs, exact=False, label=f"{label} streaming vs numpy")
    if label == "flagship_int8":
        specs = st.program(port, inputs, tw, quant=tq)[0]
        assert len(specs) == 29 and got.nbytes == 73_728
        assert {K.kernel_of(s) for s in specs} == {
            "arena_stream_roll", "arena_stream_stage", "arena_stream_fused"}


def test_streaming_flagship_batch2_matches_blocked():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, 1), batch=2, verify="off")
    got = CudaExecutor(device="cpu", mode="streaming").execute(cp)
    want = CudaExecutor(device="cpu", layout="blocks").execute(cp)
    assert got["prob_out"].shape == (2, 1000)
    np.testing.assert_array_equal(got["prob_out"], want["prob_out"])


# ---------------------------------------------------------------------------
# plumbing: the budget gate, the env knob, the verify pass
# ---------------------------------------------------------------------------


def test_streaming_refuses_over_budget_window():
    """The reference's gate (tests/test_streaming.py): a budget one byte
    under the largest resident window refuses the plan; the window itself
    is admitted and the route matches the numpy backend."""
    cp = t_compile(tzoo.mobilenet_v2(0.35, 96, 1), verify="off")
    ref = r_compile(rzoo.mobilenet_v2(0.35, 96, 1), verify="off")
    ws = t_legalise(cp.plan).window_schedule()
    assert ws.max_resident_bytes == \
        r_legalise(ref.plan).window_schedule().max_resident_bytes
    with pytest.raises(ValueError, match="does not fit"):
        CudaExecutor(device="cpu", mode="streaming",
                     vmem_budget=ws.max_resident_bytes - 1).execute(cp)
    with pytest.raises(ValueError, match="does not fit VMEM"):
        PallasExecutor(mode="streaming", interpret=True,
                       vmem_budget=ws.max_resident_bytes - 1).execute(ref)
    out = CudaExecutor(device="cpu", mode="streaming",
                       vmem_budget=ws.max_resident_bytes).execute(cp)
    compare_outputs(get_backend("numpy").execute(cp), out, exact=False,
                    label="budget-admitted stream")


def test_budget_env_knob(monkeypatch):
    be = CudaExecutor(device="cpu", mode="streaming")
    monkeypatch.delenv("REPRO_DMO_VMEM_BUDGET", raising=False)
    assert be._resolve_budget() == CB.DEFAULT_VMEM_BUDGET == 16 * 1024 ** 2
    monkeypatch.setenv("REPRO_DMO_VMEM_BUDGET", "4096")
    assert be._resolve_budget() == 4096
    assert CudaExecutor(device="cpu", mode="streaming",
                        vmem_budget=99)._resolve_budget() == 99
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1), verify="off")
    with pytest.raises(ValueError, match="4096-byte budget"):
        be.execute(cp)


def test_streaming_lowering_is_cached_per_route():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1), verify="off")
    be = CudaExecutor(device="cpu", mode="streaming")
    assert be.layout == "auto"
    first = be.program(cp)[0]
    assert be.program(cp)[0] is first
    info = be.lowering_cache_info()
    assert (info["misses"], info["hits"]) == (1, 1)


def test_verify_pass_covers_streaming_tier(monkeypatch):
    """compile(backend="cuda") verifies the flat, row-blocked and streaming
    tiers, as the reference's compile(backend="pallas") does; run here with
    the cuda backend's default device pointed at the CPU."""
    monkeypatch.setitem(TXE._FACTORIES, "cuda",
                        lambda **kw: CudaExecutor(**{"device": "cpu", **kw}))
    monkeypatch.delitem(TXE._INSTANCES, "cuda", raising=False)
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1), backend="cuda",
                   verify="numeric", cache=False)
    assert cp.verified == "numeric+cuda"
    assert any("(flat + row-blocked + streaming)" in line
               for line in cp.log), cp.log
