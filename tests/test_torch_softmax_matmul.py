"""The softmax grid of ``arena_softmax`` and the product grid that
``arena_matmul`` now shares with ``arena_fully_connected``, and the staged
softmax and matmul bodies of ``arena_stream_stage`` (in place on the
arena), through their Python mirrors: hand-built specs on flat, blocked,
packed and spanning placements (disjoint, in place, shifted over another
row or over an operand) and the zoo's softmaxes and matmuls on the flat,
blocked and streaming programs, through a brute-force byte check of the
order word, the tiling, the descriptor and the buffers; a numpy model of
each grid's summation order against the plain versions; the plain
versions against the JAX package's Pallas kernels in interpret mode
(softmax int8 within 1 LSB, matmul int8 bit for bit, f32 1e-4); and the
streaming program's final arena bit-equal to the blocked one through the
in-place route.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arena_ops as R

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.core.planner import staged_slots
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import (CS, _block_spec, _elem_at, _elem_of,
                                _ref_spec, _rows, _typed_arena, arena_bytes)

ROUTES = {"flat": {}, "blocks": {"layout": "blocks"},
          "streaming": {"mode": "streaming"}}


def _isz(spec: K.OpSpec) -> int:
    return 1 if spec.dtype == "i8" else 4


def _element_bytes(spec: K.OpSpec, i, e: np.ndarray) -> np.ndarray:
    """Every arena byte of tensor elements ``e`` of input ``i``."""
    a = K.operand_addr(spec, i)
    isz = _isz(spec)
    return (a[0] + _elem_at(a, e)[:, None] * isz + np.arange(isz)).reshape(-1)


def _out_holders(spec: K.OpSpec, n: int):
    """(first byte of the output's block, per byte of the block the tensor
    element it holds, -2 in the padding)."""
    oa = K.operand_addr(spec, None)
    e = _elem_of(oa, np.arange(oa[6]), n)
    return oa[0], np.repeat(np.where(e >= 0, e, -2), _isz(spec))


def _blocks_meet(spec: K.OpSpec, inputs) -> bool:
    olo, ohi = arena_bytes(spec, None)
    return any(lo < ohi and olo < hi
               for lo, hi in (arena_bytes(spec, i) for i in inputs))


def _check_in_place(spec: K.OpSpec, words: np.ndarray) -> None:
    """A staged spec runs in place: no window, no copy, arena offsets."""
    if spec.win_rows:
        assert K.kernel_of(spec) == "arena_stream_stage"
        assert K.runs_in_place(spec)
        assert words[K.S_BODY] == 32   # the stream block: no copy list
        assert "win" not in {n for n, _, _ in K.buffer_plan(spec).parts}
        assert CS.card_staging_bytes(K, spec) == 0
    body = words[-K.DESC_WORDS:]
    assert (body[K.D_IN_OFF], body[K.D_OUT_OFF]) == (
        K.operand_addr(spec, 0)[0], K.operand_addr(spec, None)[0])


# ---------------------------------------------------------------------------
# the softmax grid
# ---------------------------------------------------------------------------

def check_softmax_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a softmax the grid runs; returns its
    order word after checking it, its tiling, descriptor, buffers and grid.

    - Order 0 exactly when the operands' blocks are disjoint; else 1
      exactly when every input byte inside the output's block lies in an
      output element of its own row (none in padding); else 2.
    - The tiling: past 264 rows of at most 1,024 values a warp a row, 16
      bytes' worth of columns a group; else a CTA a row, a column a
      thread, through a buffer; the groups cover the row.
    - Every row goes to exactly one warp (or CTA) of the grid."""
    assert K.runs_softmax_grid(spec)
    rows, last = K._softmax_geometry(spec)
    n = rows * last
    lo, holder = _out_holders(spec, n)
    hrow = np.where(holder >= 0, holder // last, -2)
    e = np.arange(n)
    at = _element_bytes(spec, 0, e) - lo
    row = np.repeat(e // last, _isz(spec))
    inside = (at >= 0) & (at < holder.size)
    own = bool((hrow[at[inside]] == row[inside]).all())
    order = K.softmax_order(spec)
    if not _blocks_meet(spec, [0]):
        assert order == K.EW_DISJOINT
    else:
        assert order == (K.EW_ALIGNED if own else K.EW_OVERLAP), spec
    t = K.softmax_tiling(spec)
    warp = rows > K.SM_FEW_ROWS and last <= 32 * K.SM_WARP_VALS
    assert t.vec == (16 // _isz(spec) if warp else 1)
    T = 32 if t.mode == K.SM_WARP else K.EW_THREADS
    assert t.mode == (K.SM_WARP if warp else K.SM_CTA)
    assert (t.per - 1) * T * t.vec < last <= t.per * T * t.vec
    words = K.descriptor_words(spec)
    _check_in_place(spec, words)
    body = words[-K.DESC_WORDS:]
    assert (body[K.D_KIND], body[K.D_ROWS], body[K.D_LAST]) == (
        K.K_SOFTMAX, rows, last)
    assert body[K.D_ORDER] == order
    assert tuple(body[K.D_TILING:K.D_TILING + len(t)]) == tuple(t)
    grid, group, ctr = K.softmax_grid(spec)
    bp = K.buffer_plan(spec)
    names = [p[0] for p in bp.parts]
    if order == K.EW_OVERLAP:
        assert (grid, group, ctr) == (min(rows, K.EW_RESIDENT),) * 2 + (
            K.EW_COUNTER_BYTES,)
        assert bp.parts[:2] == (("ctr", True, 0), ("results", True, 16))
        assert bp.gbytes >= 16 + n * _isz(spec)
        assert tuple(body[K.BUFFER_WORD["results"]:][:2]) == (1, 16)
    else:
        assert (grid, group, ctr) == (min(rows, K.EW_GRID), 0, 0)
        assert "ctr" not in names and "results" not in names
    assert ("rowbuf" in names) == (t.mode == K.SM_CTA)
    if t.mode == K.SM_CTA:   # shared memory up to the budget, else slices
        assert bp.on_global("rowbuf") == (4 * last > K.EW_SMEM_BUDGET)
    # every row to one warp (warp rows: r = cta + grid * warp + ...) or CTA
    for g in {grid, max(1, grid // 2)}:
        seen = np.zeros(rows, np.int32)
        units = g * (K.EW_THREADS // 32 if t.mode == K.SM_WARP else 1)
        for u in range(units):
            seen[u::units] += 1
        assert (seen == 1).all()
    return order


#: flat hand-built softmaxes: (rows, last), every placement of
#: ``chip_smoke.SOFTMAX_PLACES``; the batches of the zoo's heads (a CTA a
#: row), many rows (a warp a row), and rows past a warp's registers
SOFTMAX_FLAT = [(r, 1000) for r in (1, 2, 8)] + [(3, 37), (300, 40),
                                                 (2, 3000), (1, 9000)]

#: blocked softmaxes: (id, L, in (shape, row, addressing), out)
SOFTMAX_BLOCKED = [
    ("packed_in_place", 64, ((4, 3, 10), 0, "packed"),
     ((4, 3, 10), 0, "packed")),
    ("plain_rows_disjoint", 32, ((4, 3, 10), 0, "plain"),
     ((4, 3, 10), 4, "plain")),
    ("span_in_place", 32, ((2, 3, 30), 0, "span"), ((2, 3, 30), 0, "span")),
    ("dense_shifted_row", 64, ((6, 40), 0, "dense"), ((6, 40), 1, "dense")),
    ("packed_over_plain", 64, ((4, 3, 10), 1, "plain"),
     ((4, 3, 10), 0, "packed")),
    ("dense_wide_in_place", 128, ((3, 1500), 0, "dense"),
     ((3, 1500), 0, "dense")),
]


def _softmax_case(source: str, dtype: str) -> K.OpSpec:
    name, route = source.rsplit("-", 1)
    if route == "flat":
        rows, last, place = name.split("_")
        return CS.softmax_spec(dtype, int(rows), int(last), place)[0]
    _, L, i, o = next(c for c in SOFTMAX_BLOCKED if c[0] == name)
    spec = _block_spec("softmax", L, [i], o, (), dtype=dtype,
                       qmeta=CS.SOFTMAX_QM)
    if route == "streaming":
        spec = dataclasses.replace(spec, win_rows=_window(spec))
    return spec


def _window(spec: K.OpSpec) -> int:
    return staged_slots([r for r, _ in spec.in_rows], spec.out_rows[0],
                        K._sub(spec.dtype))[2]


SOFTMAX_SOURCES = ([f"{r}_{last}_{p}-flat" for r, last in SOFTMAX_FLAT
                    for p in CS.SOFTMAX_PLACES]
                   + [f"{c[0]}-{r}" for c in SOFTMAX_BLOCKED
                      for r in ("blocks", "streaming")])


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", SOFTMAX_SOURCES)
def test_softmax_order_word_matches_the_bytes(source, dtype):
    """Every hand-built softmax through the byte check; the flat ones take
    the order word their placement names (in place 1, shifted five
    elements over the next row 2 (one row: only over itself, 1), after the
    input 0)."""
    spec = _softmax_case(source, dtype)
    order = check_softmax_spec(spec)
    name, route = source.rsplit("-", 1)
    if route == "flat":
        rows, _, place = name.split("_")
        want = {"aligned": K.EW_ALIGNED, "disjoint": K.EW_DISJOINT,
                "shifted": K.EW_OVERLAP if int(rows) > 1
                else K.EW_ALIGNED}[place]
        assert order == want


def test_softmax_cases_take_every_order_word_and_policy():
    """Between them the blocked cases reach every order word, and the
    hand-built cases every row policy."""
    orders, modes = set(), set()
    for source in SOFTMAX_SOURCES:
        for dtype in ("i8", "f32"):
            spec = _softmax_case(source, dtype)
            modes.add(K.softmax_tiling(spec).mode)
            if not source.endswith("-flat"):
                orders.add(K.softmax_order(spec))
    assert orders == {K.EW_DISJOINT, K.EW_ALIGNED, K.EW_OVERLAP}
    assert modes == {K.SM_WARP, K.SM_CTA}
    long = CS.softmax_spec("f32", 1, 65_536, "disjoint")[0]
    bp = K.buffer_plan(long)
    assert K.softmax_tiling(long).mode == K.SM_CTA
    assert bp.on_global("rowbuf") and bp.gbytes == 4 * 65_536


def test_softmax_tiling_depends_on_rows_and_last_alone():
    """The row policy is a function of (rows, last) and the element type:
    the offsets and the program's layout never enter it, so the flat,
    blocked and streaming programs of one graph sum in one order."""
    base = CS.softmax_spec("f32", 4, 1000, "disjoint")[0]
    variants = [dataclasses.replace(base, in_off=(400,), out_off=0),
                dataclasses.replace(base, in_shape=((2, 2, 1000),),
                                    out_shape=(2, 2, 1000)),
                _block_spec("softmax", 1024, [((4, 1000), 0, "dense")],
                            ((4, 1000), 4, "dense"))]
    assert {K.softmax_tiling(s) for s in [base] + variants} == {
        K.softmax_tiling(base)}
    for build, kw in ((lambda: tzoo.mobilenet_v1(0.25, 128, 1), {}),
                      (lambda: tzoo.mobilenet_v1(0.25, 128, 4), {}),
                      (lambda: CS.allops_graph(4), {})):
        tilings = {K.softmax_tiling(s) for r in ROUTES
                   for s in _program(build, r, **kw) if s.kind == "softmax"}
        assert len(tilings) == 1


# ---------------------------------------------------------------------------
# the product grid: matmul
# ---------------------------------------------------------------------------

def product_items(t, m: int, k: int, n: int) -> np.ndarray:
    """How many times the tiling's items sum each (row of a, row of b,
    column) triple, by the kernel's mapping (``fc_tiles.cuh``): item ``i``
    is K slice ``i % nks``, column block ``i // nks % ncb``, row block
    ``i // (nks * ncb)``; warp ``w`` sums rows ``rb * bm + w * rm ..`` of
    a over the whole slice; lane ``l`` four columns from ``cb * bo + 4 *
    l``."""
    count = np.zeros((m, k, n), np.int32)
    for i in range(t.ctas):
        ks, rc = i % t.nks, i // t.nks
        cb, rb = rc % t.ncb, rc // t.ncb
        for w in range(K.FC_WARPS):
            r0, r1 = rb * t.bm + w * t.rm, rb * t.bm + (w + 1) * t.rm
            k0, k1 = ks * t.bk, (ks + 1) * t.bk
            for lane in range(32):
                o0 = cb * t.bo + 4 * lane
                count[r0:min(r1, m), k0:min(k1, k), o0:min(o0 + 4, n)] += 1
    return count


def check_matmul_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a matmul the grid runs; returns its
    order word after checking it, its tiling, descriptor and buffers.

    - Order 0 only when no byte of an a or b element lies in the output's
      block, and exactly when the operands' blocks are disjoint from it;
      else order 2 (every CTA reads before one grid-wide barrier).
    - The items sum every (row of a, row of b, column) once, within
      :data:`arena_ops.FC_GRID` CTAs where b has the rows for it.
    - The descriptor carries the order word, the tiling and whether b's
      four columns of a lane are one aligned run."""
    assert K.runs_product_grid(spec) and spec.kind == "matmul"
    isz = _isz(spec)
    m, k, n = K._matmul_geometry(spec)
    lo, holder = _out_holders(spec, m * n)
    meets = False
    for i, cnt in ((0, m * k), (1, k * n)):
        at = _element_bytes(spec, i, np.arange(cnt))
        meets |= bool(((at >= lo) & (at < lo + holder.size)).any())
    order = K.matmul_order(spec)
    assert order == (K.EW_OVERLAP if _blocks_meet(spec, [0, 1])
                     else K.EW_DISJOINT)
    assert not meets or order == K.EW_OVERLAP
    t = K.fc_tiling(spec)
    assert (product_items(t, m, k, n) == 1).all()
    assert t.ctas == t.nrb * t.ncb * t.nks and t.bo == K.FC_COLS
    assert t.ctas <= max(K.FC_GRID, t.nrb * t.ncb)
    assert (t.rm, t.bm) == (K.MM_RM, K.FC_WARPS * K.MM_RM)
    words = K.descriptor_words(spec)
    _check_in_place(spec, words)
    body = words[-K.DESC_WORDS:]
    assert (body[K.D_KIND], body[K.D_MM], body[K.D_MK], body[K.D_MN]) == (
        K.K_MATMUL, m, k, n)
    assert body[K.D_IN2_OFF] == K.operand_addr(spec, 1)[0]
    assert body[K.D_ORDER] == order
    assert tuple(body[K.D_TILING:K.D_TILING + len(t)]) == tuple(t)
    # b's four columns a lane: one aligned run of the arena
    runs = _elem_at(K.operand_addr(spec, 1),
                    np.arange(k * n).reshape(k, n)[:, :n // 4 * 4]
                    .reshape(-1, 4))
    vec = n % 4 == 0 and bool(
        (runs == runs[:, :1] + np.arange(4)).all()
        and ((K.operand_addr(spec, 1)[0] + runs[:, 0] * isz) % (4 * isz)
             == 0).all())
    assert body[K.D_VECB] == int(vec)
    ctr = K.fc_counter_bytes(spec)
    assert ctr == (0 if t.nks == 1 and order == K.EW_DISJOINT
                   else -(-(16 + 4 * t.nrb * t.ncb) // 16) * 16)
    direct = t.rm > 0 and t.nks == 1 and order == K.EW_DISJOINT
    assert K.mm_direct(spec) == direct
    bp = K.buffer_plan(spec)
    assert bp.parts[:2] == (("ctr", True, 0), ("part", True, ctr))
    assert bp.gbytes == ctr + (0 if direct else
                               -(-4 * t.nks * m * n // 16) * 16)
    assert "red" not in [p[0] for p in bp.parts]
    g = min(t.ctas, K.FC_GRID)
    assert K.fc_grid(spec) == ((g, g, ctr) if order == K.EW_OVERLAP
                               else (t.ctas, 0, ctr))
    return order


#: flat hand-built matmuls: (m, k, n), a at byte 0, b after it, the
#: output after both or over a (``chip_smoke.matmul_spec``) or over b
MATMUL_FLAT = [(16, 8, 2), (3, 16, 5), (40, 70, 130), (70, 200, 12),
               (16, 64, 8)]
#: blocked matmuls: (id, L, a, b, out)
MATMUL_BLOCKED = [
    ("dense_overlap", 16, ((16, 8), 0, "dense"), ((8, 2), 9, "dense"),
     ((16, 2), 6, "dense")),
    ("plain_b_disjoint", 32, ((20, 12), 0, "dense"), ((12, 8), 8, "dense"),
     ((20, 8), 11, "dense")),
    ("packed_out_over_b", 64, ((3, 4, 6), 0, "dense"),
     ((6, 5), 2, "dense"), ((3, 4, 5), 2, "packed")),
    ("span_a_in_place", 16, ((2, 3, 24), 0, "span"), ((24, 24), 12, "dense"),
     ((2, 3, 24), 0, "span")),
]


def _matmul_case(source: str, dtype: str) -> K.OpSpec:
    name, route = source.rsplit("-", 1)
    if route == "flat":
        m, k, n, place = name.split("_", 3)
        m, k, n = int(m), int(k), int(n)
        if place == "over_b":
            spec = CS.matmul_spec(dtype, m, k, n, "disjoint")[0]
            return dataclasses.replace(spec, out_off=spec.in_off[1])
        return CS.matmul_spec(dtype, m, k, n, place)[0]
    _, L, a, b, o = next(c for c in MATMUL_BLOCKED if c[0] == name)
    spec = _block_spec("matmul", L, [a, b], o, (), dtype=dtype,
                       qmeta=CS.MATMUL_QM)
    if route == "streaming":
        spec = dataclasses.replace(spec, win_rows=_window(spec))
    return spec


MATMUL_SOURCES = ([f"{m}_{k}_{n}_{p}-flat" for m, k, n in MATMUL_FLAT
                   for p in ("disjoint", "over_a", "over_b")]
                  + [f"{c[0]}-{r}" for c in MATMUL_BLOCKED
                     for r in ("blocks", "streaming")])


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", MATMUL_SOURCES)
def test_matmul_order_word_matches_the_bytes(source, dtype):
    """Every hand-built matmul through the byte check; the flat ones take
    the order word their placement names (after both operands 0, over a
    or over b 2)."""
    spec = _matmul_case(source, dtype)
    order = check_matmul_spec(spec)
    if source.endswith("-flat"):
        assert order == (K.EW_DISJOINT if "disjoint" in source
                         else K.EW_OVERLAP)


def test_matmul_tiling_depends_on_the_shape_alone():
    """The items are a function of (M, K, N): the dtype, the offsets and
    the layout never enter them; an FC of the same shape takes no row
    blocks (its rows are a batch), and its few rows keep their tiling;
    1024^3 is 16 row blocks x 8 column blocks, one slice."""
    base = CS.matmul_spec("f32", 40, 70, 130, "disjoint")[0]
    variants = [CS.matmul_spec("i8", 40, 70, 130, "over_a")[0],
                dataclasses.replace(base, in_shape=((2, 20, 70), (70, 130)),
                                    out_shape=(2, 20, 130)),
                _block_spec("matmul", 256, [((40, 70), 0, "dense"),
                                            ((70, 130), 20, "dense")],
                            ((40, 130), 60, "dense"))]
    fc = K.OpSpec(kind="fully_connected", in_off=(0,),
                  in_shape=((40, 70),), out_off=40 * 70 * 4,
                  out_shape=(40, 130))
    assert {K.fc_tiling(s) for s in [base] + variants} == {
        K.fc_tiling(base)}
    assert K.fc_tiling(base).rm and not K.fc_tiling(fc).rm
    assert K.fc_tiling(fc) == K.product_tiling(40, 70, 130, rows=False)
    big = K.product_tiling(1024, 1024, 1024, rows=True)
    assert (big.nrb, big.ncb, big.nks, big.ctas, big.bm, big.rm) == (
        16, 8, 1, 128, 64, 4)
    assert K.product_tiling(1, 2048, 1000, rows=False)[:6] == (
        128, 128, 8, 8, 16, 128)
    for build in (lambda: CS.allops_graph(4), lambda: CS.allops_graph(1)):
        tilings = {K.fc_tiling(s) for r in ROUTES
                   for s in _program(build, r) if s.kind == "matmul"}
        assert len(tilings) == 1


# ---------------------------------------------------------------------------
# the zoo's softmaxes and matmuls
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _compiled(build, batch: int = 1):
    return t_compile(build(), backend="numpy", batch=batch)


def _program(build, route: str, batch: int = 1):
    return tuple(CudaExecutor(device="cpu", **ROUTES[route]).program(
        _compiled(build, batch))[0])


_FLAGSHIP = functools.partial(tzoo.mobilenet_v1, 0.25, 128, 1)
ZOO = {"flagship_b1": (_FLAGSHIP, 1), "flagship_b2": (_FLAGSHIP, 2),
       "flagship_b8": (_FLAGSHIP, 8),
       "flagship_f32": (functools.partial(tzoo.mobilenet_v1, 0.25, 128, 4),
                        1),
       "resnet50_v2_f32": (functools.partial(tzoo.resnet50_v2, 32, 4), 1),
       "allops_f32": (functools.partial(CS.allops_graph, 4), 1),
       "allops_int8": (functools.partial(CS.allops_graph, 1), 1),
       "stream_allops_f32": (functools.partial(CS.stream_allops_graph, 4),
                             1)}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("label", sorted(ZOO))
def test_zoo_softmaxes_and_matmuls_take_their_order_words(label, route):
    """Every softmax and matmul of the graph's program through the byte
    checks (the staged ones in place on the arena). The flagship's
    softmaxes run in place over their own input on every program and
    batch (order word 1): one per sample, so one row and one CTA each,
    eight at batch 8."""
    build, batch = ZOO[label]
    specs = [s for s in _program(build, route, batch)
             if s.kind in ("softmax", "matmul")]
    assert specs
    orders = [check_softmax_spec(s) if s.kind == "softmax"
              else check_matmul_spec(s) for s in specs]
    assert {K.kernel_of(s) for s in specs} <= (
        {"arena_stream_stage"} if route == "streaming"
        else {"arena_softmax", "arena_matmul"})
    if label.startswith("flagship"):
        assert orders == [K.EW_ALIGNED] * batch
        assert {K.softmax_grid(s) for s in specs} == {(1, 0, 0)}


# ---------------------------------------------------------------------------
# the grids' summation order in numpy, against the plain versions
# ---------------------------------------------------------------------------

def softmax_grid_model(x: np.ndarray, t) -> np.ndarray:
    """Softmax of f32 rows ``x`` (rows, last) as the grid computes it: each
    thread's exps summed its groups then columns ascending, the xor
    butterfly over a warp's lanes, a CTA row's warps ascending; then e /
    sum."""
    rows, last = x.shape
    T = 32 if t.mode == K.SM_WARP else K.EW_THREADS
    out = np.empty_like(x)
    for r in range(rows):
        e = np.exp(x[r] - x[r].max()).astype(np.float32)
        sums = np.zeros(T, np.float32)
        for th in range(T):
            s = np.float32(0)
            for j in range(t.per):
                c = (th + T * j) * t.vec
                for v in e[c:min(c + t.vec, last)]:
                    s = np.float32(s + v)
            sums[th] = s
        for w in range(T // 32):
            lanes = sums[32 * w:32 * w + 32]
            for sh in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ sh]).astype(np.float32)
            sums[32 * w:32 * w + 32] = lanes
        total = sums[0]
        for w in range(1, T // 32):
            total = np.float32(total + sums[32 * w])
        out[r] = e / total
    return out


def matmul_grid_model(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """a . b summed as the grid sums it: per K slice its rows of b
    ascending (one thread an output), then the slices ascending (int8:
    exact int32)."""
    m, k = a.shape
    y = None
    for ks in range(t.nks):
        k0 = ks * t.bk
        part = np.zeros((m, b.shape[1]), a.dtype)
        for kk in range(k0, min(k0 + t.bk, k)):
            part = part + a[:, kk:kk + 1] * b[kk]
        y = part if y is None else y + part
    return y


def _seeded_flat(nbytes: int, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "i8":
        return rng.integers(0, 256, nbytes, dtype=np.uint8)
    return (rng.standard_normal(-(-nbytes // 4)) * 2).astype(
        np.float32).view(np.uint8)[:nbytes]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("rows,last", [(2, 1000), (1, 3000), (3, 37),
                                       (300, 70)])
def test_softmax_grid_order_matches_the_plain_version(rows, last, dtype):
    """The grid's summation order (CTA rows, warp rows) on a
    seeded flat softmax against ``softmax_plain``: f32 within 1e-4, int8
    within 1 LSB (numpy's exp, torch's and the card's differ by an ulp)."""
    spec, nbytes = CS.softmax_spec(dtype, rows, last, "disjoint")
    arena = _seeded_flat(nbytes, dtype, rows + last)
    q = dtype == "i8"
    x = (arena[:rows * last].view(np.int8) if q
         else arena[:4 * rows * last].view(np.float32)).reshape(rows, last)
    if q:
        (xs, xzp), (ys, yzp) = CS.SOFTMAX_QM
        x = ((x.astype(np.float32) - np.float32(xzp)) * np.float32(xs))
    want = softmax_grid_model(x.astype(np.float32), K.softmax_tiling(spec))
    t = torch.from_numpy(arena.copy())
    K.softmax_plain(t, spec)
    lo = spec.out_off
    if q:
        got = t.numpy()[lo:lo + rows * last].view(np.int8).astype(np.int32)
        wq = np.clip(np.rint(want / np.float32(ys)) + yzp, -128, 127)
        assert np.abs(got - wq.reshape(-1)).max() <= 1
    else:
        got = t.numpy()[lo:lo + 4 * rows * last].view(np.float32)
        np.testing.assert_allclose(got, want.reshape(-1), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("m,k,n", [(40, 70, 130), (3, 100, 5),
                                   (70, 300, 12), (16, 2048, 8)])
def test_matmul_grid_order_matches_the_plain_version(m, k, n, dtype):
    """The grid's summation order (row blocks, one K slice or several) on
    seeded a and b against ``matmul_plain``: int8 bit for
    bit (exact int32 sums, the shared requantisation), f32 within 1e-4."""
    spec, nbytes = CS.matmul_spec(dtype, m, k, n, "disjoint")
    arena = _seeded_flat(nbytes, dtype, m + k + n)
    q = dtype == "i8"
    isz = _isz(spec)
    view = (lambda o, c: arena[o:o + c].view(np.int8)) if q else \
        (lambda o, c: arena[o:o + 4 * c].view(np.float32))
    a = view(0, m * k).reshape(m, k)
    b = view(spec.in_off[1], k * n).reshape(k, n)
    t = torch.from_numpy(arena.copy())
    K.matmul_plain(t, spec)
    got = t.numpy()[spec.out_off:spec.out_off + m * n * isz]
    tl = K.fc_tiling(spec)
    if q:
        a_zp, b_zp, amult, y_zp = CS.MATMUL_QM
        acc = matmul_grid_model(a.astype(np.int32) - a_zp,
                                b.astype(np.int32) - b_zp, tl)
        want = K._requant(torch.from_numpy(acc), amult, y_zp).numpy()
        np.testing.assert_array_equal(got.view(np.int8).reshape(m, n), want)
    else:
        want = matmul_grid_model(a, b, tl)
        np.testing.assert_allclose(got.view(np.float32).reshape(m, n), want,
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------

def _arena_for(spec: K.OpSpec, seed: int) -> np.ndarray:
    if spec.rowlen:
        return _typed_arena(spec.dtype, _rows(spec) + 2, spec.rowlen, seed)
    n = max(arena_bytes(spec, i)[1]
            for i in [None] + list(range(len(spec.in_off)))) + 64
    return _seeded_flat(-(-n // 16) * 16, spec.dtype, seed)


def _hold(spec: K.OpSpec, got: np.ndarray, want: np.ndarray) -> None:
    """Bytes outside the output's block equal; inside, int8 within 1 LSB
    (softmax) or bit for bit (matmul), f32 within 1e-4."""
    got = got.view(np.uint8).reshape(-1)
    want = want.view(np.uint8).reshape(-1)
    lo, hi = arena_bytes(spec, None)
    outside = np.ones(got.size, bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if spec.dtype == "i8":
        d = np.abs(got[lo:hi].view(np.int8).astype(np.int32)
                   - want[lo:hi].view(np.int8).astype(np.int32))
        assert d.max(initial=0) <= CS.lsb_limit(spec)
    else:
        np.testing.assert_allclose(got[lo:hi].view(np.float32),
                                   want[lo:hi].view(np.float32),
                                   rtol=1e-4, atol=1e-4)


PALLAS_SOURCES = ([s for s in SOFTMAX_SOURCES
                   if not s.startswith(("1_9000", "2_3000"))]
                  + [s for s in MATMUL_SOURCES
                     if not s.startswith("70_200")])


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", PALLAS_SOURCES)
def test_plain_versions_match_pallas(source, dtype):
    """The plain softmax and matmul (the wrappers' CPU route) on a seeded
    arena against the reference's Pallas kernels in interpret mode, at
    batch 1, 2 and 8 and on every placement: softmax int8 within 1 LSB,
    matmul int8 bit for bit, f32 within 1e-4; the CPU route launches
    nothing."""
    spec = (_matmul_case if source in MATMUL_SOURCES else _softmax_case)(
        source, dtype)
    arena = _arena_for(spec, 11)
    t = torch.from_numpy(arena.copy())
    before = dict(K.LAUNCHES)
    K.apply_op(t, spec)
    assert K.LAUNCHES == before
    want = np.asarray(R.apply_op(jnp.asarray(arena), _ref_spec(spec), (),
                                 interpret=True))
    _hold(spec, t.numpy(), want)


# ---------------------------------------------------------------------------
# the streaming program: the staged softmax and matmul in place
# ---------------------------------------------------------------------------

STREAM_GRAPHS = {
    "stream_allops_f32": functools.partial(CS.stream_allops_graph, 4),
    "stream_allops_int8": functools.partial(CS.stream_allops_graph, 1),
    "allops_f32": functools.partial(CS.allops_graph, 4),
    "allops_int8": functools.partial(CS.allops_graph, 1),
    "flagship_int8": _FLAGSHIP,
}


@pytest.mark.parametrize("label", sorted(STREAM_GRAPHS))
def test_streaming_final_arena_equals_blocked_in_place(label):
    """The CPU route of the streaming program: every staged spec runs in
    place (no window, no copies: ``card_staging_bytes`` 0), and the final
    arena is bit-equal to the blocked program's on the same inputs."""
    from repro_torch.core import exec as X
    cp = _compiled(STREAM_GRAPHS[label])
    st = CudaExecutor(device="cpu", mode="streaming")
    blk = CudaExecutor(device="cpu", layout="blocks")
    w = X.synth_weights(cp.graph, 0)
    q = X.calibrate(cp.graph, 0, w) if X.needs_quant(cp.graph) else None
    inputs = (X.quant_inputs(cp.graph, q, 0) if q is not None
              else X.random_inputs(cp.graph, 0))
    finals = []
    for ex in (st, blk):
        specs, ws, _, arena = ex.program(cp, inputs, w, quant=q)
        for spec, wt in zip(specs, ws):
            K.apply_op(arena, spec, wt)
        finals.append(arena.numpy())
        if ex is st:
            staged = [s for s in specs if K.stream_form(s) == "stage"]
            assert all(K.runs_in_place(s) for s in staged)
            assert sum(CS.card_staging_bytes(K, s) for s in staged) == 0
            for s in staged:
                if s.kind in ("softmax", "matmul"):
                    _check_in_place(s, K.descriptor_words(s))
            assert any(s.kind == "softmax" for s in staged)
    np.testing.assert_array_equal(finals[0], finals[1])
