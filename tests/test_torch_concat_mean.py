"""The chunk walks of ``arena_concat`` and ``arena_mean``, and of the
staged concat and mean bodies of ``arena_stream_stage`` (in place on the
arena), through their Python mirrors: every concat and mean spec of the
Table III zoo on the flat, blocked and streaming programs, and hand-built
ones, through a brute-force byte check of the order word, the tiling and
the buffers; then a numpy model of each grid, unit by unit in grid order,
against the plain versions (concat and int8 mean bit for bit; f32 mean
within the ``compare_outputs`` tolerance, 1e-4, since ``mean_plain`` sums
in torch's order and the grid in one fixed order) and against the JAX
package's Pallas kernels in interpret mode (int8 bit-exact, f32 1e-4).
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

from _torch_block_cases import (_block_spec, _elem_at, _elem_of,
                                _ref_spec, _rows, _typed_arena,
                                arena_bytes, check_grid_words)

ROUTES = {"flat": {}, "blocks": {"layout": "blocks"},
          "streaming": {"mode": "streaming"}}


@functools.lru_cache(maxsize=None)
def _program(model: str, route: str):
    cp = t_compile(tzoo.TABLE3_MODELS[model][0](), backend="numpy")
    return tuple(CudaExecutor(device="cpu", **ROUTES[route]).program(cp)[0])


def _isz(spec: K.OpSpec) -> int:
    return 1 if spec.dtype == "i8" else 4


def _out_holders(spec: K.OpSpec, n: int):
    """(first byte of the output's block, per byte of the block the
    tensor element it holds, -2 in the padding)."""
    oa = K.operand_addr(spec, None)
    e = _elem_of(oa, np.arange(oa[6]), n)
    return oa[0], np.repeat(np.where(e >= 0, e, -2), _isz(spec))


def _in_bytes(spec: K.OpSpec, i: int, e: np.ndarray) -> np.ndarray:
    """First arena byte of tensor elements ``e`` of input ``i``."""
    a = K.operand_addr(spec, i)
    return a[0] + _elem_at(a, e) * _isz(spec)


def check_concat_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a concat the grid runs; returns its
    order word after checking it and its tiling.

    - Order 0 only when no byte of any input element lies in the output's
      block (elements or padding, which the grid writes at any time), and
      exactly when the operands' blocks are disjoint; else order 2.
    - A 16-byte unit holds padding only, or consecutive elements of one
      input's columns that the input holds as one aligned 16-byte run."""
    assert K.runs_chunk_walk(spec) and spec.kind == "concat"
    isz = _isz(spec)
    outer, inner_out, inners = K._concat_geometry(spec)
    n = outer * inner_out
    lo, holder = _out_holders(spec, n)
    meets = False
    for i, shape in enumerate(spec.in_shape):
        start = _in_bytes(spec, i, np.arange(K._elems(shape)))
        meets |= any(((start + j >= lo) & (start + j < lo + holder.size))
                     .any() for j in range(isz))
    order = K.concat_order(spec)
    (olo, ohi) = arena_bytes(spec, None)
    blocks_meet = any(a < ohi and olo < b for a, b in (
        arena_bytes(spec, i) for i in range(len(spec.in_off))))
    assert order == (K.EW_OVERLAP if blocks_meet else K.EW_DISJOINT)
    assert not meets or order == K.EW_OVERLAP, spec
    t = K.concat_tiling(spec)
    assert t.units * t.vec == K.operand_addr(spec, None)[6]
    assert t.vec in (1, 16 // isz)
    if t.vec > 1:
        e = _elem_of(K.operand_addr(spec, None),
                     np.arange(t.units * t.vec), n).reshape(t.units, t.vec)
        pad = (e == -1).all(1)
        assert (pad | (e == e[:, :1] + np.arange(t.vec)).all(1)).all()
        first = e[~pad, 0]
        starts = np.cumsum((0,) + inners)
        col = first % inner_out
        src = np.searchsorted(starts, col, "right") - 1
        last = src[:, None] == np.searchsorted(
            starts, col[:, None] + np.arange(t.vec), "right") - 1
        assert last.all()
        for i in range(len(inners)):
            sel = src == i
            el = (first[sel] // inner_out) * inners[i] + col[sel] - starts[i]
            run = _elem_at(K.operand_addr(spec, i),
                           el[:, None] + np.arange(t.vec))
            assert (run == run[:, :1] + np.arange(t.vec)).all()
            assert (_in_bytes(spec, i, el) % 16 == 0).all()
    check_grid_words(spec, order, t)
    return order


def _mean_owner(spec: K.OpSpec) -> np.ndarray:
    """The output each input element's reduction feeds (the kept axes'
    coordinates, last axis fastest)."""
    dims, rmask, _, _ = K._mean_geometry(spec)
    coords = np.unravel_index(np.arange(K._elems(dims)), dims)
    o = np.zeros(K._elems(dims), np.int64)
    for i in range(4):
        if not rmask >> i & 1:
            o = o * dims[i] + coords[i]
    return o


def check_mean_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a mean the grid runs; returns its
    order word after checking it and its tiling: 0 exactly when the
    operands' blocks are disjoint; else 1 exactly when every input byte
    inside the output's block lies in the element of the output whose
    reduction reads it (none in padding); else 2. One output a unit."""
    assert K.runs_chunk_walk(spec) and spec.kind == "mean"
    isz = _isz(spec)
    dims, rmask, cnt, outn = K._mean_geometry(spec)
    assert cnt * outn == K._elems(dims)
    lo, holder = _out_holders(spec, outn)
    owner = _mean_owner(spec)
    start = _in_bytes(spec, 0, np.arange(K._elems(dims)))
    own = True
    for j in range(isz):
        at = start + j - lo
        inside = (at >= 0) & (at < holder.size)
        own &= bool((holder[at[inside]] == owner[inside]).all())
    (ilo, ihi), (olo, ohi) = arena_bytes(spec, 0), arena_bytes(spec, None)
    order = K.mean_order(spec)
    if ihi <= olo or ohi <= ilo:
        assert order == K.EW_DISJOINT
    else:
        assert order == (K.EW_ALIGNED if own else K.EW_OVERLAP), spec
    t = K.mean_tiling(spec)
    assert (t.vec, t.units) == (1, K.operand_addr(spec, None)[6])
    assert t.per <= K.MEAN_PER or t.chunks == (
        K.EW_RESIDENT if order == K.EW_OVERLAP else K.EW_GRID)
    words = K.descriptor_words(spec)[-K.DESC_WORDS:]
    assert tuple(words[K.D_DIM0:K.D_DIM0 + 4]) == dims
    assert (words[K.D_RMASK], words[K.D_CNT], words[K.D_OUTN]) == (
        rmask, cnt, outn)
    check_grid_words(spec, order, t)
    return order


#: Table III rows with concats, and how many each lowers on every program
CONCAT_MODELS = {"inception_v4": 25, "inception_resnet_v2": 43,
                 "nasnet_mobile": 16, "densenet_121": 58}
#: rows whose flat mean writes over its own input (order word 1); the
#: inception rows' flat means are disjoint
OWN_MEANS = {"mobilenet_v1_1.0_224", "mobilenet_v1_1.0_224_8bit",
             "mobilenet_v1_0.25_224", "mobilenet_v1_0.25_128_8bit",
             "mobilenet_v2_0.35_224", "mobilenet_v2_1.0_224",
             "nasnet_mobile", "densenet_121", "resnet_50_v2"}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("model", sorted(CONCAT_MODELS))
def test_zoo_concats_are_disjoint(model, route):
    """Every concat of a Table III row, on each program, runs the concat
    grid (in place on the arena when staged) with order word 0: no byte of
    an input lies in the output's block, so no chunk waits and no
    workspace is taken."""
    cats = [s for s in _program(model, route) if s.kind == "concat"]
    assert len(cats) == CONCAT_MODELS[model]
    assert {K.kernel_of(s) for s in cats} == {
        "arena_stream_stage" if route == "streaming" else "arena_concat"}
    assert {check_concat_spec(s) for s in cats} == {K.EW_DISJOINT}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("model", sorted(tzoo.TABLE3_MODELS))
def test_zoo_means_take_their_order_words(model, route):
    """Every Table III row's mean through the byte check: on the flat
    program it writes over its own input where the planner put it there
    (order word 1: output element o covers input element (0, 0, o), which
    only o's reduction reads), else it is disjoint; on the blocked and
    streaming programs it is disjoint (order word 0)."""
    (mean,) = [s for s in _program(model, route) if s.kind == "mean"]
    order = check_mean_spec(mean)
    if route == "flat" and model in OWN_MEANS:
        assert order == K.EW_ALIGNED
    else:
        assert order == K.EW_DISJOINT
    if model == "resnet_50_v2":     # 2,048 channels on 16 CTAs (flat)
        assert K.mean_tiling(mean).chunks == (16 if route == "flat"
                                              else 112)


# ---------------------------------------------------------------------------
# hand-built specs
# ---------------------------------------------------------------------------

def _cat_q(n: int):
    return (tuple((zp, float(np.float32(m))) for zp, m in
                  ((1, 0.5), (-2, 1.0), (0, 1.7), (5, 0.9))[:n]), (-1,))


MEAN_QM = (-3, float(np.float32(1.7)), 2)

#: flat specs (offsets in elements): (id, kind, in shapes, out shape,
#: meta, in offsets, out offset)
FLAT_CASES = [
    ("concat_2_overlap", "concat", ((4, 4, 3), (4, 4, 5)), (4, 4, 8),
     (-1,), (0, 48), 20),
    ("concat_4_overlap", "concat",
     ((3, 3, 2), (3, 3, 1), (3, 3, 4), (3, 3, 2)), (3, 3, 9), (-1,),
     (0, 18, 27, 63), 10),
    ("concat_vec_disjoint", "concat", ((4, 4, 16), (4, 4, 32)),
     (4, 4, 48), (-1,), (0, 256), 1024),
    ("concat_axis0", "concat", ((2, 3, 16), (1, 3, 16)), (3, 3, 16), (0,),
     (0, 96), 160),
    ("mean_own", "mean", ((4, 4, 16),), (16,), ((0, 1),), (10,), 10),
    ("mean_last_axes", "mean", ((3, 5, 8),), (3,), ((1, 2),), (0,), 200),
    ("mean_over_others", "mean", ((4, 4, 16),), (16,), ((0, 1),), (0,), 5),
    ("mean_last_axes_in_place", "mean", ((3, 5, 8),), (3,), ((1, 2),),
     (0,), 0),
    ("mean_axes_apart", "mean", ((6, 5, 8),), (5,), ((0, 2),), (0,), 300),
]
#: the order word each flat case takes (both tiers)
FLAT_ORDERS = {"concat_2_overlap": K.EW_OVERLAP,
               "concat_4_overlap": K.EW_OVERLAP,
               "concat_vec_disjoint": K.EW_DISJOINT,
               "concat_axis0": K.EW_DISJOINT, "mean_own": K.EW_ALIGNED,
               "mean_last_axes": K.EW_DISJOINT,
               "mean_over_others": K.EW_OVERLAP,
               "mean_last_axes_in_place": K.EW_OVERLAP,
               "mean_axes_apart": K.EW_DISJOINT}


def _flat_spec(case, dtype: str) -> K.OpSpec:
    _, kind, shapes, oshp, meta, offs, ooff = case
    isz = 1 if dtype == "i8" else 4
    qm = _cat_q(len(shapes)) if kind == "concat" else MEAN_QM
    return K.OpSpec(kind=kind, in_off=tuple(o * isz for o in offs),
                    in_shape=shapes, out_off=ooff * isz, out_shape=oshp,
                    dtype=dtype, meta=meta,
                    qmeta=qm if dtype == "i8" else ())


#: row-blocked specs, staged in the streaming program too: (id, kind, L,
#: ins, out, meta); addressing as ``_torch_block_cases._block_spec``
BLOCKED_CASES = [
    ("concat_packed_plain", "concat", 32,
     [((4, 4, 3), 0, "packed"), ((4, 4, 5), 2, "plain")],
     ((4, 4, 8), 4, "plain"), (-1,)),
    ("concat_4_span_overlap", "concat", 8,
     [((3, 3, 2), 0, "plain"), ((3, 3, 1), 3, "packed"),
      ((3, 3, 4), 5, "span"), ((3, 3, 2), 11, "plain")],
     ((3, 3, 9), 2, "span"), (-1,)),
    ("concat_dense_vec", "concat", 64,
     [((4, 4, 16), 0, "dense"), ((4, 4, 16), 4, "dense")],
     ((4, 4, 32), 8, "dense"), (-1,)),
    ("mean_span_in", "mean", 32,
     [((4, 4, 16), 0, "span")], ((16,), 3, "dense"), ((0, 1),)),
    ("mean_dense_apart", "mean", 48,
     [((3, 5, 8), 1, "plain")], ((3,), 0, "dense"), ((1, 2),)),
]
BLOCKED_ORDERS = {"concat_packed_plain": K.EW_OVERLAP,
                  "concat_4_span_overlap": K.EW_OVERLAP,
                  "concat_dense_vec": K.EW_DISJOINT,
                  "mean_span_in": K.EW_OVERLAP,
                  "mean_dense_apart": K.EW_DISJOINT}


def _blocked_spec(case, dtype: str, streaming: bool) -> K.OpSpec:
    _, kind, L, ins, out, meta = case
    qm = _cat_q(len(ins)) if kind == "concat" else MEAN_QM
    spec = _block_spec(kind, L, ins, out, meta, dtype=dtype, qmeta=qm)
    if streaming:
        _, _, total = staged_slots([r for r, _ in spec.in_rows],
                                   spec.out_rows[0], K._sub(dtype))
        spec = dataclasses.replace(spec, win_rows=total)
    return spec


HAND_BUILT = ([f"{c[0]}-flat" for c in FLAT_CASES]
              + [f"{c[0]}-{r}" for c in BLOCKED_CASES
                 for r in ("blocks", "streaming")])


def _hand_built(source: str, dtype: str) -> K.OpSpec:
    name, route = source.rsplit("-", 1)
    if route == "flat":
        return _flat_spec(next(c for c in FLAT_CASES if c[0] == name),
                          dtype)
    return _blocked_spec(next(c for c in BLOCKED_CASES if c[0] == name),
                         dtype, route == "streaming")


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", HAND_BUILT)
def test_hand_built_order_words_match_the_bytes(source, dtype):
    """Hand-built concats and means through the byte check take the order
    word listed for them: among them ``concat_4_overlap`` and a mean whose
    output lies over other outputs' inputs take 2, a mean over its own
    inputs 1."""
    spec = _hand_built(source, dtype)
    name, route = source.rsplit("-", 1)
    check = check_concat_spec if spec.kind == "concat" else check_mean_spec
    want = (FLAT_ORDERS if route == "flat" else BLOCKED_ORDERS)[name]
    assert check(spec) == want


def test_hand_built_specs_take_every_order_word():
    """Between them the hand-built cases reach every order word a concat
    (0, 2) and a mean (0, 1, 2) can take, and 16-byte concat units."""
    cats, means, vec = set(), set(), set()
    for source in HAND_BUILT:
        for dtype in ("i8", "f32"):
            spec = _hand_built(source, dtype)
            if spec.kind == "concat":
                cats.add(K.concat_order(spec))
                vec.add(K.concat_tiling(spec).vec)
            else:
                means.add(K.mean_order(spec))
    assert cats == {K.EW_DISJOINT, K.EW_OVERLAP}
    assert means == {K.EW_DISJOINT, K.EW_ALIGNED, K.EW_OVERLAP}
    assert vec == {1, 4, 16}


# ---------------------------------------------------------------------------
# the grids in numpy, unit by unit in grid order
# ---------------------------------------------------------------------------

def _requant(acc: np.ndarray, mult: float, zp: int) -> np.ndarray:
    """requant_f of the kernels: f32 product, round half to even, + zp,
    clip to int8."""
    q = np.rint(acc.astype(np.float32) * np.float32(mult)) + np.float32(zp)
    return np.clip(q, -128, 127).astype(np.int8)


def _read(spec: K.OpSpec, buf: np.ndarray, at: np.ndarray) -> np.ndarray:
    """The int8 or f32 elements at arena bytes ``at``."""
    if spec.dtype == "i8":
        return buf.view(np.int8)[at]
    return buf.view(np.float32)[at // 4]


def _concat_units(spec: K.OpSpec, buf: np.ndarray, u: np.ndarray,
                  vec: int) -> np.ndarray:
    """Output block elements of units ``u`` as ``cat_elem``/``cat_vec``
    compute them: each element's input by its column, int8 rescaled."""
    outer, inner_out, inners = K._concat_geometry(spec)
    e = _elem_of(K.operand_addr(spec, None),
                 (u[:, None] * vec + np.arange(vec)).reshape(-1),
                 outer * inner_out)
    starts = np.cumsum((0,) + inners)
    out = np.zeros(e.size, np.int8 if spec.dtype == "i8" else np.float32)
    c = e % inner_out
    src = np.searchsorted(starts, c, "right") - 1
    for i in range(len(inners)):
        sel = (e >= 0) & (src == i)
        el = (e[sel] // inner_out) * inners[i] + c[sel] - starts[i]
        x = _read(spec, buf, _in_bytes(spec, i, el))
        if spec.dtype == "i8":
            (zp, mult), y_zp = spec.qmeta[0][i], spec.qmeta[1][0]
            x = _requant(x.astype(np.int32) - zp, mult, y_zp)
        out[sel] = x
    return out


def _mean_units(spec: K.OpSpec, buf: np.ndarray, u: np.ndarray,
                vec: int) -> np.ndarray:
    """Outputs of units ``u`` as ``mean_elem`` computes them: each one's
    reduction summed r ascending (the reduced axes decoded last axis
    fastest), f32 one add at a time, then divided (and requantised)."""
    dims, rmask, cnt, outn = K._mean_geometry(spec)
    q = spec.dtype == "i8"
    stride = np.cumprod((1,) + dims[:0:-1])[::-1]
    e = _elem_of(K.operand_addr(spec, None), u, outn)
    base, rem = np.zeros(e.size, np.int64), np.maximum(e, 0)
    for i in range(3, -1, -1):
        if not rmask >> i & 1:
            base += (rem % dims[i]) * stride[i]
            rem //= dims[i]
    acc = np.zeros(e.size, np.int32 if q else np.float32)
    for r in range(cnt):
        idx, rr = base.copy(), r
        for i in range(3, -1, -1):
            if rmask >> i & 1:
                idx += (rr % dims[i]) * stride[i]
                rr //= dims[i]
        acc = acc + _read(spec, buf, _in_bytes(spec, 0, idx)).astype(
            acc.dtype)
    if q:
        x_zp, amult, y_zp = spec.qmeta
        v = acc.astype(np.float32) / np.float32(cnt) - np.float32(x_zp)
        out = _requant(v, amult, y_zp)
    else:
        out = acc / np.float32(cnt)
    return np.where(e >= 0, out, 0).astype(out.dtype)


def grid_model(spec: K.OpSpec, buf: np.ndarray) -> None:
    """The chunk walk on the arena's bytes ``buf``, in grid order: chunks
    ascending, each chunk's units computed from the arena as it stands
    and, order 0 or 1, stored at once; order 2 stores every chunk only
    after all have computed (the grid-wide barrier)."""
    t, order = K.chunk_of(spec)
    units = _concat_units if spec.kind == "concat" else _mean_units
    out = K.operand_addr(spec, None)[0]
    isz = _isz(spec)
    staged = []
    for c in range(t.chunks):
        u = np.arange(c * t.per, min((c + 1) * t.per, t.units))
        v = units(spec, buf, u, t.vec).view(np.uint8)
        at = (out + (u[:, None] * t.vec * isz
                     + np.arange(t.vec * isz)).reshape(-1))
        if order == K.EW_OVERLAP:
            staged.append((at, v))
        else:
            buf[at] = v
    for at, v in staged:
        buf[at] = v


def _arena_for(spec: K.OpSpec, seed: int) -> np.ndarray:
    """A seeded arena reaching the spec's operands: flat bytes, or a typed
    (rows, rowlen) array."""
    if spec.rowlen:
        return _typed_arena(spec.dtype, _rows(spec) + 2, spec.rowlen, seed)
    isz = _isz(spec)
    n = max(arena_bytes(spec, i)[1]
            for i in [None] + list(range(len(spec.in_off)))) // isz + 64
    rng = np.random.default_rng(seed)
    if spec.dtype == "i8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(np.float32).view(np.uint8)


def _assert_close(spec: K.OpSpec, got: np.ndarray, want: np.ndarray,
                  exact: bool) -> None:
    """Arena bytes outside the output's block equal; inside, bit for bit
    (``exact``, or int8) or within 1e-4 absolute plus 1e-4 relative."""
    got = got.view(np.uint8).reshape(-1)
    want = want.view(np.uint8).reshape(-1)
    lo, hi = arena_bytes(spec, None)
    outside = np.ones(got.size, bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if exact or spec.dtype == "i8":
        np.testing.assert_array_equal(got[lo:hi], want[lo:hi])
    else:
        np.testing.assert_allclose(got[lo:hi].view(np.float32),
                                   want[lo:hi].view(np.float32),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", HAND_BUILT)
def test_grid_model_matches_plain_and_pallas(source, dtype):
    """The numpy model of the grid against the plain version on the same
    seeded arena (the CPU route of the wrapper: concat and int8 mean bit
    for bit, f32 mean 1e-4) and against the reference's Pallas kernel in
    interpret mode (int8 bit-exact, f32 1e-4)."""
    spec = _hand_built(source, dtype)
    arena = _arena_for(spec, 7)
    got = arena.copy()
    grid_model(spec, got.view(np.uint8).reshape(-1))
    plain = torch.from_numpy(arena.copy())
    before = dict(K.LAUNCHES)
    K.apply_op(plain, spec)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    _assert_close(spec, got, plain.numpy(),
                  exact=spec.kind == "concat")
    want = np.asarray(R.apply_op(jnp.asarray(arena), _ref_spec(spec), (),
                                 interpret=True))
    _assert_close(spec, got, want, exact=False)


#: zoo-shaped specs at their real widths, cut from the programs: the
#: widest densenet_121 concat and the resnet_50_v2 head's mean, flat
#: (order word 1) and blocked
ZOO_PICKS = [("densenet_121", "flat", "concat"),
             ("densenet_121", "blocks", "concat"),
             ("resnet_50_v2", "flat", "mean"),
             ("resnet_50_v2", "blocks", "mean")]


@pytest.mark.parametrize("model,route,kind", ZOO_PICKS)
def test_grid_model_matches_plain_at_zoo_widths(model, route, kind):
    """The grid model on a zoo spec at its real width, on a seeded arena of
    the program's size, against the plain version (f32: the concat bit for
    bit, the mean within 1e-4)."""
    specs = [s for s in _program(model, route) if s.kind == kind]
    spec = max(specs, key=lambda s: K._elems(s.out_shape))
    rows = max(arena_bytes(spec, i)[1] for i in
               [None] + list(range(len(spec.in_off))))
    rows = -(-rows // (spec.rowlen * 4)) if spec.rowlen else rows
    arena = _typed_arena("f32", rows, spec.rowlen, 3) if spec.rowlen else \
        np.random.default_rng(3).standard_normal(-(-rows // 4)).astype(
            np.float32).view(np.uint8)
    got = arena.copy()
    grid_model(spec, got.view(np.uint8).reshape(-1))
    plain = torch.from_numpy(arena.copy())
    K.apply_plain(plain, spec)
    _assert_close(spec, got, plain.numpy(), exact=kind == "concat")
