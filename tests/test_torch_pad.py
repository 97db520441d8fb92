"""The chunk walk of ``arena_pad``, and of the staged pad body of
``arena_stream_stage`` (in place on the arena), through its Python mirror:
every pad spec of ``allops`` and ``stream_allops`` (f32 and int8) on the
flat, blocked and streaming programs, and hand-built ones, through a
brute-force byte check of the order word, the units, the descriptor and
the buffers; then a numpy model of the grid, unit by unit in grid order
(order word 2: every chunk staged before the stores), against
``pad_plain`` and against the JAX package's Pallas kernel in interpret
mode. A pad is a copy (int8: and a requantisation of each element), so
every comparison is bit for bit.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arena_ops as R

from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.core.planner import staged_slots
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import (CS, _block_spec, _elem_at, _elem_of,
                                _ref_spec, _rows, _typed_arena,
                                arena_bytes, check_grid_words)

ROUTES = {"flat": {}, "blocks": {"layout": "blocks"},
          "streaming": {"mode": "streaming"}}
GRAPHS = {"allops_f32": functools.partial(CS.allops_graph, 4),
          "allops_int8": functools.partial(CS.allops_graph, 1),
          "stream_allops_f32": functools.partial(CS.stream_allops_graph, 4),
          "stream_allops_int8": functools.partial(CS.stream_allops_graph, 1)}


@functools.lru_cache(maxsize=None)
def _program(label: str, route: str):
    cp = t_compile(GRAPHS[label](), backend="numpy")
    return tuple(CudaExecutor(device="cpu", **ROUTES[route]).program(cp)[0])


def _isz(spec: K.OpSpec) -> int:
    return 1 if spec.dtype == "i8" else 4


def _in_bytes(spec: K.OpSpec, e: np.ndarray) -> np.ndarray:
    """First arena byte of the input's tensor elements ``e``."""
    a = K.operand_addr(spec, 0)
    return a[0] + _elem_at(a, e) * _isz(spec)


def _sources(spec: K.OpSpec, e: np.ndarray) -> np.ndarray:
    """The input tensor element each output tensor element ``e`` reads, -1
    outside the input's box (the pad value)."""
    ind, lo, outd = K._pad_geometry(spec)
    coords = np.unravel_index(e, outd)
    src = [c - p for c, p in zip(coords, lo)]
    inside = np.all([(s >= 0) & (s < n) for s, n in zip(src, ind)], axis=0)
    idx = np.ravel_multi_index([np.where(inside, s, 0) for s in src], ind)
    return np.where(inside, idx, -1)


def check_pad_spec(spec: K.OpSpec) -> int:
    """Brute force over the bytes of a pad the grid runs; returns its order
    word after checking it and its units.

    - Order 0 only when no byte of an input element lies in the output's
      block (elements or padding, which the grid writes at any time), and
      exactly when the operands' blocks are disjoint; else order 2.
    - A 16-byte unit holds block padding only, or consecutive output
      elements of one innermost row that all lie outside the input's box,
      or all inside it on consecutive input elements that the input holds
      as one aligned 16-byte run; the unit's own bytes are aligned too."""
    assert K.runs_chunk_walk(spec) and spec.kind == "pad"
    isz = _isz(spec)
    ind, _, outd = K._pad_geometry(spec)
    n = K._elems(outd)
    oa = K.operand_addr(spec, None)
    lo, hi = oa[0], oa[0] + oa[6] * isz
    start = _in_bytes(spec, np.arange(K._elems(ind)))
    meets = any(((start + j >= lo) & (start + j < hi)).any()
                for j in range(isz))
    order = K.pad_order(spec)
    (ilo, ihi), (olo, ohi) = arena_bytes(spec, 0), arena_bytes(spec, None)
    assert order == (K.EW_OVERLAP if ilo < ohi and olo < ihi
                     else K.EW_DISJOINT)
    assert not meets or order == K.EW_OVERLAP, spec
    t = K.pad_tiling(spec)
    assert t.units * t.vec == oa[6] and t.vec in (1, 16 // isz)
    if t.vec > 1:
        e = _elem_of(oa, np.arange(t.units * t.vec), n).reshape(t.units,
                                                                  t.vec)
        pad = (e == -1).all(1)
        assert (pad | (e == e[:, :1] + np.arange(t.vec)).all(1)).all()
        assert (e[~pad, 0] // outd[3] == e[~pad, -1] // outd[3]).all()
        src = _sources(spec, e[~pad].reshape(-1)).reshape(-1, t.vec)
        out = (src == -1).all(1)
        assert (out | (src >= 0).all(1)).all()
        run = _elem_at(K.operand_addr(spec, 0), src[~out])
        assert (run == run[:, :1] + np.arange(t.vec)).all()
        assert (_in_bytes(spec, src[~out, 0]) % 16 == 0).all()
        assert lo % 16 == 0
    words = K.descriptor_words(spec)[-K.DESC_WORDS:]
    assert words[K.D_KIND] == K.K_PAD
    assert tuple(words[K.D_POUT0:K.D_POUT0 + 4]) == outd
    assert words[K.D_PN] == n
    check_grid_words(spec, order, t)
    return order


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_zoo_pads_are_disjoint(label, route):
    """The one pad of ``allops`` and of ``stream_allops``, f32 and int8,
    on each program, runs the pad's chunk walk (in place on the arena when
    staged) with order word 0: no byte of its input lies in its output's
    block, so no chunk waits and no workspace is taken."""
    pads = [s for s in _program(label, route) if s.kind == "pad"]
    assert len(pads) == 1
    (spec,) = pads
    assert K.kernel_of(spec) == ("arena_stream_stage" if route == "streaming"
                                 else "arena_pad")
    if route == "streaming":
        assert K.stream_form(spec) == "stage" and K.runs_in_place(spec)
        assert CS.card_staging_bytes(K, spec) == 0
    assert check_pad_spec(spec) == K.EW_DISJOINT
    # f32 rows of 4 or 8 channels take 16-byte units; int8 ones cannot
    assert K.pad_tiling(spec).vec == (4 if spec.dtype == "f32" else 1)


# ---------------------------------------------------------------------------
# hand-built specs
# ---------------------------------------------------------------------------

PAD_QM = CS.PAD_QM
HW = ((1, 1), (1, 1), (0, 0))

#: flat specs (offsets in elements): (id, in shape, pads, in offset, out
#: offset)
FLAT_CASES = [
    ("apart_c8", (4, 4, 8), HW, 0, 128),
    ("apart_c16", (4, 4, 16), HW, 0, 256),
    ("below_input", (4, 4, 16), HW, 80, 0),      # output starts below
    ("above_input", (4, 4, 16), HW, 0, 48),      # output starts inside
    ("in_place", (5, 3, 4), HW, 0, 0),
    ("inner_axis", (3, 5, 8), ((0, 0), (0, 0), (4, 4)), 0, 128),
    ("inner_odd", (3, 5, 8), ((0, 0), (1, 0), (1, 2)), 0, 200),
    ("one_axis", (10,), ((2, 3),), 0, 16),
    ("four_axes", (2, 3, 4, 4), ((1, 0), (0, 1), (1, 1), (0, 4)), 0, 96),
]
FLAT_ORDERS = {"apart_c8": K.EW_DISJOINT, "apart_c16": K.EW_DISJOINT,
               "below_input": K.EW_OVERLAP, "above_input": K.EW_OVERLAP,
               "in_place": K.EW_OVERLAP, "inner_axis": K.EW_DISJOINT,
               "inner_odd": K.EW_DISJOINT, "one_axis": K.EW_DISJOINT,
               "four_axes": K.EW_DISJOINT}

#: row-blocked specs, staged in the streaming program too: (id, L, in,
#: out, pads); addressing as ``_torch_block_cases._block_spec``
BLOCKED_CASES = [
    ("packed_overlap", 32, ((4, 4, 4), 0, "packed"),
     ((6, 6, 4), 1, "plain"), HW),
    ("dense_vec", 64, ((4, 4, 16), 0, "dense"), ((6, 6, 16), 4, "dense"),
     HW),
    ("plain_to_span", 16, ((4, 4, 4), 0, "plain"), ((6, 6, 4), 4, "span"),
     HW),
    ("span_in_place", 16, ((4, 4, 8), 0, "span"), ((6, 6, 8), 0, "span"),
     HW),
]
BLOCKED_ORDERS = {"packed_overlap": K.EW_OVERLAP,
                  "dense_vec": K.EW_DISJOINT,
                  "plain_to_span": K.EW_DISJOINT,
                  "span_in_place": K.EW_OVERLAP}


def _out_shape(shape, pads):
    return tuple(n + a + b for n, (a, b) in zip(shape, pads))


def _flat_spec(case, dtype: str) -> K.OpSpec:
    _, shape, pads, ioff, ooff = case
    isz = 1 if dtype == "i8" else 4
    return K.OpSpec(kind="pad", in_off=(ioff * isz,), in_shape=(shape,),
                    out_off=ooff * isz, out_shape=_out_shape(shape, pads),
                    dtype=dtype, meta=(pads,),
                    qmeta=PAD_QM if dtype == "i8" else ())


def _blocked_spec(case, dtype: str, streaming: bool) -> K.OpSpec:
    _, L, ins, out, pads = case
    spec = _block_spec("pad", L, [ins], out, (pads,), dtype=dtype,
                       qmeta=PAD_QM)
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
        return _flat_spec(next(c for c in FLAT_CASES if c[0] == name), dtype)
    return _blocked_spec(next(c for c in BLOCKED_CASES if c[0] == name),
                         dtype, route == "streaming")


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", HAND_BUILT)
def test_hand_built_pad_words_match_the_bytes(source, dtype):
    """Hand-built pads through the byte check take the order word listed
    for them: an output below its input, above it, over it in place or
    over a packed input take 2 (the streaming ones in place on the arena
    too), the others 0."""
    spec = _hand_built(source, dtype)
    name, route = source.rsplit("-", 1)
    want = (FLAT_ORDERS if route == "flat" else BLOCKED_ORDERS)[name]
    assert check_pad_spec(spec) == want
    if route == "streaming":
        assert K.kernel_of(spec) == "arena_stream_stage"
        assert K.runs_in_place(spec) and CS.card_staging_bytes(K, spec) == 0


def test_hand_built_pads_take_both_order_words_and_units():
    """Between them the hand-built pads reach both order words (0 and 2)
    and every unit: one element, and 16 bytes of f32 (4) and of int8
    (16)."""
    orders, vec = set(), set()
    for source in HAND_BUILT:
        for dtype in ("i8", "f32"):
            spec = _hand_built(source, dtype)
            orders.add(K.pad_order(spec))
            vec.add(K.pad_tiling(spec).vec)
    assert orders == {K.EW_DISJOINT, K.EW_OVERLAP}
    assert vec == {1, 4, 16}


def test_chip_pads_take_their_words():
    """The chip script's pads: ResNet50's stem pad (112, 112, 64) ->
    (114, 114, 64) apart (order word 0) and over its input (2), 16-byte
    units, about one a thread, over many chunks (f32: 264 for order 0, 132
    all resident for 2; int8 102), and the streaming pad whose TPU window
    is 819,200 B, in place."""
    for _, make, args in CS.HAND_PAD:
        spec, nbytes = make(*args)
        t, order = K.chunk_of(spec)
        assert order == (K.EW_DISJOINT if args[-1] == "apart"
                         else K.EW_OVERLAP)
        assert t.vec == 16 // _isz(spec) and t.chunks == min(
            -(-t.units // K.EW_THREADS),
            K.EW_GRID if order == K.EW_DISJOINT else K.EW_RESIDENT)
        assert nbytes >= arena_bytes(spec, None)[1]
        check_grid_words(spec, order, t)
    spec, rows = CS.stream_pad_spec()
    assert K.runs_in_place(spec) and CS.card_staging_bytes(K, spec) == 0
    assert spec.win_rows * spec.rowlen * 4 == 819_200
    assert check_pad_spec(spec) == K.EW_DISJOINT and rows >= _rows(spec)


# ---------------------------------------------------------------------------
# the grid in numpy, unit by unit in grid order
# ---------------------------------------------------------------------------

def _requant(acc: np.ndarray, mult: float, zp: int) -> np.ndarray:
    """requant_f of the kernels: f32 product, round half to even, + zp,
    clip to int8."""
    q = np.rint(acc.astype(np.float32) * np.float32(mult)) + np.float32(zp)
    return np.clip(q, -128, 127).astype(np.int8)


def _pad_units(spec: K.OpSpec, buf: np.ndarray, u: np.ndarray,
               vec: int) -> np.ndarray:
    """Output block elements of units ``u`` as ``pad_elem``/``pad_vec``
    compute them: the input element at the coordinate less the leading
    pads, or the pad value; int8 rescaled; block padding 0."""
    n = K._elems(spec.out_shape)
    e = _elem_of(K.operand_addr(spec, None),
                 (u[:, None] * vec + np.arange(vec)).reshape(-1), n)
    src = _sources(spec, np.maximum(e, 0))
    at = _in_bytes(spec, np.maximum(src, 0))
    if spec.dtype == "i8":
        (x_zp, mult), (y_zp,) = spec.qmeta
        x = np.where(src >= 0, buf.view(np.int8)[at], x_zp)
        out = _requant(x.astype(np.int32) - x_zp, mult, y_zp)
    else:
        out = np.where(src >= 0, buf.view(np.float32)[at // 4],
                       np.float32(0))
    return np.where(e >= 0, out, 0).astype(out.dtype)


def grid_model(spec: K.OpSpec, buf: np.ndarray) -> None:
    """The pad's chunk walk on the arena's bytes ``buf``, in grid order:
    chunks ascending, each chunk's units computed from the arena as it
    stands and, order 0, stored at once; order 2 stores every chunk only
    after all have computed (the grid-wide barrier)."""
    t, order = K.chunk_of(spec)
    out = K.operand_addr(spec, None)[0]
    isz = _isz(spec)
    staged = []
    for c in range(t.chunks):
        u = np.arange(c * t.per, min((c + 1) * t.per, t.units))
        v = _pad_units(spec, buf, u, t.vec).view(np.uint8)
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
    n = max(arena_bytes(spec, i)[1] for i in (None, 0)) // isz + 64
    rng = np.random.default_rng(seed)
    if spec.dtype == "i8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(np.float32).view(np.uint8)


def _bytes(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8).reshape(-1)


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("source", HAND_BUILT)
def test_grid_model_matches_plain_and_pallas(source, dtype):
    """The numpy model of the pad's grid against the plain version on the
    same seeded arena (the CPU route of the wrapper) and against the
    reference's Pallas kernel in interpret mode (its staged kernel, on its
    window, for a streaming spec), every arena byte equal."""
    spec = _hand_built(source, dtype)
    arena = _arena_for(spec, 7)
    got = arena.copy()
    grid_model(spec, _bytes(got))
    plain = torch.from_numpy(arena.copy())
    before = dict(K.LAUNCHES)
    K.apply_op(plain, spec)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    np.testing.assert_array_equal(_bytes(got), _bytes(plain.numpy()))
    want = np.asarray(R.apply_op(jnp.asarray(arena), _ref_spec(spec), (),
                                 interpret=True))
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", BLOCKED_CASES,
                         ids=[c[0] for c in BLOCKED_CASES])
def test_staged_pad_runs_in_place(case, dtype):
    """A staged pad of the streaming program through its plain version
    (``stream_stage_plain``: the blocked plain pad on the arena, in place
    as the kernel runs it) against the blocked spec's plain version and
    against the reference's ``_stream_stage_kernel`` in interpret mode,
    which copies the blocks through its window: the same arena, byte for
    byte; the kernel's descriptor holds the body at its arena offsets and
    no copy list."""
    spec = _blocked_spec(case, dtype, True)
    assert K.stream_form(spec) == "stage" and K.runs_in_place(spec)
    arena = _arena_for(spec, 11)
    got = torch.from_numpy(arena.copy())
    K.stream_stage_plain(got, spec)
    blocked = torch.from_numpy(arena.copy())
    K.pad_plain(blocked, K._blocked(spec))
    np.testing.assert_array_equal(got.numpy(), blocked.numpy())
    want = np.asarray(R.apply_op(jnp.asarray(arena), _ref_spec(spec), (),
                                 interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    words = K.descriptor_words(spec)
    body = words[words[K.S_BODY]:]
    assert words[K.S_BODY] == 32 and len(body) == K.DESC_WORDS
    assert (body[K.D_IN_OFF], body[K.D_OUT_OFF]) == (
        K.operand_addr(spec, 0)[0], K.operand_addr(spec, None)[0])


@pytest.mark.parametrize("which", ["stem_f32_apart", "stem_f32_over",
                                   "stem_i8_over", "stream_pad"])
def test_grid_model_matches_plain_at_real_widths(which):
    """The grid model at the chip script's widths against the plain
    version, every byte equal: ResNet50's stem pad (112, 112, 64) ->
    (114, 114, 64) apart and over its input (264 and 132 chunks of 16-byte
    units) and the streaming pad in place."""
    if which == "stream_pad":
        spec, rows = CS.stream_pad_spec()
        arena = _typed_arena("f32", rows, spec.rowlen, 5)
    else:
        _, dt, place = which.split("_")
        spec, nbytes = CS.pad_spec(dt, 112, 112, 64, place)
        rng = np.random.default_rng(5)
        arena = (rng.integers(0, 256, nbytes, dtype=np.uint8) if dt == "i8"
                 else rng.standard_normal(nbytes // 4).astype(
                     np.float32).view(np.uint8))
    got = arena.copy()
    grid_model(spec, _bytes(got))
    plain = torch.from_numpy(arena.copy())
    K.apply_plain(plain, spec)
    np.testing.assert_array_equal(_bytes(got), _bytes(plain.numpy()))
