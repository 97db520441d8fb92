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
    grid, group, ctr = K.ew_grid(spec)
    assert grid == t.chunks <= (K.EW_RESIDENT if order == K.EW_OVERLAP
                                else K.EW_GRID)
    if order == K.EW_OVERLAP:
        assert group == grid and ctr == K.EW_COUNTER_BYTES
        assert bp.parts[0] == ("ctr", True, 0) and bp.parts[1][0] == "chunk"
    else:
        assert (group, ctr) == (0, 0) and bp == K.BufferPlan(0, 0, ())
    return order
