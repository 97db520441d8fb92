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
