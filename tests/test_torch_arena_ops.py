"""Each kernel's plain PyTorch version (the CPU route of its wrapper)
against the JAX package's Pallas kernel in interpret mode, on the same
seeded flat byte arena and the same spec; the whole arena is compared.

Tolerances: int8 bit-exact, except softmax and sigmoid (<= 1 LSB: exp
differs by an ulp between the two libraries); f32 1e-4 absolute plus 1e-4
relative (summation order).
"""
import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arena_ops as R

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import arena_bytes as _arena_bytes
from _torch_block_cases import check_ew_spec, check_tile_spec
from _torch_block_cases import tile_conflicts as _tile_conflicts

ARENA = 1024      # elements of a synthetic arena (at least)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    """The chip script as a module (its spec builders need no card)."""
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


def _arena(dtype: str, seed: int, n: int = ARENA) -> np.ndarray:
    """``n`` seeded elements (at least ARENA) as arena bytes."""
    rng = np.random.default_rng(seed)
    n = max(n, ARENA)
    if dtype == "i8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.standard_normal(n).astype(np.float32).view(np.uint8)


def _extent(spec: K.OpSpec) -> int:
    """Elements of the arena a spec's operands reach."""
    isz = 1 if spec.dtype == "i8" else 4
    ends = [off // isz + K._elems(shp)
            for off, shp in zip(spec.in_off, spec.in_shape)]
    return max(ends + [spec.out_off // isz + K._elems(spec.out_shape)])


def _weight(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    if dtype == "i8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _compare(spec: K.OpSpec, got: np.ndarray, want: np.ndarray) -> None:
    n = 1
    for s in spec.out_shape:
        n *= s
    isz = 1 if spec.dtype == "i8" else 4
    lo, hi = spec.out_off, spec.out_off + n * isz
    outside = np.ones(got.size, bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if spec.dtype == "i8":
        g = got[lo:hi].view(np.int8).astype(np.int32)
        w = want[lo:hi].view(np.int8).astype(np.int32)
        atol = CS.lsb_limit(spec)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    else:
        np.testing.assert_allclose(got[lo:hi].view(np.float32),
                                   want[lo:hi].view(np.float32),
                                   rtol=1e-4, atol=1e-4)


def _run_both(spec: K.OpSpec, arena: np.ndarray, weights) -> None:
    want = np.asarray(R.apply_op(
        jnp.asarray(arena), _ref_spec(spec),
        tuple(jnp.asarray(w) for w in weights), interpret=True))
    t = torch.from_numpy(arena.copy())
    tw = [torch.from_numpy(w) for w in weights]
    if spec.kind == "fused":
        w = K.pack_weights(spec, tw)
    else:
        w = tw[0] if tw else None
    before = dict(K.LAUNCHES)
    K.apply_op(t, spec, w)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    _compare(spec, t.numpy(), want)


QM = (-3, float(np.float32(0.0123)), 5)

#: (id, kind, in_shape, out_shape, meta, in_off, out_off) in elements
CONV_CASES = [
    ("conv_same_s1", "conv2d", (6, 7, 3), (6, 7, 5),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), 0, 40),
    ("conv_valid_s2", "conv2d", (9, 9, 4), (4, 4, 3),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 300, 0),
    ("conv_same_s2_edge", "conv2d", (8, 8, 3), (4, 4, 4),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 10, 0),
    ("conv_band_neg_pad", "conv2d", (12, 6, 2), (3, 6, 4),
     (3, 3, 1, 1, 1, 1, -4, 1, 1), 0, 150),
    ("conv_1x1_band", "conv2d", (16, 5, 4), (3, 5, 6),
     (1, 1, 1, 1, 1, 1, -8, 0, 1), 0, 300),
    ("conv_dilated", "conv2d", (8, 8, 2), (4, 4, 3),
     (3, 3, 1, 1, 2, 2, 2, 2, 1), 0, 128),
    ("dw_in_place", "depthwise_conv2d", (6, 6, 4), (6, 6, 4),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), 8, 8),
    ("dw_mult2_overlap", "depthwise_conv2d", (5, 5, 3), (5, 5, 6),
     (3, 3, 1, 1, 1, 1, 1, 1, 2), 0, 30),
    ("dw_s2_in_place", "depthwise_conv2d", (8, 8, 4), (4, 4, 4),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 20, 20),
    # a row of 8,450 outputs (more than 512 threads x 16 registers once
    # held), output overlapping its input
    ("conv_wide_row_overlap", "conv2d", (2, 130, 4), (2, 130, 65),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), 0, 500),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_plain_matches_pallas(case, dtype):
    _, kind, ishp, oshp, meta, ioff, ooff = case
    isz = 1 if dtype == "i8" else 4
    spec = K.OpSpec(kind=kind, in_off=(ioff * isz,), in_shape=(ishp,),
                    out_off=ooff * isz, out_shape=oshp, dtype=dtype,
                    meta=meta, qmeta=QM if dtype == "i8" else ())
    w = _weight(K._weight_shape(spec), dtype, 1)
    _run_both(spec, _arena(dtype, 2, _extent(spec)), [w])


HEAD_CASES = [
    ("mean", K.OpSpec(kind="mean", in_off=(10,), in_shape=((4, 4, 16),),
                      out_off=10, out_shape=(16,), meta=((0, 1),))),
    ("mean_last_axes", K.OpSpec(kind="mean", in_off=(0,),
                                in_shape=((3, 5, 8),), out_off=200,
                                out_shape=(3,), meta=((1, 2),))),
    ("fc_overlap", K.OpSpec(kind="fully_connected", in_off=(25,),
                            in_shape=((32,),), out_off=20,
                            out_shape=(20,))),
    ("fc_rows", K.OpSpec(kind="fully_connected", in_off=(0,),
                         in_shape=((3, 16),), out_off=100,
                         out_shape=(3, 10))),
    ("softmax_in_place", K.OpSpec(kind="softmax", in_off=(3,),
                                  in_shape=((50,),), out_off=3,
                                  out_shape=(50,))),
    ("softmax_rows", K.OpSpec(kind="softmax", in_off=(0,),
                              in_shape=((4, 25),), out_off=40,
                              out_shape=(4, 25))),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", HEAD_CASES, ids=[c[0] for c in HEAD_CASES])
def test_head_plain_matches_pallas(case, dtype):
    _, spec = case
    isz = 1 if dtype == "i8" else 4
    if spec.kind == "softmax":
        qm = ((float(np.float32(0.05)), 3), (float(np.float32(1 / 256)),
                                              -128))
    elif spec.kind == "mean":
        qm = (-3, float(np.float32(1.7)), 2)
    else:
        qm = (4, float(np.float32(0.0021)), -1)
    spec = dataclasses.replace(
        spec, dtype=dtype, qmeta=qm if dtype == "i8" else (),
        in_off=tuple(o * isz for o in spec.in_off),
        out_off=spec.out_off * isz)
    ws = ([_weight(K._weight_shape(spec), dtype, 3)]
          if spec.kind == "fully_connected" else [])
    _run_both(spec, _arena(dtype, 4), ws)


#: (id, in_shape, out_shape, meta, in_off, out_off) in elements; TF SAME
#: pads are uneven, so (ph, pw) are the leading pads only
POOL_CASES = [
    ("max_same_s2", (9, 9, 3), (5, 5, 3), (3, 3, 2, 2, 1, 1, "max"), 0, 300),
    ("max_same_s2_uneven", (8, 8, 4), (4, 4, 4), (3, 3, 2, 2, 0, 0, "max"),
     40, 0),
    ("max_valid_s1", (6, 5, 3), (4, 3, 3), (3, 3, 1, 1, 0, 0, "max"), 300, 0),
    ("avg_same_s1_in_place", (6, 6, 4), (6, 6, 4),
     (3, 3, 1, 1, 1, 1, "avg"), 8, 8),
    ("avg_valid_s2_overlap", (8, 8, 4), (4, 4, 4),
     (2, 2, 2, 2, 0, 0, "avg"), 0, 100),
    ("avg_same_s2", (7, 7, 2), (4, 4, 2), (3, 3, 2, 2, 1, 1, "avg"), 200, 0),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pool_plain_matches_pallas(case, dtype):
    _, ishp, oshp, meta, ioff, ooff = case
    isz = 1 if dtype == "i8" else 4
    spec = K.OpSpec(kind="pool", in_off=(ioff * isz,), in_shape=(ishp,),
                    out_off=ooff * isz, out_shape=oshp, dtype=dtype,
                    meta=meta,
                    qmeta=(-3, float(np.float32(0.87)), 5)
                    if dtype == "i8" else ())
    _run_both(spec, _arena(dtype, 6, _extent(spec)), [])


S3 = (4, 5, 6)
#: (id, fn, in_shapes, in_offs, out_off) in elements; outputs overlap an
#: operand where the offsets say so
EW_CASES = [
    ("relu_overlap", "relu", (S3,), (10,), 40),
    ("relu6_in_place", "relu6", (S3,), (7,), 7),
    ("sigmoid", "sigmoid", (S3,), (0,), 300),
    ("identity_overlap", "identity", (S3,), (100,), 60),
    ("add_over_both", "add", (S3, S3), (0, 200), 100),
    ("mul", "mul", (S3, S3), (0, 200), 500),
    ("sub_in_place", "sub", (S3, S3), (300, 0), 300),
    ("add_bcast_last", "add", (S3, (6,)), (0, 300), 0),
    ("mul_bcast_mid", "mul", (S3, (5, 1)), (0, 400), 10),
    ("sub_bcast_3d", "sub", (S3, (1, 1, 6)), (200, 0), 150),
]


def _ew_qmeta(fn: str, n_in: int):
    in_q = ((0.05, 3), (0.07, -2))[:n_in]
    out_q = (float(np.float32(1 / 256)), -128) if fn == "sigmoid" \
        else (0.09, 1)
    return (tuple((float(np.float32(sc)), zp) for sc, zp in in_q),
            (float(np.float32(out_q[0])), out_q[1]))


def _ew_case_spec(case, dtype: str) -> K.OpSpec:
    _, fn, shapes, offs, ooff = case
    isz = 1 if dtype == "i8" else 4
    return K.OpSpec(kind="elementwise", in_off=tuple(o * isz for o in offs),
                    in_shape=shapes, out_off=ooff * isz, out_shape=shapes[0],
                    dtype=dtype, meta=(fn,),
                    qmeta=_ew_qmeta(fn, len(shapes)) if dtype == "i8"
                    else ())


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", EW_CASES, ids=[c[0] for c in EW_CASES])
def test_elementwise_plain_matches_pallas(case, dtype):
    spec = _ew_case_spec(case, dtype)
    _run_both(spec, _arena(dtype, 7, _extent(spec)), [])


#: graphs whose elementwise specs the order-word check covers, on each
#: route (the flagship has none outside its fused chain, whose stages keep
#: the one-CTA routine)
EW_GRAPHS = {
    "flagship": lambda: tzoo.mobilenet_v1(0.25, 128, 1),
    "resnet50_v2_f32": lambda: tzoo.resnet50_v2(32, 4),
    "resnet50_v2_int8": lambda: tzoo.resnet50_v2(32, 1),
    "allops_f32": lambda: CS.allops_graph(4),
    "allops_int8": lambda: CS.allops_graph(1),
    "stream_allops_f32": lambda: CS.stream_allops_graph(4),
    "stream_allops_int8": lambda: CS.stream_allops_graph(1),
}
EW_ROUTES = {"flat": {}, "blocks": {"layout": "blocks"},
             "streaming": {"mode": "streaming"}}


@pytest.mark.parametrize("source", [
    f"{g}-{r}" for g in sorted(EW_GRAPHS) for r in EW_ROUTES] + [
    f"{c[0]}-{dt}" for c in EW_CASES for dt in ("i8", "f32")])
def test_ew_order_word_matches_the_byte_ranges(source):
    """Every elementwise spec of a route (or a hand-built EW_CASES spec)
    through the brute-force byte check of its order word, units, chunks
    and buffers (``_torch_block_cases.check_ew_spec``)."""
    name, kind = source.rsplit("-", 1)
    if name in EW_GRAPHS:
        specs = CudaExecutor(device="cpu", **EW_ROUTES[kind]).program(
            t_compile(EW_GRAPHS[name](), backend="numpy"))[0]
        ew = [s for s in specs if s.kind == "elementwise"]
        assert all(K.runs_ew_grid(s) for s in ew)
        assert bool(ew) == (name != "flagship")
    else:
        ew = [_ew_case_spec(next(c for c in EW_CASES if c[0] == name),
                            kind)]
    orders = [check_ew_spec(s) for s in ew]
    if source == "resnet50_v2_f32-flat":   # residual adds below their input
        assert set(orders) == {K.EW_DISJOINT, K.EW_ALIGNED, K.EW_OVERLAP}


def test_ew_cases_take_every_order_word():
    """The hand-built elementwise cases reach all three order words in
    both tiers: an output above its input, one in place, one apart."""
    for dtype in ("i8", "f32"):
        words = {c[0]: K.ew_order(_ew_case_spec(c, dtype)) for c in EW_CASES}
        assert set(words.values()) == {K.EW_DISJOINT, K.EW_ALIGNED,
                                       K.EW_OVERLAP}
        assert (words["relu_overlap"], words["relu6_in_place"],
                words["sigmoid"]) == (K.EW_OVERLAP, K.EW_ALIGNED,
                                      K.EW_DISJOINT)


#: (id, kind, in_shapes, out_shape, meta, in_offs, out_off, int8 qmeta)
BLOCK_CASES = [
    ("matmul_overlap", "matmul", ((16, 8), (8, 2)), (16, 2), (), (0, 200),
     100, (3, -2, float(np.float32(0.0123)), 5)),
    ("matmul_3d", "matmul", ((2, 8, 8), (8, 5)), (2, 8, 5), (), (300, 0),
     300, (-1, 4, float(np.float32(0.0071)), -3)),
    ("pad_overlap", "pad", ((4, 4, 4),), (6, 6, 4),
     (((1, 1), (1, 1), (0, 0)),), (0,), 50,
     ((-3, float(np.float32(0.9))), (4,))),
    ("pad_uneven", "pad", ((3, 4, 2),), (5, 5, 3),
     (((0, 2), (1, 0), (0, 1)),), (100,), 0,
     ((2, float(np.float32(1.1))), (-5,))),
    ("concat_2", "concat", ((4, 4, 3), (4, 4, 5)), (4, 4, 8), (-1,),
     (0, 48), 20, (((-3, float(np.float32(0.8))),
                    (4, float(np.float32(1.3)))), (2,))),
    ("concat_4_overlap", "concat",
     ((3, 3, 2), (3, 3, 1), (3, 3, 4), (3, 3, 2)), (3, 3, 9), (-1,),
     (0, 18, 27, 63), 10,
     (tuple((zp, float(np.float32(m))) for zp, m in
            ((1, 0.5), (-2, 1.0), (0, 1.7), (5, 0.9))), (-1,))),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_whole_block_plain_matches_pallas(case, dtype):
    """matmul, pad and the standalone concat."""
    _, kind, shapes, oshp, meta, offs, ooff, qm = case
    isz = 1 if dtype == "i8" else 4
    spec = K.OpSpec(kind=kind, in_off=tuple(o * isz for o in offs),
                    in_shape=shapes, out_off=ooff * isz, out_shape=oshp,
                    dtype=dtype, meta=meta,
                    qmeta=qm if dtype == "i8" else ())
    _run_both(spec, _arena(dtype, 8, _extent(spec)), [])


@pytest.mark.parametrize("dtype", ["i8", "f32"])
def test_fused_chain_with_pool_and_elementwise_stages(dtype):
    spec, nbytes = CS.fused_demo_spec(dtype, 6, 5, 3)
    assert {st.kind for st in spec.stages} == K.FUSED_STAGE_KINDS - {
        "depthwise_conv2d"}
    isz = 1 if dtype == "i8" else 4
    w = _weight((3, 3, 3, 3), dtype, 9)
    if dtype == "f32":
        w = w * np.float32(0.2)
    _run_both(spec, _arena(dtype, 9, nbytes // isz), [w])


def _flagship_fused(bits: int):
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    g = cp.graph
    w = TX.synth_weights(g, 0)
    q = TX.calibrate(g, 0, w) if bits == 1 else None
    specs = CudaExecutor(device="cpu").lower(cp.plan, q)
    (spec,) = [s for s in specs if s.kind == "fused"]
    members = [op for op in cp.plan.order if op.params.get("fuse_chain")]
    ws = [q.weights_q[id(op)]["filter"] if q is not None
          else w[id(op)]["filter"]
          for op in members if op.kind in K.WEIGHTED_KINDS]
    return spec, ws


@pytest.mark.parametrize("bits", [1, 4])
def test_fused_chain_plain_matches_pallas(bits):
    spec, ws = _flagship_fused(bits)
    assert len(spec.stages) == 17 and spec.stages[-1].kind == "concat"
    dtype = "i8" if bits == 1 else "f32"
    isz = 1 if bits == 1 else 4
    n = max([spec.out_off + 32 * 32 * 16 * isz]
            + [off + 64 * 64 * 8 * isz for off in spec.in_off])
    rng = np.random.default_rng(5)
    if dtype == "i8":
        arena = rng.integers(0, 256, n, dtype=np.uint8)
    else:
        arena = rng.standard_normal(-(-n // 4)).astype(np.float32).view(
            np.uint8)
    _run_both(spec, arena, ws)


# ---------------------------------------------------------------------------
# descriptors and wrapper checks
# ---------------------------------------------------------------------------


def test_descriptor_words_conv_and_fused():
    spec = K.OpSpec(kind="depthwise_conv2d", in_off=(8,),
                    in_shape=((5, 5, 3),), out_off=30, out_shape=(5, 5, 6),
                    dtype="i8", meta=(3, 3, 1, 1, 1, 1, 1, 1, 2), qmeta=QM)
    w = K.descriptor_words(spec)
    assert w.dtype == np.int32 and w.size == K.DESC_WORDS
    assert (w[K.D_KIND], w[K.D_QUANT], w[K.D_IN_OFF], w[K.D_OUT_OFF]) == \
        (K.K_DEPTHWISE, 1, 8, 30)
    assert tuple(w[K.D_IH:K.D_OC + 1]) == (5, 5, 3, 5, 5, 6)
    assert tuple(w[K.D_KH:K.D_MULT + 1]) == spec.meta
    assert w[K.D_AMULT:K.D_AMULT + 1].view(np.float32)[0] == \
        np.float32(QM[1])
    # flat addressing: one image row per row (L = used), n elements
    a = K.D_ADDR
    assert tuple(w[a:a + K.ADDR_WORDS]) == (30, 1, 1, 0, 30, 150)
    assert tuple(w[a + K.ADDR_WORDS:a + 2 * K.ADDR_WORDS]) == \
        (15, 1, 1, 0, 15, 75)
    assert K.DESC_WORDS >= K.D_ADDR + K.ADDR_WORDS * (K.MAX_CAT + 1)
    # the standalone conv's order mode and tiling, and where its tile
    # footprint lives: the output [30, 180) overlaps the input [8, 83)
    tl = K.conv_tiling(spec)
    assert w[K.D_ORDER] == K.conv_order(spec) != K.ORDER_DISJOINT
    assert tuple(w[K.D_TILING:K.D_TILING + len(tl)]) == tuple(tl)
    assert K.D_TILING + len(tl) <= K.BUFFER_WORD["tile"]
    assert tl.vo == 1 and tl.ib == min(3, (tl.to - 1) // 2 + 1)
    assert tl.ntiles == 5 * tl.tpr and tl.ps == 16
    assert tl.fp == _round16(3 * tl.fw * tl.ps)
    assert tuple(w[K.BUFFER_WORD["tile"]:][:2]) == (0, 0)
    disjoint = dataclasses.replace(spec, out_off=200)
    assert K.descriptor_words(disjoint)[K.D_ORDER] == K.ORDER_DISJOINT
    # a wrapper called without a descriptor uploads it once per spec
    cached = K._cached_descriptor(spec, "cpu")
    assert cached is K._cached_descriptor(spec, "cpu")
    assert np.array_equal(cached.numpy(), w)
    # a streaming conv's body is a tile kernel's too: its order mode (from
    # the window's rows) and tiling follow the stream block; the rolling
    # kernel keeps no window or slot buffer, only counters, footprint and
    # filter chunks
    stream = dataclasses.replace(spec, rowlen=32, in_rows=((5, 15),),
                                 out_rows=(5, 30), win_rows=40,
                                 win_starts=(0,), in_off=(6,), out_off=0)
    assert K.kernel_of(stream) == "arena_stream_roll"
    sw = K.descriptor_words(stream)
    body = sw[sw[K.S_BODY]:]
    # (its 8-row window from row 0 clamps the input's rows 6..10 into rows
    # 6 and 7, clear of the output's rows 0..4)
    assert body[K.D_ORDER] == K.conv_order(stream) == K.ORDER_DISJOINT
    assert tuple(body[K.D_TILING:K.D_TILING + len(tl)]) == \
        tuple(K.conv_tiling(stream))
    assert [n for n, _, _ in K.buffer_plan(stream).parts] == \
        ["ctr", "tile", "wts"]
    assert sw[K.S_BODY] == 32   # the stream block: its one start, padded
    fused, _ = _flagship_fused(1)
    fw = K.descriptor_words(fused)
    assert fw.size == K.DESC_WORDS * 18 and fw[0] == 17
    cat = fw[17 * K.DESC_WORDS:]
    assert (cat[K.D_KIND], cat[K.D_NIN], cat[K.D_OUTER],
            cat[K.D_INNER_OUT]) == (K.K_CONCAT, 8, 1, 32 * 32 * 16)
    offs, total = K.weight_offsets(fused)
    assert all(o % 16 == 0 for o in offs if o is not None)
    assert total == K.pack_weights(
        fused, [torch.from_numpy(x) for x in _flagship_fused(1)[1]]).numel()


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def _tile_specs(label: str, layout: str):
    """The conv and the pool specs of a graph's program."""
    graph = {"flagship": lambda: tzoo.mobilenet_v1(0.25, 128, 1),
             "resnet50_v2_f32": lambda: tzoo.resnet50_v2(32, 4),
             "resnet50_v2_int8": lambda: tzoo.resnet50_v2(32, 1),
             "densenet121_f32": lambda: tzoo.densenet121(32, 4)}[label]()
    specs = CudaExecutor(device="cpu", layout=layout).program(
        t_compile(graph, backend="numpy"))[0]
    return ([s for s in specs if K.kernel_of(s) == "arena_conv"],
            [s for s in specs if K.kernel_of(s) == "arena_pool"])


@pytest.mark.parametrize("layout", ["flat", "blocks"])
@pytest.mark.parametrize("label", ["flagship", "resnet50_v2_f32",
                                   "resnet50_v2_int8", "densenet121_f32"])
def test_conv_tiles_keep_the_row_order(label, layout):
    """Every conv and pool spec of the flagship, resnet50_v2(32) and
    densenet121(32) (its max pool and three average transitions) through
    ``_torch_block_cases.check_tile_spec``: the disjoint word is the byte
    ranges' disjointness; no tile's store meets the reads of a tile of a
    later row (the invariant the kernel's waits rely on), so no spec needs
    its rows run one after another; the tiles cover every output once;
    every footprint fits its shared memory budget or lies in per-CTA
    slices of the workspace, after the counters."""
    convs, pools = _tile_specs(label, layout)
    if label != "densenet121_f32":
        assert len(convs) == (25 if label == "flagship" else 53)
    assert len(pools) == {"flagship": 0, "densenet121_f32": 4}.get(label, 1)
    for spec in convs + pools:
        check_tile_spec(spec)


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_order_word_covers_hand_built_overlaps(case, dtype):
    """On hand-built specs (in place, diagonal, a wide row) the order word
    is at least what the tiles need: rows one after another wherever a
    later row reads an earlier row's store, else staged waits wherever the
    operands share a byte."""
    _, kind, in_shape, out_shape, meta, in_off, out_off = case
    isz = 1 if dtype == "i8" else 4
    spec = K.OpSpec(kind=kind, in_off=(in_off * isz,), in_shape=(in_shape,),
                    out_off=out_off * isz, out_shape=out_shape, dtype=dtype,
                    meta=meta, qmeta=QM if dtype == "i8" else ())
    word = K.descriptor_words(spec)[K.D_ORDER]
    (ilo, ihi), (olo, ohi) = _arena_bytes(spec, 0), _arena_bytes(spec, None)
    assert (word == K.ORDER_DISJOINT) == (ihi <= olo or ohi <= ilo)
    if _tile_conflicts(spec):
        assert word == K.ORDER_ROWS
    if case[0] == "dw_in_place":    # row 1 reads row 0's store
        assert word == K.ORDER_ROWS
    if case[0] == "dw_s2_in_place":  # stride 2 stays behind its reads
        assert word == K.ORDER_STAGED


def test_fused_scratch_branches():
    """A chain's buffers: its counters (a ticket word a level, a word a
    barrier) and the regions of its non-terminal stages (16 on the
    flagship, 89,088 B int8) in the global workspace, cached per spec; each
    tile's footprint and filter chunks in shared memory, or past the
    conv's budget one global footprint slice a CTA, the grid then capped
    at the slices."""
    spec, _ = _flagship_fused(1)
    s = K.chain_schedule(spec)
    tiles = [t for st, t in zip(s.stages, s.tilings)
             if st.kind in K.ROW_KINDS]
    fp, wts = max(t.fp for t in tiles), max(2 * t.ch * t.to for t in tiles)
    assert (s.counter_bytes, s.region_bytes) == (32, 89_088)
    assert s.n_barriers == 2 and len(s.regions) == 16
    bp = K.buffer_plan(spec)
    assert bp.parts == (("ctr", True, 0), ("regions", True, 32),
                        ("tile", False, 0), ("wts", False, fp))
    assert (bp.smem, bp.gbytes) == (fp + _round16(wts), 32 + 89_088)
    words = K.descriptor_words(spec)
    assert tuple(words[K.BUFFER_WORD["tile"]:][:2]) == (0, 0)
    assert tuple(words[K.BUFFER_WORD["wts"]:][:2]) == (0, fp)
    assert K.workspace(spec, "cpu").numel() == 32 + 89_088
    assert K.workspace(spec, "cpu") is K.workspace(spec, "cpu")
    deep, _ = CS.deep_chain_spec()
    ds = K.chain_schedule(deep)
    (dt,) = [t for st, t in zip(ds.stages, ds.tilings)
             if st.kind == "conv2d"]
    assert dt.fp > K.CONV_SMEM_BUDGET and ds.grid <= K.CONV_SLICES
    bp = K.buffer_plan(deep)
    assert bp.on_global("tile") and not bp.on_global("wts")
    assert bp.gbytes == ds.counter_bytes + ds.region_bytes + \
        K.CONV_SLICES * dt.fp
    words = K.descriptor_words(deep)
    assert words[K.H_FP] == dt.fp and \
        tuple(words[K.BUFFER_WORD["tile"]:][:2]) == (
            1, ds.counter_bytes + ds.region_bytes)


def test_buffer_plan_rows_and_whole_blocks():
    """A pool or a conv of any row width cuts its rows into column tiles
    whose footprints stage in shared memory (a pool needs no filter
    chunks), its counters first in the workspace, and a conv whose footprint
    exceeds the budget stages it in a global slice per CTA, its counters
    first in the workspace. An elementwise op of order word 0 or 1 (an add
    written over its input, resnet_50_v2's) needs no buffer at all; one of
    order 2 (written diagonally below its input) its barrier counter, then
    one chunk's staging in shared memory, or past the budget a global
    slice per chunk."""
    spec, _ = CS.wide_row_spec(4_096, 16)
    pool = dataclasses.replace(spec, kind="pool", out_shape=(3, 4_096, 16),
                               in_shape=((3, 4_096, 16),),
                               meta=(3, 3, 1, 1, 1, 1, "max"))
    narrow = dataclasses.replace(pool, out_shape=(3, 130, 65),
                                 in_shape=((3, 130, 65),))
    for p, ow in ((pool, 4_096), (narrow, 130)):
        tl = K.conv_tiling(p)
        assert K.kernel_of(p) == "arena_pool" and tl.ch == 0
        assert tl.ntiles == 3 * tl.tpr and tl.tc * tl.ncb >= ow
        assert tl.fp <= K.CONV_SMEM_BUDGET
        assert K.buffer_plan(p) == K.BufferPlan(
            tl.fp, K.conv_counter_bytes(p),
            (("ctr", True, 0), ("tile", False, 0), ("wts", False, tl.fp)))
    for ow, oc in ((4_096, 16), (130, 65)):
        conv, _ = CS.wide_row_spec(ow, oc)
        tl = K.conv_tiling(conv)
        assert tl.ntiles == 3 * tl.tpr and tl.tc * tl.ncb >= ow
        assert K.conv_counter_bytes(conv) == 16 + 16
        wbytes = _round16(2 * tl.ch * tl.to * 4)
        assert K.buffer_plan(conv) == K.BufferPlan(
            tl.fp + wbytes, K.conv_counter_bytes(conv),
            (("ctr", True, 0), ("tile", False, 0), ("wts", False, tl.fp)))
    deep, _ = CS.deep_footprint_spec()
    tl = K.conv_tiling(deep)
    assert (tl.tc, tl.fw, tl.ps) == (1, 3, 6_004)
    assert tl.fp == 3 * 3 * 6_004 * 4
    assert tl.fp > K.CONV_SMEM_BUDGET
    assert K.buffer_plan(deep) == K.BufferPlan(
        2 * tl.ch * tl.to * 4, 32 + K.CONV_SLICES * tl.fp,
        (("ctr", True, 0), ("tile", True, 32), ("wts", False, 0)))
    assert K.conv_grid(deep) == (9, 3, 32)
    add = K.OpSpec(kind="elementwise", in_off=(0, 0), in_shape=((56, 56,
                   256),) * 2, out_off=0, out_shape=(56, 56, 256),
                   meta=("add",))
    assert K.ew_order(add) == K.EW_ALIGNED
    assert K.buffer_plan(add) == K.BufferPlan(0, 0, ())
    w = K.descriptor_words(add)
    assert (w[K.D_KIND], w[K.D_FN], w[K.D_EN], w[K.D_BCAST]) == \
        (K.K_ELEMENTWISE, K.EW_CODE["add"], 56 * 56 * 256, 0)
    n = 56 * 56 * 256
    assert (w[K.D_ORDER], *w[K.D_TILING:K.D_TILING + 4]) == \
        (K.EW_ALIGNED, 4, n // 4, -(-n // 4 // K.EW_GRID), K.EW_GRID)
    assert K.chunk_grid(add) == (K.EW_GRID, 0, 0)
    diag = dataclasses.replace(add, in_off=(1024, 4 * n + 1024))
    t = K.ew_tiling(diag)
    assert K.ew_order(diag) == K.EW_OVERLAP and t.chunks == K.EW_RESIDENT
    assert K.buffer_plan(diag) == K.BufferPlan(
        _round16(t.per * 16), K.EW_COUNTER_BYTES,
        (("ctr", True, 0), ("chunk", False, 0)))
    assert K.chunk_grid(diag) == (t.chunks, t.chunks, K.EW_COUNTER_BYTES)
    big = dataclasses.replace(diag, in_shape=((224, 224, 256),) * 2,
                              out_shape=(224, 224, 256),
                              in_off=(1024, 16 * n + 1024))
    t = K.ew_tiling(big)
    assert t.per * 16 > K.EW_SMEM_BUDGET
    assert K.buffer_plan(big) == K.BufferPlan(
        0, K.EW_COUNTER_BYTES + t.chunks * t.per * 16,
        (("ctr", True, 0), ("chunk", True, K.EW_COUNTER_BYTES)))
    w = K.descriptor_words(big)
    assert tuple(w[K.BUFFER_WORD["chunk"]:][:2]) == (1, K.EW_COUNTER_BYTES)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = K.OpSpec(kind="conv2d", in_off=(0,), in_shape=((4, 4, 2),),
                    out_off=0, out_shape=(4, 4, 3), dtype="f32",
                    meta=(1, 1, 1, 1, 1, 1, 0, 0, 1))
    arena = torch.zeros(256, dtype=torch.uint8)
    with pytest.raises(ValueError):          # int8 filter on an f32 op
        K.arena_conv(arena, spec, torch.zeros((1, 1, 2, 3), dtype=torch.int8))
    with pytest.raises(ValueError):          # not a byte arena
        K.arena_conv(arena.view(torch.int8), spec,
                     torch.zeros((1, 1, 2, 3)))
    with pytest.raises(ValueError, match="row-blocked"):  # a byte arena
        K.arena_conv(arena, dataclasses.replace(spec, rowlen=16),
                     torch.zeros((1, 1, 2, 3)))
    pool = K.OpSpec(kind="pool", in_off=(0,), in_shape=((4, 4, 2),),
                    out_off=0, out_shape=(2, 2, 2), dtype="f32",
                    meta=(2, 2, 2, 2, 0, 0, "max"))
    blocked = dataclasses.replace(pool, rowlen=16, in_rows=((4, 8),),
                                  out_rows=((2, 4)))
    with pytest.raises(ValueError, match="row-blocked"):  # wrong rowlen
        K.apply_op(torch.zeros((8, 8)), blocked)
    with pytest.raises(ValueError, match="row-blocked"):  # wrong tier
        K.apply_op(torch.zeros((8, 16), dtype=torch.int8), blocked)
    with pytest.raises(ValueError, match="flat"):         # a typed arena
        K.apply_op(torch.zeros((8, 16)), pool)
    stream = dataclasses.replace(blocked, win_rows=16, win_starts=(0,))
    with pytest.raises(ValueError, match="row-blocked"):  # wrong rowlen
        K.apply_op(torch.zeros((8, 8)), stream)
    with pytest.raises(ValueError, match="row-blocked"):  # a byte arena
        K.apply_op(torch.zeros(512, dtype=torch.uint8), stream)
    with pytest.raises(ValueError, match="leaves"):       # too few rows
        K.apply_op(torch.zeros((4, 16)), stream)
    bad = K.OpSpec(kind="elementwise", in_off=(0, 64), in_shape=((2, 2, 4),
                   (4, 4, 4)), out_off=0, out_shape=(2, 2, 4),
                   meta=("add",))
    with pytest.raises(ValueError, match="broadcast"):
        K.apply_op(torch.zeros(512, dtype=torch.uint8), bad)
    with pytest.raises(ValueError, match="broadcast"):
        K.descriptor_words(bad)


def test_descriptor_words_new_kinds():
    pool = K.OpSpec(kind="pool", in_off=(8,), in_shape=((112, 112, 64),),
                    out_off=0, out_shape=(56, 56, 64), dtype="i8",
                    meta=(3, 3, 2, 2, 0, 0, "max"),
                    qmeta=(-3, float(np.float32(0.5)), 4))
    w = K.descriptor_words(pool)
    assert (w[K.D_KIND], w[K.D_MULT], w[K.D_DH], w[K.D_X_ZP]) == \
        (K.K_POOL, 1, 1, -3)
    assert tuple(w[K.D_IH:K.D_OC + 1]) == (112, 112, 64, 56, 56, 64)
    # a pool runs arena_conv's row tiles: its order word (the output [0,
    # 200704) lies over the input [8, 802824)), its tiling, the footprint
    # in shared memory and no filter chunks
    tl = K.conv_tiling(pool)
    assert w[K.D_ORDER] == K.conv_order(pool) == K.ORDER_STAGED
    assert tuple(w[K.D_TILING:K.D_TILING + len(tl)]) == tuple(tl)
    assert tuple(w[K.BUFFER_WORD["tile"]:][:2]) == (0, 0)
    assert tuple(w[K.BUFFER_WORD["wts"]:][:2]) == (0, tl.fp)
    ew = K.OpSpec(kind="elementwise", in_off=(0, 400), in_shape=(S3, (5, 1)),
                  out_off=0, out_shape=S3, meta=("mul",))
    w = K.descriptor_words(ew)
    assert w[K.D_BCAST] == 1 and w[K.D_IN2_OFF] == 400
    assert tuple(w[K.D_EDIM0:K.D_EDIM0 + 6]) == (1, 1, 1, 4, 5, 6)
    assert tuple(w[K.D_BSTR0:K.D_BSTR0 + 6]) == (0, 0, 0, 0, 1, 0)
    # the grid body's order word (the broadcast operand [400, 420) lies
    # under the output [0, 480)) and 16-byte units in one chunk, staged in
    # shared memory after the barrier counter
    assert w[K.D_ORDER] == K.ew_order(ew) == K.EW_OVERLAP
    assert tuple(w[K.D_TILING:K.D_TILING + 4]) == tuple(K.ew_tiling(ew)) \
        == (4, 30, 30, 1)
    assert tuple(w[K.BUFFER_WORD["chunk"]:][:2]) == (0, 0)
    assert K.buffer_plan(ew).parts == (("ctr", True, 0),
                                       ("chunk", False, 0))
    mm = K.OpSpec(kind="matmul", in_off=(0, 512), in_shape=((16, 8), (8, 2)),
                  out_off=64, out_shape=(16, 2))
    w = K.descriptor_words(mm)
    assert tuple(w[K.D_MM:K.D_MN + 1]) == (16, 8, 2)
    pad = K.OpSpec(kind="pad", in_off=(0,), in_shape=((3, 4, 2),),
                   out_off=0, out_shape=(5, 5, 3),
                   meta=(((0, 2), (1, 0), (0, 1)),))
    w = K.descriptor_words(pad)
    assert tuple(w[K.D_PIN0:K.D_PN + 1]) == (1, 3, 4, 2, 0, 0, 1, 0,
                                             1, 5, 5, 3, 75)
    # row-blocked: byte offsets of whole rows, then (L, c, k, rl, used,
    # nblk) per operand: a packed input, a spanning output
    blk = dataclasses.replace(pool, in_off=(3,), out_off=10, rowlen=256,
                              in_rows=((3136, 256),), out_rows=(784, 256),
                              in_addr=((1, 28, 7168),),
                              out_addr=(1, 14, 3584))
    w = K.descriptor_words(blk)
    assert (w[K.D_IN_OFF], w[K.D_OUT_OFF]) == (3 * 256, 10 * 256)
    a = K.D_ADDR
    assert tuple(w[a:a + 6]) == (256, 1, 14, 3584, 256, 784 * 256)
    assert tuple(w[a + 6:a + 12]) == (256, 1, 28, 7168, 256, 3136 * 256)
    packed = dataclasses.replace(
        ew, rowlen=64, in_off=(0, 4), out_off=2, dtype="f32",
        in_rows=((2, 60), (1, 64)), out_rows=(2, 64),
        in_addr=((2, 1, 30), (1, 1, 64)), out_addr=(1, 1, 64))
    w = K.descriptor_words(packed)
    assert (w[K.D_IN_OFF], w[K.D_IN2_OFF], w[K.D_OUT_OFF]) == \
        (0, 4 * 64 * 4, 2 * 64 * 4)
    assert tuple(w[a + 6:a + 12]) == (64, 2, 1, 30, 60, 128)
    # its output block (rows 2-3) lies clear of both inputs; rows of 60
    # used elements in 64 still cut into whole 16-byte units
    assert w[K.D_ORDER] == K.EW_DISJOINT
    assert tuple(w[K.D_TILING:K.D_TILING + 4]) == (4, 32, 32, 1)


def test_every_kernel_has_a_source_a_counter_and_a_plain_version():
    from repro_torch.kernels import build
    # the standalone kernels (own signatures) are held by
    # tests/test_torch_kernels.py
    assert set(build.KERNELS) - set(build.ARGTYPES_OF) == set(
        K.LAUNCHES) == set(K.KERNEL_OF.values()) | set(
            K.STREAM_KERNEL_OF.values())
    assert set(CS.KERNELS) == set(build.KERNELS)
    for kind in K.KERNEL_OF:
        assert kind in ("conv2d", "depthwise_conv2d", "fully_connected",
                        "fused") or kind in K._UNWEIGHTED_PLAIN
    assert set(K.STREAM_KERNEL_OF) == set(K._STREAM_PLAIN)
