"""The row-blocked program of the port against the JAX package's: block
plans and lowered specs, each kind's plain blocked version against the
reference Pallas kernel in interpret mode (whole typed arenas compared),
the flagship end to end through ``layout="blocks"``, and the standalone
DMO depthwise conv.

Inputs are made from seeds with numpy and cross the packages as numpy
arrays. Plans and specs must be exactly equal. Tolerances are those of
``tests/test_torch_arena_ops.py``: int8 bit-exact except softmax and
sigmoid (<= 1 LSB: exp differs by an ulp between the two libraries); f32
1e-4 absolute plus 1e-4 relative (summation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zoo as rzoo
from repro.core.exec import compare_outputs as r_compare
from repro.core.exec import get_backend as r_backend
from repro.core.exec import ops as RX
from repro.core.exec.pallas_backend import PallasExecutor
from repro.core.graph import Graph as RGraph
from repro.core.pipeline import compile as r_compile
from repro.core.planner import legalise_for_blocks as r_legalise
from repro.kernels import arena_ops as R
from repro.kernels import ops as RO
from repro.kernels import ref as RREF

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import compare_outputs, get_backend
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.graph import Graph as TGraph
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.core.planner import legalise_for_blocks as t_legalise
from repro_torch.kernels import arena_ops as K
from repro_torch.kernels import ops as TO

from _torch_block_cases import (CS, POOL_QM, QM, _SOFTMAX_QM, _block_spec,
                                _compare_arena, _ew_qmeta, _ref_spec,
                                _rows, _typed_arena, _weight)


# ---------------------------------------------------------------------------
# block plans and lowered specs
# ---------------------------------------------------------------------------

#: label -> (make(package zoo, graph class), compile kwargs)
GRAPHS = {
    "flagship_int8": (lambda z, G: z.mobilenet_v1(0.25, 128, 1), {}),
    "flagship_f32": (lambda z, G: z.mobilenet_v1(0.25, 128, 4), {}),
    "flagship_int8_batch2": (lambda z, G: z.mobilenet_v1(0.25, 128, 1),
                             {"batch": 2}),
    "resnet50_v2_32_int8": (lambda z, G: z.resnet50_v2(32, 1), {}),
    "resnet50_v2_32_f32": (lambda z, G: z.resnet50_v2(32, 4), {}),
    "densenet121_32_int8": (lambda z, G: z.densenet121(32, 1), {}),
    "allops_f32": (lambda z, G: CS.allops_graph(4, G), {}),
    "allops_int8": (lambda z, G: CS.allops_graph(1, G), {}),
}


def _compile_both(label):
    build, kw = GRAPHS[label]
    ref = r_compile(build(rzoo, RGraph), budget_s=0, verify="off", **kw)
    port = t_compile(build(tzoo, TGraph), budget_s=0, verify="off", **kw)
    return ref, port


def _layouts(bp):
    return {s.name: dataclasses.astuple(lay)
            for s, lay in bp.layouts.items()}


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_block_plans_equal(label):
    ref, port = _compile_both(label)
    rbp, tbp = r_legalise(ref.plan), t_legalise(port.plan)
    assert (tbp.total_rows, tbp.arena_rowlen, tbp.packing, tbp.tiling) == \
        (rbp.total_rows, rbp.arena_rowlen, rbp.packing, rbp.tiling)
    assert tbp.padded_peak_bytes == rbp.padded_peak_bytes
    assert _layouts(tbp) == _layouts(rbp)
    assert tbp.row_overlaps == rbp.row_overlaps
    if label == "flagship_int8":
        assert (tbp.total_rows, tbp.arena_rowlen, tbp.packing) == \
            (96, 768, "packed")
    if label == "flagship_f32":
        assert tbp.padded_peak_bytes == 327_680


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_block_specs_equal(label):
    ref, port = _compile_both(label)
    rw = RX.synth_weights(ref.graph, 0)
    rq = RX.calibrate(ref.graph, 0, rw) if RX.needs_quant(ref.graph) \
        else None
    tw = TX.synth_weights(port.graph, 0)
    tq = TX.calibrate(port.graph, 0, tw) if TX.needs_quant(port.graph) \
        else None
    want = PallasExecutor(layout="blocks").lower_blocks(
        r_legalise(ref.plan), rq)
    got = CudaExecutor(device="cpu", layout="blocks").lower_blocks(
        t_legalise(port.plan), tq)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    if label in ("flagship_int8", "flagship_f32"):
        assert len(got) == 29
        (fused,) = [s for s in got if s.kind == "fused"]
        assert len(fused.stages) == 17
        assert fused.scratch_rows == (64 if label == "flagship_int8" else 32)
        # the card's placement: counters (one arena row's bytes), then a
        # region of whole rows for each of the 16 non-terminal stages
        sched = K.chain_schedule(fused)
        row = fused.rowlen * (1 if label == "flagship_int8" else 4)
        assert K.buffer_plan(fused).parts[:2] == (
            ("ctr", True, 0), ("regions", True, sched.counter_bytes))
        assert sched.counter_bytes == (row if label == "flagship_int8"
                                       else 4096)
        assert dict(K._buffer_needs(fused))["regions"] == (
            133_632 if label == "flagship_int8" else 356_352)


# ---------------------------------------------------------------------------
# each kind's plain blocked version against the reference kernel
# ---------------------------------------------------------------------------


def _run_both(spec: K.OpSpec, arena: np.ndarray, weights) -> None:
    want = np.asarray(R.apply_op(
        jnp.asarray(arena), _ref_spec(spec),
        tuple(jnp.asarray(w) for w in weights), interpret=True))
    t = torch.from_numpy(arena.copy())
    tw = [torch.from_numpy(w) for w in weights]
    w = K.pack_weights(spec, tw) if spec.kind == "fused" else \
        (tw[0] if tw else None)
    before = dict(K.LAUNCHES)
    K.apply_op(t, spec, w)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    _compare_arena(spec, t.numpy(), want)


#: (id, kind, L, ins, out, meta, legacy): ins/out are (shape, row offset,
#: addressing); outputs overlap inputs where the offsets say so
ROW_CASES = [
    ("conv_plain_overlap", "conv2d", 40,
     [((6, 7, 3), 0, "plain")], ((6, 7, 5), 3, "plain"),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), False),
    ("conv_packed_in_span_out", "conv2d", 32,
     [((8, 4, 2), 14, "packed")], ((8, 4, 12), 0, "span"),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), False),
    ("conv_s2_packed_out_overlap", "conv2d", 16,
     [((8, 8, 2), 1, "plain")], ((4, 4, 2), 0, "packed"),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), False),
    ("conv_band_neg_pad", "conv2d", 32,
     [((12, 6, 2), 0, "packed")], ((3, 6, 4), 5, "plain"),
     (3, 3, 1, 1, 1, 1, -4, 1, 1), False),
    ("conv_legacy_overlap", "conv2d", 32,
     [((6, 5, 3), 2, "legacy")], ((6, 5, 4), 0, "legacy"),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), True),
    ("dw_packed_in_place", "depthwise_conv2d", 64,
     [((6, 6, 4), 2, "packed")], ((6, 6, 4), 2, "packed"),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), False),
    ("dw_mult2_span_overlap", "depthwise_conv2d", 8,
     [((5, 5, 3), 4, "span")], ((5, 5, 6), 0, "span"),
     (3, 3, 1, 1, 1, 1, 1, 1, 2), False),
    ("dw_s2_legacy_in_place", "depthwise_conv2d", 40,
     [((8, 8, 4), 0, "legacy")], ((4, 4, 4), 0, "legacy"),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), True),
    ("pool_max_s2_packed", "pool", 64,
     [((9, 9, 3), 0, "packed")], ((5, 5, 3), 3, "packed"),
     (3, 3, 2, 2, 1, 1, "max"), False),
    ("pool_avg_span_in_place", "pool", 16,
     [((6, 6, 4), 1, "span")], ((6, 6, 4), 1, "span"),
     (3, 3, 1, 1, 1, 1, "avg"), False),
    ("pool_avg_valid_s2_legacy", "pool", 32,
     [((8, 8, 4), 0, "legacy")], ((4, 4, 4), 6, "legacy"),
     (2, 2, 2, 2, 0, 0, "avg"), True),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", ROW_CASES, ids=[c[0] for c in ROW_CASES])
def test_row_kinds_blocked_plain_matches_pallas(case, dtype):
    """conv2d, depthwise and pool over plain, packed, spanning and legacy
    operands, overlapped and in place, and a negative-pad band."""
    _, kind, L, ins, out, meta, legacy = case
    qm = POOL_QM if kind == "pool" else QM
    spec = _block_spec(kind, L, ins, out, meta, legacy, dtype, qm)
    ws = [] if kind == "pool" else [_weight(K._weight_shape(spec), dtype, 1)]
    _run_both(spec, _typed_arena(dtype, _rows(spec) + 2, L, 2), ws)


S3 = (4, 5, 6)


#: (id, kind, L, ins, out, meta, legacy, int8 qmeta)
BLOCK_CASES = [
    ("add_bcast_packed_to_dense", "elementwise", 64,
     [(S3, 0, "packed"), ((6,), 2, "dense")], (S3, 1, "dense"), ("add",),
     False, _ew_qmeta("add", 2)),
    ("relu6_span_in_place", "elementwise", 16,
     [(S3, 1, "span")], (S3, 1, "span"), ("relu6",), False,
     _ew_qmeta("relu6", 1)),
    ("relu_packed_overlap", "elementwise", 64,
     [(S3, 0, "packed")], (S3, 1, "packed"), ("relu",), False,
     _ew_qmeta("relu", 1)),
    ("sigmoid_dense_overlap", "elementwise", 16,
     [(S3, 3, "dense")], (S3, 0, "dense"), ("sigmoid",), False,
     _ew_qmeta("sigmoid", 1)),
    ("sub_legacy_over_both", "elementwise", 32,
     [(S3, 0, "legacy"), (S3, 4, "legacy")], (S3, 2, "legacy"), ("sub",),
     True, _ew_qmeta("sub", 2)),
    ("mul_bcast_mid_plain", "elementwise", 32,
     [(S3, 0, "plain"), ((5, 1), 4, "dense")], (S3, 5, "plain"), ("mul",),
     False, _ew_qmeta("mul", 2)),
    ("softmax_dense_in_place", "softmax", 16,
     [((50,), 1, "dense")], ((50,), 1, "dense"), (), False, _SOFTMAX_QM),
    ("softmax_rows_legacy", "softmax", 16,
     [((4, 25), 0, "dense")], ((4, 25), 3, "dense"), (), True,
     _SOFTMAX_QM),
    ("fc_dense_overlap", "fully_connected", 16,
     [((32,), 1, "dense")], ((20,), 0, "dense"), (), False,
     (4, float(np.float32(0.0021)), -1)),
    ("fc_rows_legacy", "fully_connected", 16,
     [((3, 16), 0, "dense")], ((3, 10), 3, "dense"), (), True,
     (4, float(np.float32(0.0021)), -1)),
    ("matmul_dense_overlap", "matmul", 16,
     [((16, 8), 0, "dense"), ((8, 2), 9, "dense")], ((16, 2), 6, "dense"),
     (), False, (3, -2, float(np.float32(0.0123)), 5)),
    ("concat_packed_plain", "concat", 32,
     [((4, 4, 3), 0, "packed"), ((4, 4, 5), 2, "plain")],
     ((4, 4, 8), 4, "plain"), (-1,), False,
     (((-3, float(np.float32(0.8))), (4, float(np.float32(1.3)))), (2,))),
    ("concat_4_span_overlap", "concat", 8,
     [((3, 3, 2), 0, "plain"), ((3, 3, 1), 3, "packed"),
      ((3, 3, 4), 5, "span"), ((3, 3, 2), 11, "plain")],
     ((3, 3, 9), 2, "span"), (-1,), False,
     (tuple((zp, float(np.float32(m))) for zp, m in
            ((1, 0.5), (-2, 1.0), (0, 1.7), (5, 0.9))), (-1,))),
    ("pad_packed_overlap", "pad", 32,
     [((4, 4, 4), 0, "packed")], ((6, 6, 4), 1, "plain"),
     (((1, 1), (1, 1), (0, 0)),), False,
     ((-3, float(np.float32(0.9))), (4,))),
    ("pad_uneven_legacy", "pad", 16,
     [((3, 4, 2), 6, "legacy")], ((5, 5, 3), 0, "legacy"),
     (((0, 2), (1, 0), (0, 1)),), True,
     ((2, float(np.float32(1.1))), (-5,))),
    ("mean_span_in", "mean", 32,
     [((4, 4, 16), 0, "span")], ((16,), 3, "dense"), ((0, 1),), False,
     (-3, float(np.float32(1.7)), 2)),
    ("mean_last_axes_legacy", "mean", 48,
     [((3, 5, 8), 1, "legacy")], ((3,), 0, "dense"), ((1, 2),), True,
     (-3, float(np.float32(1.7)), 2)),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_whole_block_kinds_blocked_plain_matches_pallas(case, dtype):
    """elementwise (broadcast and in place), softmax, FC, matmul, concat,
    pad and mean: every input decoded, the whole padded output block
    written."""
    _, kind, L, ins, out, meta, legacy, qm = case
    spec = _block_spec(kind, L, ins, out, meta, legacy, dtype, qm)
    ws = ([_weight(K._weight_shape(spec), dtype, 3)]
          if kind == "fully_connected" else [])
    _run_both(spec, _typed_arena(dtype, _rows(spec) + 2, L, 4), ws)


def _flagship_block_fused(bits: int):
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    g = cp.graph
    w = TX.synth_weights(g, 0)
    q = TX.calibrate(g, 0, w) if bits == 1 else None
    be = CudaExecutor(device="cpu", layout="blocks")
    bplan = be.legalised(cp.plan)
    (spec,) = [s for s in be.lower_blocks(bplan, q) if s.kind == "fused"]
    members = [op for op in cp.plan.order if op.params.get("fuse_chain")]
    ws = [q.weights_q[id(op)]["filter"] if q is not None
          else w[id(op)]["filter"]
          for op in members if op.kind in K.WEIGHTED_KINDS]
    return spec, ws, bplan


@pytest.mark.parametrize("bits", [1, 4])
def test_fused_chain_blocked_plain_matches_pallas(bits):
    """The flagship's band chain (17 stages: packed, spanning and plain
    operands, a typed scratch of 64 rows) on a seeded full-size arena."""
    spec, ws, bplan = _flagship_block_fused(bits)
    assert len(spec.stages) == 17 and spec.rowlen == bplan.arena_rowlen
    assert {st.in_addr[0][0] > 1 or st.in_addr[0][1] > 1
            for st in spec.stages} == {True, False}
    dtype = "i8" if bits == 1 else "f32"
    _run_both(spec, _typed_arena(dtype, bplan.total_rows,
                                 bplan.arena_rowlen, 5), ws)


@pytest.mark.parametrize("dtype", ["i8", "f32"])
def test_fused_chain_blocked_with_pool_and_elementwise_stages(dtype):
    spec, rows = CS.fused_demo_spec(dtype, 6, 5, 3, rowlen=16)
    assert spec.rowlen == 16 and {st.kind for st in spec.stages} == \
        K.FUSED_STAGE_KINDS - {"depthwise_conv2d"}
    w = _weight((3, 3, 3, 3), dtype, 9)
    _run_both(spec, _typed_arena(dtype, rows, 16, 9), [w])


# ---------------------------------------------------------------------------
# the flagship end to end through layout="blocks"
# ---------------------------------------------------------------------------


def _carried(bits: int, seed: int = 0):
    ref = r_compile(rzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    port = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    rw = RX.synth_weights(ref.graph, seed)
    rq = RX.calibrate(ref.graph, seed, rw) if RX.needs_quant(ref.graph) \
        else None
    inputs = (RX.quant_inputs(ref.graph, rq, seed) if rq is not None
              else RX.random_inputs(ref.graph, seed))
    tw, tq = TX.params_from_reference(ref.graph, rw, rq, port.graph)
    return ref, port, (rw, rq), (tw, tq), inputs


@pytest.mark.parametrize("bits", [1, 4])
def test_flagship_blocked_matches_reference_and_own_flat(bits):
    ref, port, (rw, rq), (tw, tq), inputs = _carried(bits)
    be = get_backend("cuda", device="cpu", layout="blocks")
    got = be.execute(port, inputs, tw, quant=tq)
    specs, _, descs, arena = be.program(port, inputs, tw, quant=tq)
    bp = be.legalised(port.plan)
    assert arena.dtype == (torch.int8 if bits == 1 else torch.float32)
    assert tuple(arena.shape) == (bp.total_rows, bp.arena_rowlen)
    assert arena.numel() * arena.element_size() == \
        (73_728 if bits == 1 else 327_680)
    assert len(specs) == 29 and descs == [None] * 29
    want = r_backend("pallas", layout="blocks").execute(
        ref, inputs, rw, quant=rq)
    r_compare(want, got, exact=False, label="port blocks vs ref blocks")
    flat = get_backend("cuda", device="cpu").execute(port, inputs, tw,
                                                     quant=tq)
    assert flat.keys() == got.keys()
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    compare_outputs(get_backend("numpy").execute(port, inputs, tw, quant=tq),
                    got, exact=False, label="port blocks vs numpy")


def test_auto_layout_runs_blocked_where_the_plan_legalises():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1), verify="off")
    be = CudaExecutor(device="cpu", layout="auto")
    specs, _, _, arena = be.program(cp)
    assert arena.dim() == 2 and all(s.rowlen for s in specs)
    np.testing.assert_array_equal(
        be.execute(cp)["prob_out"],
        CudaExecutor(device="cpu").execute(cp)["prob_out"])
    info = be.lowering_cache_info()
    assert info["misses"] == 1 and info["hits"] >= 1


def test_blocked_batch2_matches_flat():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1), batch=2, verify="off")
    got = CudaExecutor(device="cpu", layout="blocks").execute(cp)
    want = CudaExecutor(device="cpu").execute(cp)
    assert got["prob_out"].shape == (2, 1000)
    np.testing.assert_array_equal(got["prob_out"], want["prob_out"])


# ---------------------------------------------------------------------------
# the standalone DMO depthwise conv
# ---------------------------------------------------------------------------

#: the reference's DWCONV_CASES (tests/test_kernels.py)
DWCONV_CASES = [
    (16, 16, 8, 3, 1, 1), (17, 13, 4, 3, 2, 0), (20, 20, 16, 3, 2, 1),
    (12, 12, 8, 5, 1, 2), (8, 24, 2, 3, 1, 0), (15, 15, 1, 3, 3, 1),
]


@pytest.mark.parametrize("ih,iw,c,k,stride,pad", DWCONV_CASES)
def test_dmo_dwconv_matches_reference(ih, iw, c, k, stride, pad):
    rng = np.random.default_rng(ih * 100 + iw)
    x = rng.standard_normal((ih, iw, c)).astype(np.float32)
    w = rng.standard_normal((k, k, c)).astype(np.float32)
    got = TO.dmo_dwconv2d(x, w, stride=stride, pad=pad, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    want = np.asarray(RO.dmo_dwconv2d(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride, pad=pad,
                                      interpret=True))
    oracle = np.asarray(RREF.dwconv2d(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride, pad=pad))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)
    assert TO.dwconv_overlap_rows(ih, iw, c, k, stride, pad) == \
        RO.dwconv_overlap_rows(ih, iw, c, k, stride, pad)
    foot = TO.dmo_dwconv2d_footprint(ih, iw, c, k, stride, pad)
    assert foot == RO.dmo_dwconv2d_footprint(ih, iw, c, k, stride, pad)
    assert foot[0] < foot[1]


def test_dmo_dwconv_runs_on_the_card_unless_asked():
    x, w = np.zeros((4, 4, 2), np.float32), np.zeros((3, 3, 2), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default route is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.dmo_dwconv2d(x, w)
