"""The rest of the zoo on the port's CPU route against the JAX package:
``resnet50_v2`` (f32 and int8) and ``densenet121`` (int8) at 32x32, and the
reference's test graph ``allops`` (f32 and int8), which together run every
op kind the arena executors have (pool, elementwise, matmul, pad and the
standalone concat beside conv and the head).

Each graph is compiled by both packages, its weights and calibration are
carried onto the port's graph (``params_from_reference``), and the port's
cuda backend with ``device="cpu"`` (every kernel's plain PyTorch version)
runs the same numpy inputs as the reference's ``numpy`` backend (``allops``:
also the reference's flat Pallas program in interpret mode), under the
reference's ``compare_outputs`` tolerances (f32 1e-4, int8 <= 1 LSB). The
port's flat lowering must equal the reference's spec for spec.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from repro.core import zoo as rzoo
from repro.core.exec import compare_outputs as r_compare
from repro.core.exec import get_backend as r_backend
from repro.core.exec import ops as RX
from repro.core.exec.pallas_backend import PallasExecutor
from repro.core.graph import Graph as RGraph
from repro.core.pipeline import compile as r_compile

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import compare_outputs, get_backend
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.kernels import arena_ops as K

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    """The chip script as a module (its graph builders need no card)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

#: label -> (reference builder, port builder)
GRAPHS = {
    "resnet50_v2_32_f32": (lambda: rzoo.resnet50_v2(32, 4),
                           lambda: tzoo.resnet50_v2(32, 4)),
    "resnet50_v2_32_i8": (lambda: rzoo.resnet50_v2(32, 1),
                          lambda: tzoo.resnet50_v2(32, 1)),
    "densenet121_32_i8": (lambda: rzoo.densenet121(32, 1),
                          lambda: tzoo.densenet121(32, 1)),
    "allops_f32": (lambda: CS.allops_graph(4, RGraph),
                   lambda: CS.allops_graph(4)),
    "allops_i8": (lambda: CS.allops_graph(1, RGraph),
                  lambda: CS.allops_graph(1)),
}

_CACHE = {}


def _carried(label: str, seed: int = 0):
    """Both compiled plans, the reference's params, the port's params
    carried from them, and one set of numpy inputs."""
    if label not in _CACHE:
        rb, tb = GRAPHS[label]
        ref = r_compile(rb(), verify="off")
        port = t_compile(tb(), verify="off")
        rw = RX.synth_weights(ref.graph, seed)
        rq = RX.calibrate(ref.graph, seed, rw) \
            if RX.needs_quant(ref.graph) else None
        inputs = (RX.quant_inputs(ref.graph, rq, seed) if rq is not None
                  else RX.random_inputs(ref.graph, seed))
        tw, tq = TX.params_from_reference(ref.graph, rw, rq, port.graph)
        _CACHE[label] = (ref, port, (rw, rq), (tw, tq), inputs)
    return _CACHE[label]


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_lowering_equals_reference(label):
    ref, port, (_, rq), (_, tq), _ = _carried(label)
    assert port.offsets_by_name() == ref.offsets_by_name()
    want = PallasExecutor(layout="flat").lower(ref.plan, rq)
    got = CudaExecutor(device="cpu").lower(port.plan, tq)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_port_cpu_route_matches_reference(label):
    ref, port, (rw, rq), (tw, tq), inputs = _carried(label)
    K.reset_launches()
    got = get_backend("cuda", device="cpu").execute(port, inputs, tw,
                                                    quant=tq)
    assert sum(K.LAUNCHES.values()) == 0     # the CPU route launches nothing
    want = r_backend("numpy").execute(ref, inputs, rw, quant=rq)
    r_compare(want, got, exact=False, label=f"{label}: port vs ref numpy")
    if label.startswith("allops"):
        want_pl = r_backend("pallas", layout="flat").execute(
            ref, inputs, rw, quant=rq)
        r_compare(want_pl, got, exact=False,
                  label=f"{label}: port vs ref pallas flat")
    own = get_backend("numpy").execute(port, inputs, tw, quant=tq)
    compare_outputs(own, got, exact=False, label=f"{label}: port numpy")
    for v in got.values():
        assert np.isfinite(v.astype(np.float64)).all()


def test_every_kernel_kind_is_on_these_paths():
    """Between them the graphs lower to every kernel of the flat program
    but the fused chain (the flagship's, tests/test_torch_slice.py); the
    streaming kernels run on the streaming route
    (tests/test_torch_stream.py)."""
    kernels = set()
    for label in GRAPHS:
        ref, port, _, (_, tq), _ = _carried(label)
        kernels |= {K.KERNEL_OF[s.kind] for s in
                    CudaExecutor(device="cpu").lower(port.plan, tq)}
    assert kernels == set(K.LAUNCHES) - {"arena_fused_chain"} - set(
        K.STREAM_KERNEL_OF.values())


def test_nasnet_graph_fault_is_refused_by_both_packages():
    """nasnet_mobile's stem_r2_a1 adds a (28, 28, 22) tensor to a
    (56, 56, 22) one in both packages' zoo (its ``fit`` keeps the 111-row
    input at stride 1), so no backend executes the row; the port's
    wrapper refuses the spec as the numpy backends do."""
    g = tzoo.nasnet_mobile(64, 4)
    name, (a, b) = CS.graph_fault(g)
    assert name == "stem_r2_a1" and a[:2] == (8, 8) and b[:2] == (16, 16)
    assert CS.graph_fault(rzoo.nasnet_mobile(64, 4))[0] == name
    op = next(op for op in g.ops if op.name == name)
    spec = K.OpSpec(kind="elementwise", in_off=(0, 0),
                    in_shape=tuple(tuple(t.shape) for t in op.inputs),
                    out_off=0, out_shape=tuple(op.output.shape),
                    meta=("add",))
    with pytest.raises(ValueError, match="broadcast"):
        K.descriptor_words(spec)
    with pytest.raises(ValueError):
        RX.eval_op(op, [np.zeros(a, np.float32), np.zeros(b, np.float32)])


def test_chip_smoke_costs_every_kind():
    """chip_smoke's bound model covers every lowered kind, and a library
    yardstick is never claimed for the int8 paths."""
    _, port, _, (_, tq), _ = _carried("allops_i8")
    for spec in CudaExecutor(device="cpu").lower(port.plan, tq):
        nbytes, ops, rate = CS.spec_cost(spec)
        assert nbytes > 0 and ops > 0 and rate == CS.INT8_OPS_S
        assert CS.bound_ms(spec) > 0
    spec, _ = CS.fused_demo_spec("f32", 4, 4, 2)
    nbytes, ops, rate = CS.spec_cost(spec)
    assert rate == CS.F32_OPS_S and ops > sum(
        CS.spec_cost(st)[1] for st in spec.stages if st.kind == "conv2d")
