"""The slice as a whole on the CPU route: the JAX package's flagship graph,
weights and calibration carried onto the port's graph, executed by the
port's cuda backend with ``device="cpu"`` (every kernel's plain PyTorch
version), against the reference ``numpy`` backend and the reference Pallas
flat program (interpret mode), under the reference's ``compare_outputs``
tolerances (f32 1e-4, int8 <= 1 LSB).
"""
import numpy as np
import pytest

from repro.core import zoo as rzoo
from repro.core.exec import compare_outputs as r_compare
from repro.core.exec import get_backend as r_backend
from repro.core.exec import ops as RX
from repro.core.pipeline import compile as r_compile

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import compare_outputs, get_backend
from repro_torch.core.exec import ops as TX
from repro_torch.core.pipeline import compile as t_compile


def _carried(args, batch=1, seed=0):
    """Both compiled plans and the reference's params carried onto the
    port's graph; inputs made once with numpy."""
    ref = r_compile(rzoo.mobilenet_v1(*args), batch=batch, verify="off")
    port = t_compile(tzoo.mobilenet_v1(*args), batch=batch, verify="off")
    rw = RX.synth_weights(ref.graph, seed)
    rq = RX.calibrate(ref.graph, seed, rw) if RX.needs_quant(ref.graph) \
        else None
    inputs = (RX.quant_inputs(ref.graph, rq, seed) if rq is not None
              else RX.random_inputs(ref.graph, seed))
    tw, tq = TX.params_from_reference(ref.graph, rw, rq, port.graph)
    return ref, port, (rw, rq), (tw, tq), inputs


@pytest.mark.parametrize("bits", [1, 4])
def test_flagship_matches_reference_numpy_and_pallas_flat(bits):
    ref, port, (rw, rq), (tw, tq), inputs = _carried((0.25, 128, bits))
    assert port.offsets_by_name() == ref.offsets_by_name()
    got = get_backend("cuda", device="cpu").execute(
        port, inputs, tw, quant=tq)
    want_np = r_backend("numpy").execute(ref, inputs, rw, quant=rq)
    r_compare(want_np, got, exact=False, label="port cpu vs ref numpy")
    if bits == 1:
        # the reference's own flat Pallas program, interpret mode
        want_pl = r_backend("pallas", layout="flat").execute(
            ref, inputs, rw, quant=rq)
        r_compare(want_pl, got, exact=False,
                  label="port cpu vs ref pallas flat")
    # and against the port's own numpy backend, bit for bit on int8
    own = get_backend("numpy").execute(port, inputs, tw, quant=tq)
    compare_outputs(own, got, exact=(bits == 1), label="port numpy")
    for v in got.values():
        assert np.isfinite(v.astype(np.float64)).all()


def test_batched_reduced_flagship_matches_reference():
    ref, port, (rw, rq), (tw, tq), inputs = _carried((0.25, 32, 1), batch=2)
    got = get_backend("cuda", device="cpu").execute(
        port, inputs, tw, quant=tq)
    want = r_backend("numpy").execute(ref, inputs, rw, quant=rq)
    r_compare(want, got, exact=False, label="batch 2")
    assert got["prob_out"].shape == (2, 1000)


def test_flagship_compiles_and_verifies_numerically():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, 1))
    assert (cp.winner, cp.peak_bytes, cp.verified) == \
        ("fuse", 49_805, "numeric")
    # the default path of the slice: compile, then execute on the cuda
    # backend's CPU route, against the numpy backend
    be = get_backend("cuda", device="cpu")
    specs, ws, descs, arena = be.program(cp)
    assert arena.numel() == 49_805 and len(specs) == 29
    assert descs == [None] * 29
    compare_outputs(get_backend("numpy").execute(cp), be.execute(cp),
                    exact=False, label="cuda cpu vs numpy")
