"""The PyTorch port's planning core against the JAX package's: imports,
graphs, safe overlaps, plans, lowering and weight synthesis.

Inputs are made from seeds with numpy and cross the packages as numpy
arrays. Plans, offsets, OpSpecs and weights must be exactly equal.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import zoo as rzoo
from repro.core.exec import ops as RX
from repro.core.exec.pallas_backend import PallasExecutor
from repro.core.overlap import safe_overlap as r_safe_overlap
from repro.core.pipeline import compile as r_compile

from repro_torch.core import exec as TXE
from repro_torch.core import pipeline as tpipe
from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.overlap import safe_overlap as t_safe_overlap
from repro_torch.core.pipeline import compile as t_compile

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (label, builder args, compile kwargs) of the plan-equality cases
PLAN_CASES = [
    ("flagship_int8", (0.25, 128, 1), {}),
    ("flagship_f32", (0.25, 128, 4), {}),
    ("reduced_flagship_batch2", (0.25, 32, 1), {"batch": 2}),
]


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_port_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.core import zoo\n"
        "from repro_torch.core.pipeline import compile\n"
        "from repro_torch.core.exec import get_backend\n"
        "cp = compile(zoo.mobilenet_v1(0.25, 32, 1))\n"
        "out = get_backend('cuda', device='cpu').execute(cp)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print(sorted(out), cp.peak_bytes)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "prob_out" in r.stdout


_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
_REPRO_IMPORT = re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "src" / "repro_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_source_imports_neither_jax_nor_reference(path):
    src = (ROOT / path).read_text()
    assert not _JAX_IMPORT.search(src), f"{path} imports jax"
    assert not _REPRO_IMPORT.search(src), f"{path} imports repro"


# ---------------------------------------------------------------------------
# graphs and overlaps
# ---------------------------------------------------------------------------


def _graph_fields(g):
    def tensor(t):
        return (t.name, tuple(t.shape), t.dtype_bytes, t.kind, t.batch,
                t.alias_of.name if t.alias_of is not None else None)
    return (g.name,
            [(op.name, op.kind, repr(sorted(op.params.items())),
              [tensor(t) for t in op.inputs],
              [tensor(t) for t in op.outputs]) for op in g.ops],
            [tensor(t) for t in g.tensors])


@pytest.mark.parametrize("name", sorted(rzoo.TABLE3_MODELS))
def test_graphs_equal(name):
    ref = rzoo.TABLE3_MODELS[name][0]()
    port = tzoo.TABLE3_MODELS[name][0]()
    assert _graph_fields(port) == _graph_fields(ref)


@pytest.mark.parametrize("args,method", [
    ((0.25, 128, 1), "analytic"), ((0.25, 128, 1), "algorithmic"),
    ((0.25, 32, 1), "analytic"), ((0.25, 32, 1), "algorithmic"),
    ((0.25, 32, 1), "trace")])
def test_safe_overlap_equal(args, method):
    ref, port = rzoo.mobilenet_v1(*args), tzoo.mobilenet_v1(*args)
    n = 0
    for rop, top in zip(ref.ops, port.ops):
        for i in range(len(rop.inputs)):
            try:
                want = r_safe_overlap(rop, i, method=method)
            except ValueError:
                with pytest.raises(ValueError):
                    t_safe_overlap(top, i, method=method)
                continue
            assert t_safe_overlap(top, i, method=method) == want, \
                (rop.name, i)
            n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# plans and lowering
# ---------------------------------------------------------------------------


def _compile_both(args, kw):
    ref = r_compile(rzoo.mobilenet_v1(*args), budget_s=0, verify="off", **kw)
    port = t_compile(tzoo.mobilenet_v1(*args), budget_s=0, verify="off",
                     **kw)
    return ref, port


@pytest.mark.parametrize("label,args,kw", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plans_equal(label, args, kw):
    ref, port = _compile_both(args, kw)
    assert port.winner == ref.winner
    assert port.peak_bytes == ref.peak_bytes
    assert port.baseline_bytes == ref.baseline_bytes
    assert port.offsets_by_name() == ref.offsets_by_name()
    assert [op.name for op in port.plan.order] == \
        [op.name for op in ref.plan.order]
    if label == "flagship_int8":
        assert (port.winner, port.peak_bytes, port.baseline_bytes) == \
            ("fuse", 49_805, 98_304)


@pytest.mark.parametrize("label,args,kw", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_lowering_equal(label, args, kw):
    ref, port = _compile_both(args, kw)
    rw = RX.synth_weights(ref.graph, 0)
    rq = RX.calibrate(ref.graph, 0, rw) if RX.needs_quant(ref.graph) \
        else None
    tw = TX.synth_weights(port.graph, 0)
    tq = TX.calibrate(port.graph, 0, tw) if TX.needs_quant(port.graph) \
        else None
    want = PallasExecutor(layout="flat").lower(ref.plan, rq)
    got = CudaExecutor(device="cpu").lower(port.plan, tq)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    if label.startswith("flagship"):
        assert len(got) == 29
        fused = [s for s in got if s.kind == "fused"]
        assert len(fused) == 1 and len(fused[0].stages) == 17
        assert fused[0].scratch_rows == (25_600 if label.endswith("int8")
                                         else 102_400)


# ---------------------------------------------------------------------------
# weights, inputs, calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("bits", [1, 4])
def test_weights_inputs_calibration_bit_equal(seed, bits):
    ref = r_compile(rzoo.mobilenet_v1(0.25, 128, bits), verify="off").graph
    port = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off").graph
    rw, tw = RX.synth_weights(ref, seed), TX.synth_weights(port, seed)
    for rop, top in zip(ref.ops, port.ops):
        assert rw[id(rop)].keys() == tw[id(top)].keys()
        for k in rw[id(rop)]:
            np.testing.assert_array_equal(tw[id(top)][k], rw[id(rop)][k])
    ri, ti = RX.random_inputs(ref, seed), TX.random_inputs(port, seed)
    assert ri.keys() == ti.keys()
    for k in ri:
        np.testing.assert_array_equal(ti[k], ri[k])
    if bits == 1:
        rq, tq = RX.calibrate(ref, seed, rw), TX.calibrate(port, seed, tw)
        assert {k: (v.scale, v.zero_point) for k, v in tq.tensors.items()} \
            == {k: (v.scale, v.zero_point) for k, v in rq.tensors.items()}
        for rop, top in zip(ref.ops, port.ops):
            assert tq.weight_scale.get(id(top)) == \
                rq.weight_scale.get(id(rop))
            if id(rop) in rq.weights_q:
                np.testing.assert_array_equal(
                    tq.weights_q[id(top)]["filter"],
                    rq.weights_q[id(rop)]["filter"])


def test_params_from_reference_round_trips():
    ref = r_compile(rzoo.mobilenet_v1(0.25, 128, 1), verify="off").graph
    port = t_compile(tzoo.mobilenet_v1(0.25, 128, 1), verify="off").graph
    rw = RX.synth_weights(ref, 1)
    rq = RX.calibrate(ref, 1, rw)
    tw, tq = TX.params_from_reference(ref, rw, rq, port)
    # the carried params equal the port's own synthesis at the same seed
    ow = TX.synth_weights(port, 1)
    oq = TX.calibrate(port, 1, ow)
    for op in port.ops:
        for k in ow[id(op)]:
            np.testing.assert_array_equal(tw[id(op)][k], ow[id(op)][k])
        if id(op) in oq.weights_q:
            np.testing.assert_array_equal(tq.weights_q[id(op)]["filter"],
                                          oq.weights_q[id(op)]["filter"])
    assert tq.tensors == oq.tensors
    assert tq.weight_scale == oq.weight_scale
    # and back onto the port's own graph: an identity
    bw, bq = TX.params_from_reference(port, tw, tq, port)
    for op in port.ops:
        for k in tw[id(op)]:
            np.testing.assert_array_equal(bw[id(op)][k], tw[id(op)][k])
    assert bq.tensors == tq.tensors
    # graphs of different networks are refused
    with pytest.raises(ValueError):
        TX.params_from_reference(ref, rw, rq,
                                 tzoo.mobilenet_v1(0.25, 32, 1))


# ---------------------------------------------------------------------------
# devices, registry, caches
# ---------------------------------------------------------------------------


def test_registry_has_numpy_and_cuda_only():
    assert TXE.available_backends() == ("numpy", "cuda")


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default route is the card")
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TXE.get_backend("cuda").execute(cp)
    with pytest.raises(RuntimeError):
        cp.execute(backend="cuda")
    with pytest.raises(RuntimeError):
        t_compile(tzoo.mobilenet_v1(0.25, 32, 1), backend="cuda")


def test_other_programs_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CudaExecutor(device="cpu", layout="blocks")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CudaExecutor(device="cpu", mode="streaming")


def test_executor_caches_lowering_and_params():
    cp = t_compile(tzoo.mobilenet_v1(0.25, 32, 1))
    be = CudaExecutor(device="cpu")
    a = be.execute(cp)
    b = be.execute(cp)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    info = be.lowering_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)


def test_disk_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_DMO_TORCH_CACHE_DIR", raising=False)
    assert tpipe._disk_cache_dir().name == "repro-dmo-torch"
    monkeypatch.setenv("REPRO_DMO_CACHE_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_DMO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    assert tpipe._disk_cache_dir() == tmp_path / "port"
    assert tpipe.TPU_FUSE_BUDGET == 16 * 1024 * 1024
