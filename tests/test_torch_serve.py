"""The port's serving runtime against the JAX package's: ``FastExec``,
``PlanServer`` and ``throughput_demo`` (``repro_torch.serve`` against
``repro.serve``), test for test as ``tests/test_serving_runtime.py`` holds
the reference.

Both packages build the same graphs (``band_graph`` of
``tests/test_batching.py`` and the zoo's ``mobilenet_v1(0.25, 32, 1)``)
and are fed the same numpy inputs. The port's ``FastExec`` must be
bit-equal to the reference's; the port's server, whose flushes run the
variants' arena programs through the kernels' plain versions
(``device="cpu"``), must admit, reject and run the same variants as the
reference's and serve outputs within ``compare_outputs`` of it (f32 1e-4,
int8 <= 1 LSB). Two traps of the arena path have a test each: a variant
calibrated on its own batched inputs, and float requests on a batch-1
variant.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serve_cases import alone as _alone
from _torch_serve_cases import band_graph
from test_batching import band_graph as r_band_graph
from test_torch_core import _graph_fields

from repro.core import zoo as rzoo
from repro.core.pipeline import peak_vs_batch as r_peak_vs_batch
from repro.serve import FastExec as RFastExec
from repro.serve import PlanServer as RPlanServer
from repro.serve import throughput_demo as r_throughput_demo

from repro_torch.core import exec as X
from repro_torch.core import zoo as tzoo
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as compile_graph
from repro_torch.core.pipeline import peak_vs_batch
from repro_torch.core.exec.ops import quantise
from repro_torch.serve import FastExec, PlanServer, throughput_demo
from repro_torch.serve.plan_server import variant_params


#: label -> (reference builder, port builder)
GRAPHS = {
    "band_graph_f32": (lambda: r_band_graph(), lambda: band_graph()),
    "band_graph_8bit": (lambda: r_band_graph(db=1), lambda: band_graph(db=1)),
    "mobilenet_v1_0.25_32_8bit": (lambda: rzoo.mobilenet_v1(0.25, 32, 1),
                                  lambda: tzoo.mobilenet_v1(0.25, 32, 1)),
}


def _images(graph, n, quant=None, seed0=0):
    """n per-image input dicts from seeds (int8 tensors quantised when a
    spec is given), built by the port's helpers (the same numpy values as
    the reference's)."""
    return [(X.quant_inputs(graph, quant, seed=seed0 + i)
             if quant is not None
             else X.random_inputs(graph, seed=seed0 + i)) for i in range(n)]


def _stack(imgs):
    return {k: np.stack([im[k] for im in imgs]) for k in imgs[0]}


def _served(srv, imgs):
    """Submit ``imgs``, drain; the outputs by request id."""
    for im in imgs:
        srv.submit(im)
    srv.drain()
    by_rid = {r.rid: r.output for r in srv.done}
    return [by_rid[i] for i in range(len(imgs))]


# ---------------------------------------------------------------------------
# the same graph in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_graphs_equal_in_both_packages(label):
    ref, port = GRAPHS[label]
    assert _graph_fields(port()) == _graph_fields(ref())


# ---------------------------------------------------------------------------
# FastExec: bit-equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("db", [4, 1])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_fastexec_bit_equal_to_reference(db, batch):
    rg, tg = r_band_graph(db=db), band_graph(db=db)
    rfx, tfx = RFastExec(rg, seed=0), FastExec(tg, seed=0)
    imgs = _stack(_images(tg, batch, tfx.quant))
    want, got = rfx.run(imgs), tfx.run(imgs)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fastexec_flagship_bit_equal_to_reference():
    rfx = RFastExec(rzoo.mobilenet_v1(0.25, 32, 1), seed=0)
    tfx = FastExec(tzoo.mobilenet_v1(0.25, 32, 1), seed=0)
    imgs = _stack(_images(tfx.graph, 2, tfx.quant))
    want, got = rfx.run(imgs), tfx.run(imgs)
    np.testing.assert_array_equal(got["prob_out"], want["prob_out"])
    # and per image within compare_outputs of the port's numpy backend;
    # not from the plan cache, whose plan for an equal graph compiled
    # earlier in the process holds other op objects than tfx.weights' keys
    for i in range(2):
        ref = X.get_backend("numpy").execute(
            compile_graph(tfx.graph, verify="off", cache=False),
            {k: v[i] for k, v in imgs.items()}, tfx.weights,
            quant=tfx.quant)
        X.compare_outputs(ref, {k: v[i] for k, v in got.items()},
                          exact=False, label=f"image {i}")


def test_fastexec_quantises_float_inputs():
    g = band_graph(db=1)
    fx = FastExec(g, seed=0)
    floats = X.random_inputs(g, seed=0)
    out_f = fx.run(floats)
    out_q = fx.run({k: quantise(v, fx.quant.tensors[k])
                    for k, v in floats.items()})
    want = RFastExec(r_band_graph(db=1), seed=0).run(floats)
    for k in out_f:
        assert np.array_equal(out_f[k], out_q[k])
        np.testing.assert_array_equal(out_f[k], want[k])


# ---------------------------------------------------------------------------
# PlanServer against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(GRAPHS))
def test_server_matches_reference(label):
    """Variants, rejections, peaks and batches_run equal to the reference
    server's; every output within compare_outputs of the reference
    server's and of the port's FastExec on the request alone."""
    rmk, tmk = GRAPHS[label]
    kw = dict(batches=(1, 2, 4, 8), max_delay_s=10.0)
    rs, ts = RPlanServer(rmk(), **kw), PlanServer(tmk(), device="cpu", **kw)
    imgs = _images(ts.graph, 13, ts._exec.quant)
    want, got = _served(rs, imgs), _served(ts, imgs)
    assert sorted(ts.variants) == sorted(rs.variants)
    assert ts.rejected == rs.rejected
    rst, tst = rs.stats(), ts.stats()
    for key in ("model", "batches", "rejected_batches",
                "per_batch_peak_bytes", "batches_run", "requests_served",
                "queued"):
        assert tst[key] == rst[key], key
    assert set(tst) == set(rst)
    assert tst["batches_run"] == {1: 1, 2: 0, 4: 1, 8: 1}
    for i, im in enumerate(imgs):
        X.compare_outputs(want[i], got[i], exact=False, label=f"req {i}")
        X.compare_outputs(_alone(ts._exec, im), got[i], exact=False,
                          label=f"req {i} alone")


def test_server_routes_to_largest_variant():
    srv = PlanServer(band_graph(), batches=(1, 2, 4), max_delay_s=10.0,
                     device="cpu")
    for im in _images(srv.graph, 4):
        srv.submit(im)
    assert srv.step() == 4                 # full largest variant: no wait
    st = srv.stats()
    assert st["batches_run"] == {1: 0, 2: 0, 4: 1}
    assert st["requests_served"] == 4 and st["queued"] == 0
    assert st["throughput_inf_s"] is None or st["throughput_inf_s"] > 0


def test_server_deadline_and_padded_tail():
    g = band_graph(db=1)
    srv = PlanServer(g, batches=(2, 4), max_delay_s=10.0, device="cpu")
    rsrv = RPlanServer(r_band_graph(db=1), batches=(2, 4), max_delay_s=10.0)
    im = _images(g, 1)[0]
    srv.submit(im)
    rsrv.submit(im)
    assert srv.step() == 0                 # deadline not reached: hold
    assert srv.drain() == 1                # forced: pad up to the b=2 plan
    rsrv.drain()
    r = srv.done[0]
    assert r.batch == 2 and r.output is not None
    assert srv.flushes[0].batch == 2 and srv.flushes[0].requests == 1
    X.compare_outputs(rsrv.done[0].output, r.output, exact=False,
                      label="padded tail")


def test_server_budget_admission():
    mk = lambda: band_graph(db=1)          # noqa: E731
    p1 = compile_graph(mk(), batch=1).peak_bytes
    p4 = compile_graph(mk(), batch=4).peak_bytes
    assert p1 < p4
    srv = PlanServer(mk(), arena_budget=(p1 + p4) // 2, batches=(1, 4),
                     device="cpu")
    rsrv = RPlanServer(r_band_graph(db=1), arena_budget=(p1 + p4) // 2,
                       batches=(1, 4))
    assert sorted(srv.variants) == [1]
    assert 4 in srv.rejected and srv.rejected[4] == p4
    st = srv.stats()
    assert st["per_batch_peak_bytes"] == {1: p1}
    assert st["rejected_batches"] == {4: p4}
    assert st["rejected_batches"] == rsrv.stats()["rejected_batches"]


def test_server_no_variant_fits():
    with pytest.raises(ValueError, match="admits no batch variant"):
        PlanServer(band_graph(), arena_budget=1, batches=(1, 2),
                   device="cpu")


def test_server_spans_and_cache_stats():
    srv = PlanServer(band_graph(), batches=(1, 2), max_delay_s=0.0,
                     device="cpu")
    for im in _images(srv.graph, 3):
        srv.submit(im)
        srv.step(force=True)
    spans = srv.spans()
    assert len(spans) == 3
    for s in spans:
        assert set(s) == {"rid", "batch", "t_submit", "queue_wait_s",
                          "assemble_s", "execute_s"}
        assert s["queue_wait_s"] >= 0 and s["execute_s"] > 0
    st = srv.stats()
    assert st["plan_cache"]["hits"] + st["plan_cache"]["misses"] >= 2
    assert st["plan_cache"]["hit_rate"] is not None
    # a second server over the same graph is served from the plan cache
    srv2 = PlanServer(band_graph(), batches=(1, 2), max_delay_s=0.0,
                      device="cpu")
    assert srv2.stats()["plan_cache"]["hit_rate"] == 1.0


def test_throughput_demo_smoke():
    st = throughput_demo(band_graph(db=1), n_requests=32,
                         batches=(1, 2, 4, 8), device="cpu")
    rst = r_throughput_demo(r_band_graph(db=1), n_requests=32,
                            batches=(1, 2, 4, 8))
    assert set(st) == set(rst)
    assert st["requests_served"] == rst["requests_served"] == 32
    assert st["queued"] == 0
    assert st["per_batch_peak_bytes"] == rst["per_batch_peak_bytes"]
    assert st["throughput_inf_s"] and st["throughput_inf_s"] > 0
    assert sum(b * n for b, n in st["batches_run"].items()) >= 32


def test_flush_arena_is_the_variant_peak():
    """Each flush's arena is exactly its variant's peak_bytes, and runs
    one spec per lowered spec of the variant."""
    srv = PlanServer(tzoo.mobilenet_v1(0.25, 32, 1), max_delay_s=10.0,
                     device="cpu")
    _served(srv, _images(srv.graph, 15))
    assert [f.batch for f in srv.flushes] == [8, 4, 2, 1]
    runner = CudaExecutor(device="cpu")
    for f in srv.flushes:
        cp = srv.variants[f.batch]
        w, q = srv.params[f.batch]
        assert f.arena_bytes == cp.peak_bytes
        assert f.specs == len(runner.lower(cp.plan, q))


def test_peak_vs_batch_matches_record_and_reference():
    rows = peak_vs_batch(tzoo.mobilenet_v1(0.25, 32, 1))
    assert {r["batch"]: r["peak_bytes"] for r in rows} == \
        {1: 4103, 2: 6317, 4: 12461, 8: 24749}
    assert rows == r_peak_vs_batch(rzoo.mobilenet_v1(0.25, 32, 1))


def test_server_without_card_raises(monkeypatch):
    """The default device is the card: without one the server raises and
    nothing falls back to FastExec or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanServer(band_graph(), batches=(1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        throughput_demo(band_graph(), n_requests=2, batches=(1,))


# ---------------------------------------------------------------------------
# the two traps of the arena path
# ---------------------------------------------------------------------------


def test_variant_runs_at_the_server_calibration():
    """A batch-2 variant of the flagship calibrated on its own batched
    inputs serves outputs more than 1 LSB from FastExec; at the server's
    calibration mapped onto it, within 1 LSB."""
    g = tzoo.mobilenet_v1(0.25, 32, 1)
    srv = PlanServer(g, batches=(2,), device="cpu")
    fx, cp = srv._exec, srv.variants[2]
    imgs = X.random_inputs(g, 3), X.random_inputs(g, 4)
    stacked = {"input": quantise(np.stack([imgs[0]["input"],
                                           imgs[1]["input"]]),
                                 fx.quant.tensors["input"])}
    want = fx.run(stacked)["prob_out"].astype(np.int32)
    runner = CudaExecutor(device="cpu")
    naive = runner.execute(cp, stacked)["prob_out"].astype(np.int32)
    assert np.abs(naive - want).max() > 1
    w, q = variant_params(g, fx.weights, fx.quant, cp.graph)
    mapped = runner.execute(cp, stacked, w, quant=q)["prob_out"]
    assert np.abs(mapped.astype(np.int32) - want).max() <= 1
    # bands and fused scratch take their source tensor's params
    assert q.tensors["pw1_out_p0"] == fx.quant.tensors["pw1_out"]
    assert srv.params[2][1].tensors == q.tensors


def test_float_requests_on_a_batch1_variant():
    """Float requests are quantised before they reach the int8 arena, and a
    batch-1 variant hands each request its whole output."""
    g = tzoo.mobilenet_v1(0.25, 32, 1)
    srv = PlanServer(g, batches=(1,), max_delay_s=10.0, device="cpu")
    imgs = _images(g, 3, seed0=7)          # float32 requests
    got = _served(srv, imgs)
    assert srv.stats()["batches_run"] == {1: 3}
    for i, im in enumerate(imgs):
        assert got[i]["prob_out"].shape == (1000,)
        want = _alone(srv._exec, im)
        X.compare_outputs(want, got[i], exact=False, label=f"req {i}")
