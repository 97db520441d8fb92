"""The port's recorder (``repro_torch.trace``) and the spans, counters and
request stamps of its serving path, on the CPU: the tiny qwen that
``tests/test_torch_engine.py`` serves, in a ``ContinuousEngine`` of three
slots over five requests; a ``PlanServer`` flush; the flash forward."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import configs, trace
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                               PlanServer, Request)

from _torch_serve_cases import band_graph

PROMPTS = (5, 11, 8, 3, 9)
MAX_NEW = (6, 2, 4, 5, 3)
SLOTS = 3


def tiny():
    """tests/test_torch_engine.py's tiny qwen."""
    r = configs.get_arch("qwen2.5-3b").reduced()
    return dataclasses.replace(r, vocab_size=96, d_model=64, num_heads=2,
                               num_kv_heads=1, head_dim=32, d_ff=96)


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def serve(model):
    """The five requests through a fresh engine: (engine, requests)."""
    cfg, params = model
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip(PROMPTS, MAX_NEW))]
    eng = ContinuousEngine(cfg, params,
                           ContinuousConfig(slots=SLOTS, cache_len=32), "cpu")
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=50)
    assert all(r.done for r in reqs)
    return eng, reqs


@pytest.fixture(scope="module")
def recorded(model):
    """(requests, export) of the five served with a recorder on."""
    with trace.recording() as rec:
        _, reqs = serve(model)
    assert_off()
    return reqs, rec.export()


def assert_off():
    """No recorder is on: every span is the one shared no-op."""
    assert trace.span("a", rid=1) is trace.span("b")


def by_id(export):
    return {s["id"]: s for s in export["spans"]}


def test_off_records_nothing_and_serves_the_same_tokens(model, recorded):
    assert_off()
    trace.count("engine.admitted")
    trace.add_span("repro/engine/queued", 0.0, 1.0, rid=0)
    _, reqs = serve(model)
    on, export = recorded
    assert [r.out for r in reqs] == [r.out for r in on]
    with trace.recording() as rec:
        pass
    assert rec.export() == {"spans": [], "counters": {}}
    assert export["spans"] and export["counters"]


def test_spans_nest_as_stated(model, recorded):
    cfg = model[0]
    reqs, export = recorded
    spans = by_id(export)

    def parent(s):
        return spans[s["parent"]]["name"] if s["parent"] else None
    for s in export["spans"]:
        assert s["end"] >= s["start"], s
    admits = [s for s in export["spans"] if s["name"] == "repro/engine/admit"]
    assert sorted(s["attrs"]["rid"] for s in admits) == list(range(5))
    for s in admits:
        assert parent(s) == "repro/engine/step"
        assert s["attrs"]["tokens"] == PROMPTS[s["attrs"]["rid"]]
    for name in ("repro/engine/slot_copy", "repro/engine/readback",
                 "repro/model/prefill"):
        kids = [s for s in export["spans"] if s["name"] == name
                and parent(s) == "repro/engine/admit"]
        assert len(kids) == 5, name
        for s in kids:
            rid = spans[s["parent"]]["attrs"]["rid"]
            assert s["attrs"].get("rid", rid) == rid
    prefills = [s for s in export["spans"]
                if s["name"] == "repro/model/prefill"]
    assert sorted(s["attrs"]["tokens"] for s in prefills) == sorted(PROMPTS)
    decodes = [s for s in export["spans"]
               if s["name"] == "repro/model/decode"]
    assert decodes and all(parent(s) == "repro/engine/step" and
                           s["attrs"]["slots"] == SLOTS for s in decodes)
    for name in ("repro/model/attn", "repro/model/ffn",
                 "repro/model/cache_fill"):
        layers = {}
        for s in export["spans"]:
            if s["name"] == name:
                assert parent(s) in ("repro/model/prefill",
                                     "repro/model/decode"), s
                layers.setdefault(s["parent"], []).append(s["attrs"]["layer"])
        want = len(prefills)
        if name != "repro/model/cache_fill":
            want += len(decodes)
        assert len(layers) == want, name
        assert all(v == list(range(cfg.num_layers)) for v in layers.values())
    heads = [parent(s) for s in export["spans"]
             if s["name"] == "repro/model/head"]
    assert sorted(heads) == sorted(["repro/model/prefill"] * 5
                                   + ["repro/model/decode"] * len(decodes))
    queued = [s for s in export["spans"] if s["name"] == "repro/engine/queued"]
    assert sorted(s["attrs"]["rid"] for s in queued) == list(range(5))
    for s in queued:
        r = reqs[s["attrs"]["rid"]]
        assert s["parent"] is None
        assert (s["start"], s["end"]) == (r.t_submit, r.t_admit)
    steps = [s for s in export["spans"] if s["name"] == "repro/engine/step"]
    assert all(parent(s) is None for s in steps)
    assert sum(s["name"] == "repro/engine/retire"
               for s in export["spans"]) == len(decodes)


def test_counters_count_exactly(recorded):
    reqs, export = recorded
    c = export["counters"]
    decodes = sum(s["name"] == "repro/model/decode" for s in export["spans"])
    assert c["engine.admitted"] == len(reqs)
    assert c["engine.prompt_tokens"] == sum(PROMPTS)
    assert c["engine.decode_steps"] == decodes
    assert c["engine.slot_steps"] == SLOTS * decodes
    # every decoded token but a request's first, which its admission reads
    assert c["engine.live_slot_steps"] == sum(len(r.out) - 1 for r in reqs)
    assert c["engine.live_slot_steps"] <= c["engine.slot_steps"]


def test_stamps_are_ordered_with_or_without_a_recorder(model, recorded):
    for reqs in (recorded[0], serve(model)[1]):
        for r in reqs:
            assert 0 < r.t_submit <= r.t_admit <= r.t_first <= r.t_done, r


def test_export_is_json_and_a_copy():
    with trace.recording() as rec:
        with trace.span("a", rid=1):
            trace.count("n", 2)
    got = rec.export()
    assert json.loads(json.dumps(got)) == got
    assert got["counters"] == {"n": 2}
    got["spans"][0]["attrs"]["rid"] = 9
    assert rec.export()["spans"][0]["attrs"] == {"rid": 1}


def test_the_recorder_is_off_after_an_exception():
    with pytest.raises(ValueError):
        with trace.recording() as rec:
            with trace.span("outer", rid=3):
                with trace.span("inner"):
                    raise ValueError("inside")
    assert_off()
    outer, inner = rec.export()["spans"]
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["end"] >= inner["end"] >= inner["start"] >= outer["start"]
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
        with trace.span("a"):
            with trace.span("b"):
                pass
    assert [s["parent"] for s in rec.export()["spans"]] == [None, 1]
    assert_off()


def test_spans_sit_in_the_profilers_trace(model):
    cfg, params = model
    toks = torch.randint(0, cfg.vocab_size, (1, 6))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.recording(), torch.inference_mode():
        T.prefill(cfg, params, toks, cache_len=16)
    names = {e.name for e in prof.events()}
    assert {"repro/model/prefill", "repro/model/attn", "repro/model/ffn",
            "repro/model/cache_fill", "repro/model/head"} <= names
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        T.prefill(cfg, params, toks, cache_len=16)
    assert not any(e.name.startswith("repro/") for e in prof.events())


def test_flash_forward_is_a_span():
    q, k, v = (torch.randn(40, 3, 16) for _ in range(3))
    with trace.recording() as rec:
        out = ops.flash_attention(q, k, v, device="cpu")
    (s,) = rec.export()["spans"]
    assert s["name"] == "repro/kernels/flash_fwd"
    assert s["attrs"] == {"s": 40, "bh": 3, "d": 16}
    assert torch.equal(out, ops.flash_attention(q, k, v, device="cpu"))


def test_plan_server_flushes_are_spans():
    srv = PlanServer(band_graph(), batches=(1, 2, 4), max_delay_s=10.0,
                     device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(5):
        srv.submit({t.name: rng.standard_normal(t.shape).astype(np.float32)
                    for t in srv.graph.tensors if t.kind == "input"})
    with trace.recording() as rec:
        assert srv.drain() == 5
    flushes = [s for s in rec.export()["spans"]
               if s["name"] == "repro/plan_server/flush"]
    assert [(s["attrs"]["batch"], s["attrs"]["requests"]) for s in flushes] \
        == [(f.batch, f.requests) for f in srv.flushes] == [(4, 4), (1, 1)]
    assert srv.stats()["requests_served"] == 5


def test_no_profiler_range_without_a_trace(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no trace on")
    monkeypatch.setattr(trace, "record_function", refuse)
    with trace.recording() as rec:
        with trace.span("a", rid=1):
            pass
    assert [s["name"] for s in rec.export()["spans"]] == ["a"]
