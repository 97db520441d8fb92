"""The harness: finding the parts by name, the guard against JAX, its
refusals, and ``correct`` coming out false on a run whose timed path is
broken underneath (CPU, tiny widths; the look for a card skipped by
calling the driver directly)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench import describe, harness
from bench.drivers import serve_closed_loop as SV

from . import _tiny

ROOT = str(harness.ROOT)


def test_parts_added_as_files_are_found(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    c = harness.config("qwen2.5-3b")
    c["name"] = "tiny-qwen"
    (bench / "configs" / "tiny-qwen.json").write_text(json.dumps(c))
    wl = harness.workload("qwen2.5-3b.serve-long")
    wl.update(name="tiny-qwen.serve-short", config="tiny-qwen",
              traffic="serve-short")
    (bench / "workloads" / "tiny-qwen.serve-short.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "slots_busy.serve.py").write_text(
        'LAYER = "engine (serve/continuous.py::ContinuousEngine)"\n'
        'UNIT = "%"\nBETTER = "higher"\nSOURCE = "host_clock"\n'
        'MOVES = "req_s"\nWORKLOADS = ["tiny-qwen.serve-short"]\n\n\n'
        'def read(run):\n    return None\n')
    found = harness.discover(bench)
    assert "tiny-qwen" in found["configs"]
    assert "tiny-qwen.serve-short" in found["workloads"]
    e2e, per = harness.cell_metrics("tiny-qwen.serve-short", found)
    assert per == ["slots_busy.serve"]
    assert "setup_s" in e2e and "ttft_p90_ms" not in e2e
    out = describe.describe(bench)
    assert "tiny-qwen" in [c["name"] for c in out["configs"]]
    assert "tiny-qwen.serve-short" in [w["name"] for w in out["workloads"]]
    m = [p for p in out["per_layer"] if p["name"] == "slots_busy.serve"]
    assert m and m[0]["moves"] == "req_s"


def test_benchmark_json_is_what_the_harness_finds():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == describe.describe()


def test_guard_compares_whole_top_level_names():
    mods = dict.fromkeys(["jax", "jaxlib.xla_client", "repro.core.graph",
                          "flax", "repro_torch", "repro_torch.models",
                          "reproduce", "jaxtyping", "bench.harness"])
    assert harness.forbidden_modules(mods) == [
        "flax", "jax", "jaxlib.xla_client", "repro.core.graph"]


def test_the_drivers_load_no_jax():
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]\n"
            "from bench import harness\n"
            "from bench.tests import _tiny\n"
            "_tiny.run(_tiny.serve_cell(), _tiny.qwen2())\n"
            "_tiny.run(_tiny.train_cell(), _tiny.rwkv6())\n"
            "print(harness.forbidden_modules())\n").format(
                ROOT, os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_no_jax_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_jax_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
         "qwen2.5-3b.serve-long", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300,
        env={**_no_jax_env(), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen2.5-3b.serve-long", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=_no_jax_env())
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_sound_tiny_runs_are_correct():
    assert _tiny.run(_tiny.serve_cell(), _tiny.qwen2()).correct
    r = _tiny.run(_tiny.train_cell(), _tiny.rwkv6())
    assert r.correct, r.checks


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from repro_torch.serve import continuous as C
    real = C.ContinuousEngine.step

    def altered(self):
        n = real(self)
        for s, q in enumerate(self.slot_req):
            if q is not None and len(q.out) == 2:
                tok = (int(self.last_tok[s]) + 7) % self.cfg.vocab_size
                self.last_tok[s] = tok
                q.out[-1] = tok
        return n
    monkeypatch.setattr(C.ContinuousEngine, "step", altered)
    r = _tiny.run(_tiny.serve_cell(), _tiny.qwen2())
    assert not r.correct and r.checks["mean_logit_gap"][0] > 1e-3


def _faulty_decode(monkeypatch, fault):
    """The engine's decode with ``fault(real, params, cache, tokens, pos)``
    in its place, beneath the driver's own wrapper. The tiny model's
    attention weights are drawn eight times wider, so that what attention
    reads moves its greedy tokens, as it does at the cell's 36 layers (at
    0.02 two layers' tokens follow the embedding alone)."""
    from bench.reference import qwen2
    from repro_torch.serve import continuous as C
    real_make, real_weights = C.make_decode, qwen2.make_weights

    def weights(*a, **kw):
        w = real_weights(*a, **kw)
        for leaf in w["blocks"]["attn"].values():
            for t in leaf.values():
                t.mul_(8.0)
        return w
    monkeypatch.setattr(qwen2, "make_weights", weights)

    def make(*a, **kw):
        real = real_make(*a, **kw)
        return lambda params, cache, tokens, pos: fault(real, params, cache,
                                                        tokens, pos)
    monkeypatch.setattr(C, "make_decode", make)


def _wide_sample():
    """The tiny cell with a sample of some dozen requests, so that it holds
    requests of every slot."""
    wl = _tiny.serve_cell()
    wl["check"] = dict(wl["check"], sample_tokens=64)
    return wl


def test_sound_runs_with_wider_attention_are_correct(monkeypatch):
    _faulty_decode(monkeypatch, lambda real, *a: real(*a))
    r = _tiny.run(_wide_sample(), _tiny.qwen2(), seconds=2.0)
    assert r.correct, r.checks


def test_a_decode_that_leaves_the_ring_unchanged_fails(monkeypatch):
    """The decode step writes its keys and values into a copy of the ring
    and hands back the ring it was given."""
    def unchanged(real, params, cache, tokens, pos):
        copy = {k: v.clone() for k, v in cache.items()}
        logits, _ = real(params, copy, tokens, pos)
        return logits, cache
    _faulty_decode(monkeypatch, unchanged)
    r = _tiny.run(_wide_sample(), _tiny.qwen2(), seconds=2.0)
    assert not r.correct and r.checks["mean_logit_gap"][0] > 1e-3


def test_half_of_the_slots_left_out_fails(monkeypatch):
    """The decode step computes the first half of the slots and hands
    their logits to the other half too."""
    def half(real, params, cache, tokens, pos):
        logits, cache = real(params, cache, tokens, pos)
        n = logits.shape[0] // 2
        logits = logits.clone()
        logits[n:2 * n] = logits[:n]
        return logits, cache
    _faulty_decode(monkeypatch, half)
    r = _tiny.run(_wide_sample(), _tiny.qwen2(), seconds=2.0)
    assert not r.correct and r.checks["mean_logit_gap"][0] > 1e-3


def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "update",
                        lambda cfg, grads, opt, params: (params, opt, {}))
    r = _tiny.run(_tiny.train_cell(), _tiny.rwkv6())
    assert not r.correct
    assert r.checks["change_norm_gap"][0] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from repro_torch.train import steps as TS
    real = TS.train_step

    def half(cfg, opt_cfg, state, batch, remat=True, microbatches=1,
             accum_dtype="float32"):
        n = next(iter(batch.values())).shape[0] // 2
        return real(cfg, opt_cfg, state, {k: v[:n] for k, v in
                                          batch.items()}, remat=remat)
    monkeypatch.setattr(TS, "train_step", half)
    r = _tiny.run(_tiny.train_cell(), _tiny.rwkv6())
    assert not r.correct
    assert r.checks["grad_norm_gap"][0] > 10 * r.checks["grad_norm_gap"][1]


def test_sample_holds_the_longest_and_hundreds_of_tokens():
    from bench import traffic
    import numpy as np
    reqs = [traffic.Req(i, np.zeros(n, np.int32), 20, out=[0] * 20)
            for i, n in enumerate([5, 90, 7, 30, 60, 11, 3, 2, 80, 40] * 3)]
    got = SV.sample(reqs, 2**31 + 1, 240)
    assert got[0] is reqs[1]
    assert sum(len(q.out) for q in got) >= 240
    assert len({id(q) for q in got}) == len(got)


def _imports(path):
    import ast
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_port_or_jax():
    """The references and the costs import neither the port nor JAX nor
    the JAX package; nothing the harness runs imports the repo's older
    tools (``chip_smoke.py``, ``benchmarks/``, ``scripts/``)."""
    import glob
    for kind in ("reference", "costs"):
        for path in glob.glob(os.path.join(harness.BENCH, kind, "*.py")):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                               "flax"}, path
    for path in glob.glob(os.path.join(harness.BENCH, "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"chip_smoke", "benchmarks", "scripts", "jax",
                           "repro"}, path
