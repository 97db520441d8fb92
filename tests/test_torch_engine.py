"""The port's decode engines (``repro_torch.serve.engine``,
``repro_torch.serve.continuous``) and launcher
(``repro_torch.launch.serve``), on the CPU.

The reference's engine tests (tests/test_continuous_serving.py, and
tests/test_system.py's ``test_engine_generates_deterministically`` and
``test_engine_decode_consistent_with_forward``) mirrored on the port
alone; then greedy tokens of ``Engine`` and ``ContinuousEngine`` equal to
the reference's on its weights carried across, for tiny qwen, reduced
rwkv6, reduced minicpm3 and reduced olmoe (capacity 16).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as RT
from repro.serve.continuous import ContinuousConfig as RCC
from repro.serve.continuous import ContinuousEngine as RCE
from repro.serve.continuous import Request as RReq
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RSC

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as TT
from repro_torch.serve import (ContinuousConfig, ContinuousEngine, Engine,
                               Request, ServeConfig)


def tiny(module, **kw):
    """tests/test_continuous_serving.py's tiny qwen."""
    r = module.get_arch("qwen2.5-3b").reduced()
    return dataclasses.replace(r, vocab_size=96, d_model=64, num_heads=2,
                               num_kv_heads=1, head_dim=32, d_ff=96, **kw)


def port_params(cfg, seed):
    return TT.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def greedy_reference(cfg, params, prompt, n):
    """Argmax chain via full forwards."""
    seq = list(prompt)
    out = []
    for _ in range(n):
        logits, _ = TT.forward_train(cfg, params, torch.as_tensor([seq]))
        nxt = int(torch.argmax(logits[0, -1]))
        out.append(nxt)
        seq.append(nxt)
    return out


# ---------------------------------------------------------------------------
# the reference's engine tests, on the port alone
# ---------------------------------------------------------------------------


def test_ragged_batch_matches_per_request_reference():
    """Different prompt lengths decoded in one batch equal per-request
    greedy decoding (the vector-position ring caches)."""
    cfg = tiny(tconfigs)
    params = port_params(cfg, 0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 8)]
    eng = ContinuousEngine(cfg, params,
                           ContinuousConfig(slots=3, cache_len=64), "cpu")
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=50)
    for r, p in zip(reqs, prompts):
        assert r.done
        want = greedy_reference(cfg, params, p, 6)
        assert r.out == want, (r.rid, r.out, want)


def test_slot_recycling_serves_more_requests_than_slots():
    cfg = tiny(tconfigs)
    params = port_params(cfg, 1)
    rng = np.random.default_rng(1)
    eng = ContinuousEngine(cfg, params,
                           ContinuousConfig(slots=2, cache_len=48), "cpu")
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, 4 + i % 3)
                    .astype(np.int32), max_new_tokens=3 + i % 2)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=80)
    assert all(r.done for r in reqs)
    for r in reqs:
        assert len(r.out) == r.max_new_tokens


def test_recycled_slot_is_isolated_from_previous_request():
    """A request admitted into a recycled slot produces exactly the
    per-request reference output (no leakage from the dead cache), and
    the pool cache keeps its storage throughout."""
    cfg = tiny(tconfigs)
    params = port_params(cfg, 2)
    rng = np.random.default_rng(2)
    first = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
    second = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
    eng = ContinuousEngine(cfg, params,
                           ContinuousConfig(slots=1, cache_len=48), "cpu")
    ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
    r1, r2 = (Request(0, first, max_new_tokens=4),
              Request(1, second, max_new_tokens=4))
    eng.submit(r1)
    eng.submit(r2)
    eng.run(max_steps=40)
    assert r1.done and r2.done
    assert r2.out == greedy_reference(cfg, params, second, 4)
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs


def test_engine_generates_deterministically():
    cfg = dataclasses.replace(tiny(tconfigs), vocab_size=128, d_ff=128)
    params = port_params(cfg, 2)
    eng = Engine(cfg, params, ServeConfig(cache_len=64, max_new_tokens=8),
                 "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16))
    a = eng.generate(prompts.astype(np.int32))
    b = eng.generate(prompts.astype(np.int32))
    assert a.shape == (3, 8) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)  # greedy = deterministic


def test_engine_decode_consistent_with_forward():
    """Greedy generation follows the argmax chain of full forwards."""
    cfg = dataclasses.replace(tiny(tconfigs), vocab_size=128, d_ff=128)
    params = port_params(cfg, 3)
    eng = Engine(cfg, params, ServeConfig(cache_len=64, max_new_tokens=4),
                 "cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12))
    out = eng.generate(prompt.astype(np.int32))
    assert out[0].tolist() == greedy_reference(cfg, params, prompt[0], 4)


def test_sampling_is_seeded():
    """temperature > 0 samples from a generator seeded by ``seed``."""
    cfg = tiny(tconfigs)
    params = port_params(cfg, 4)
    eng = Engine(cfg, params, ServeConfig(cache_len=32, temperature=1.0,
                                          max_new_tokens=6), "cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 8)) \
        .astype(np.int32)
    a, b = eng.generate(prompts, seed=1), eng.generate(prompts, seed=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, eng.generate(prompts, seed=2))
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


# ---------------------------------------------------------------------------
# greedy tokens against the reference's, on its weights
# ---------------------------------------------------------------------------


def reduced(module, arch):
    if arch == "tiny qwen":
        return tiny(module)
    r = module.get_arch(arch).reduced()
    return dataclasses.replace(r, capacity_factor=16.0) if r.is_moe else r


CROSS = ["tiny qwen", "rwkv6-1.6b", "minicpm3-4b", "olmoe-1b-7b"]


def weights(arch, seed):
    rcfg, tcfg = reduced(rconfigs, arch), reduced(tconfigs, arch)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, TT.params_from_reference(jax.device_get(rp),
                                                    device="cpu")


@pytest.mark.parametrize("arch", CROSS)
def test_engine_tokens_equal_the_reference(arch):
    rcfg, tcfg, rp, tp = weights(arch, 21)
    prompts = np.random.default_rng(21).integers(
        0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    want = REngine(rcfg, rp, RSC(cache_len=24, max_new_tokens=6)) \
        .generate(prompts)
    got = Engine(tcfg, tp, ServeConfig(cache_len=24, max_new_tokens=6),
                 "cpu").generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", CROSS)
def test_continuous_tokens_equal_the_reference(arch):
    """Two slots, three requests of ragged lengths: one slot recycled."""
    rcfg, tcfg, rp, tp = weights(arch, 22)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(1, rcfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    outs = []
    for eng, req in ((RCE(rcfg, rp, RCC(slots=2, cache_len=32)), RReq),
                     (ContinuousEngine(tcfg, tp, ContinuousConfig(
                         slots=2, cache_len=32), "cpu"), Request)):
        reqs = [req(i, p, max_new_tokens=4 + i) for i, p in
                enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=40)
        assert all(r.done for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[1] == outs[0]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_serve_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "yi-6b", "--reduced", "--device",
                             "cpu", "--batch", "2", "--prompt-len", "16",
                             "--max-new", "5"])
    assert out.shape == (2, 5)
    text = capsys.readouterr().out
    assert "arch=yi-6b-smoke device=cpu batch=2" in text
    assert "seq1:" in text


def test_launch_serve_refuses_ckpt_and_needs_a_card(monkeypatch, tmp_path):
    """``--ckpt`` refuses a checkpoint of another arch (its keys differ
    from the state's); without ``--device`` it runs on the card and
    raises without one."""
    from repro_torch.checkpoint import store
    from repro_torch.train import steps as TS
    other = TS.init_state(reduced(tconfigs, "tiny qwen"),
                          torch.Generator().manual_seed(0), device="cpu")
    path = store.save(str(tmp_path / "qwen.npz"), other)
    with pytest.raises(ValueError, match="checkpoint keys mismatch"):
        launch_serve.main(["--arch", "yi-6b", "--reduced", "--device",
                           "cpu", "--ckpt", path])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "yi-6b", "--reduced"])
    cfg = reduced(tconfigs, "tiny qwen")
    for make in (lambda: Engine(cfg, {}, ServeConfig()),
                 lambda: ContinuousEngine(cfg, {}, ContinuousConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
