"""The port's training path (``repro_torch.data``, ``optim``, ``train``,
``checkpoint``, ``launch.train``) against the JAX package's, on the CPU.

Mirrors of the reference's system tests (loss falls, checkpoint round
trip, packing), its chunked cross-entropy test, and the reference held
against directly on its weights carried across
(``transformer.params_from_reference``): the data stream bit for bit; one
``train_step`` (loss, grad norm, lr and every param, m and v leaf after
it); ``loss_fn`` and every gradient leaf for the ten reduced archs;
checkpoints read across the packages both ways. Then the port alone:
remat equal to no remat, microbatches against one batch, the update in
place, and the launchers.

Inputs are made with numpy from seeds and cross the packages as arrays.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.checkpoint import store as rstore
from repro.data import pipeline as RD
from repro.models import transformer as RT
from repro.optim.adamw import OptConfig as ROpt
from repro.train import steps as RS

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       embedding_batches, shard_batch)
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import steps as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list(rconfigs.registry())
#: loss and gradients of the reduced archs against jax.value_and_grad of
#: the reference's, (atol, rtol) with atol scaled by each leaf's largest
#: gradient: float32 on both sides, sums in other orders through 2 layers
GRAD_TOL = (2e-4, 2e-3)
#: one train step against the reference's (float32)
STEP_TOL = 1e-5


def tiny_cfgs(**kw):
    """tests/test_system.py's tiny_cfg, for both packages."""
    out = []
    for m in (rconfigs, tconfigs):
        r = m.get_arch("qwen2.5-3b").reduced()
        out.append(dataclasses.replace(r, vocab_size=128, d_ff=128,
                                       num_heads=2, num_kv_heads=1,
                                       d_model=64, head_dim=32, **kw))
    return out


def carry(tree):
    return TT.params_from_reference(jax.device_get(tree), device="cpu")


def carry_state(rstate):
    """A reference train state as the port's (params and moments carried,
    the step an int32 scalar)."""
    st = carry(rstate)
    st["opt"]["step"] = torch.tensor(int(rstate["opt"]["step"]),
                                     dtype=torch.int32)
    return st


def host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def paths(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# mirrors of the reference's tests
# ---------------------------------------------------------------------------


def test_training_loss_decreases():
    _, cfg = tiny_cfgs()
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, seq_len=32,
                                      global_batch=8, mean_doc_len=64))
    it = data.packed_batches()
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    state = TS.init_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    step = TS.make_train_step(cfg, opt, remat=False)
    losses = []
    for _ in range(30):
        state, m = step(state, shard_batch(next(it), "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_checkpoint_roundtrip(tmp_path):
    _, cfg = tiny_cfgs()
    state = TS.init_state(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    path = store.save(str(tmp_path / "ckpt"), state, step=7)
    like = TS.init_state(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    restored = store.restore(path, like)
    for (pa, a), (pb, b) in zip(paths(state), paths(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert store.latest(str(tmp_path / "ckpt")).endswith("step_00000007.npz")
    assert store.latest(str(tmp_path / "none")) is None


def test_pipeline_packing_shapes_and_determinism():
    dc = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
    a = list(zip(range(3), SyntheticCorpus(dc).packed_batches()))
    b = list(zip(range(3), SyntheticCorpus(dc).packed_batches()))
    for (_, x), (_, y) in zip(a, b):
        assert x["inputs"].shape == (4, 16) and x["targets"].shape == (4, 16)
        np.testing.assert_array_equal(x["inputs"], y["inputs"])
        # next-token alignment
        np.testing.assert_array_equal(x["inputs"][:, 1:], x["targets"][:, :-1])


@pytest.mark.parametrize("seed,mean_doc", [(0, 512), (3, 64), (11, 8)])
def test_batches_equal_the_reference_bit_for_bit(seed, mean_doc):
    kw = dict(vocab_size=500, seq_len=48, global_batch=3, seed=seed,
              mean_doc_len=mean_doc)
    ours = SyntheticCorpus(DataConfig(**kw)).packed_batches()
    theirs = RD.SyntheticCorpus(RD.DataConfig(**kw)).packed_batches()
    for _ in range(4):
        x, y = next(ours), next(theirs)
        for k in ("inputs", "targets"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    ours = embedding_batches(DataConfig(**kw), 16, seed=seed)
    theirs = RD.embedding_batches(RD.DataConfig(**kw), 16, seed=seed)
    for _ in range(2):
        x, y = next(ours), next(theirs)
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(x[k], y[k])
    b = shard_batch(x, "cpu")
    assert b["inputs"].dtype == torch.float32
    assert b["targets"].dtype == torch.int32


def test_chunked_ce_equals_plain():
    """Sequence-chunked cross-entropy is exact, and equals the
    reference's on the same weights."""
    rcfg, tcfg = (dataclasses.replace(m.get_arch("qwen2.5-3b").reduced(),
                                      vocab_size=40000)
                  for m in (rconfigs, tconfigs))
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = carry(rp)
    b, s = 2, 1024
    rng = np.random.default_rng(1)
    batch = {"inputs": rng.integers(0, rcfg.vocab_size, (b, s)),
             "targets": rng.integers(0, rcfg.vocab_size, (b, s))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    tb = tensors(batch)
    with torch.no_grad():
        l1, _ = TS.loss_fn(tcfg, params, tb, remat=False)  # chunked
        logits, _ = TT.forward_train(tcfg, params, tb["inputs"],
                                     remat=False)
        l2 = TS.cross_entropy(logits, tb["targets"])
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    rl, _ = jax.jit(lambda p, bb: RS.loss_fn(rcfg, p, bb, remat=False))(
        rp, batch)
    np.testing.assert_allclose(float(l1), float(rl), rtol=1e-5)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_train_step_matches_the_reference():
    """One step from the same weights and batch: loss, grad norm, lr and
    every param, m and v leaf within 1e-5."""
    rcfg, tcfg = tiny_cfgs()
    ropt = ROpt(lr=3e-3, warmup_steps=5, total_steps=100)
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    rstate = RS.init_state(rcfg, jax.random.PRNGKey(2))
    state = carry_state(rstate)
    batch = next(SyntheticCorpus(DataConfig(
        rcfg.vocab_size, 32, 4, seed=2, mean_doc_len=64)).packed_batches())
    rnew, rm = jax.jit(lambda st, b: RS.train_step(rcfg, ropt, st, b,
                                                   remat=False))(
        rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = TS.train_step(tcfg, opt, state, tensors(batch), remat=False)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)
    assert int(new["opt"]["step"]) == int(rnew["opt"]["step"]) == 1
    for part in ("params", ("opt", "m"), ("opt", "v")):
        t = leaf(new, part if isinstance(part, tuple) else (part,))
        r = leaf(rnew, part if isinstance(part, tuple) else (part,))
        for p, x in paths(t):
            np.testing.assert_allclose(
                host(x), host(leaf(r, p)), rtol=STEP_TOL, atol=STEP_TOL,
                err_msg=f"{part} {'/'.join(p)}")


def _arch_cfgs(arch):
    r, t = (m.get_arch(arch).reduced() for m in (rconfigs, tconfigs))
    kw = {"capacity_factor": 16.0} if r.is_moe else {}
    return dataclasses.replace(r, **kw), dataclasses.replace(t, **kw)


@functools.lru_cache(maxsize=None)
def _arch_batch(arch):
    rcfg, _ = _arch_cfgs(arch)
    rng = np.random.default_rng(len(arch))
    b, s = 2, 16
    targets = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    if rcfg.frontend != "none":
        inputs = rng.standard_normal((b, s, rcfg.d_model)).astype(
            np.float32)
    else:
        inputs = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    return {"inputs": inputs, "targets": targets}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's ``loss_fn`` (remat on both sides), float32."""
    rcfg, tcfg = _arch_cfgs(arch)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(5))
    batch = _arch_batch(arch)
    (rl, rparts), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RS.loss_fn(rcfg, p, b, remat=True), has_aux=True))(
        rp, batch)
    (tl, tparts), tg = TS.value_and_grad(tcfg, carry(rp), tensors(batch),
                                          remat=True)
    np.testing.assert_allclose(float(tl), float(rl), rtol=GRAD_TOL[1])
    np.testing.assert_allclose(float(tparts["moe_aux"]),
                               float(rparts["moe_aux"]), rtol=GRAD_TOL[1],
                               atol=1e-6)
    rflat = dict(paths(jax.device_get(rg)))
    tflat = dict(paths(tg))
    assert sorted(tflat) == sorted(rflat)
    atol, rtol = GRAD_TOL
    for p, w in rflat.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(host(tflat[p]), w, rtol=rtol,
                                   atol=atol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{arch} {'/'.join(p)}")


def test_chunked_wkv_grads_match_the_reference():
    """RWKV at S = 128, where both packages take the chunked WKV: under
    grad the port's ``wkv_chunk_kernel`` goes through the ``WkvChunk``
    Function, whose backward on the CPU is ``wkv_backward_plain`` (on the
    card ``csrc/wkv_chunk_bwd.cu``); every gradient leaf against the
    reference's."""
    rcfg, tcfg = _arch_cfgs("rwkv6-1.6b")
    rp = RT.init_params(rcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, rcfg.vocab_size, (1, 129)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    (rl, _), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RS.loss_fn(rcfg, p, b, remat=False), has_aux=True))(
        rp, batch)
    from repro_torch.kernels import wkv_chunk as TW
    calls = []
    real = TW.wkv_chunk_kernel

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "wkv_chunk_kernel", counted)
        (tl, _), tg = TS.value_and_grad(tcfg, carry(rp), tensors(batch),
                                         remat=False)
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(float(tl), float(rl), rtol=GRAD_TOL[1])
    tflat = dict(paths(tg))
    atol, rtol = GRAD_TOL
    for p, w in paths(jax.device_get(rg)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(host(tflat[p]), w, rtol=rtol,
                                   atol=atol * max(np.abs(w).max(), 1e-30),
                                   err_msg="/".join(p))


@pytest.mark.parametrize("layers", [2, 48])
def test_remat_equals_no_remat(layers):
    """Loss and every gradient bit-equal with and without remat; at 48
    layers the groups of ``REMAT_GROUP``."""
    _, cfg = tiny_cfgs(num_layers=layers)
    params = TT.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    batch = _arch_batch("qwen2.5-3b")
    batch = {k: torch.as_tensor(v % cfg.vocab_size) for k, v in
             batch.items()}
    (l1, _), g1 = TS.value_and_grad(cfg, params, batch, remat=True)
    (l2, _), g2 = TS.value_and_grad(cfg, params, batch, remat=False)
    assert torch.equal(l1, l2)
    for (p, a), (_, b) in zip(paths(g1), paths(g2)):
        assert torch.equal(a, b), p


def test_microbatches_match_one_batch():
    """Two microbatches (float32 accumulation) against the whole batch:
    the same loss and, after the step, the same params within 1e-5."""
    _, cfg = tiny_cfgs()
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    batch = tensors(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 32, 4, seed=8, mean_doc_len=64)).packed_batches()))
    states = [TS.init_state(cfg, torch.Generator().manual_seed(8),
                            device="cpu") for _ in range(2)]
    one, m1 = TS.train_step(cfg, opt, states[0], batch, remat=False)
    two, m2 = TS.make_train_step(cfg, opt, remat=False, microbatches=2)(
        states[1], batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    for (p, a), (_, b) in zip(paths(one), paths(two)):
        np.testing.assert_allclose(host(b), host(a), rtol=1e-5, atol=1e-5,
                                   err_msg="/".join(p))
    with pytest.raises(ValueError, match="multiple"):
        TS.train_step(cfg, opt, states[1], batch, microbatches=3)


def test_default_microbatches_match_the_reference():
    for arch in ("qwen2.5-3b", "qwen3-moe-235b-a22b"):
        rcfg, tcfg = (m.get_arch(arch) for m in (rconfigs, tconfigs))
        for args in ((2, 4096, 1), (8, 4096, 1), (256, 4096, 64), (6, 512,
                                                                   1)):
            assert TS.default_microbatches(tcfg, *args) == \
                RS.default_microbatches(rcfg, *args)
        assert TS.opt_config_for(tcfg).moment_dtype == \
            RS.opt_config_for(rcfg).moment_dtype
        assert TS.accum_dtype_for(tcfg) == RS.accum_dtype_for(rcfg)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10_000, 20_000])
def test_schedule_matches_the_reference(step):
    from repro.optim import adamw as radamw
    got = adamw.schedule(OptConfig(), step)
    want = radamw.schedule(ROpt(), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_update_is_in_place_and_sliced(monkeypatch):
    """Every param, m and v leaf and the step keep their storage through
    a step; walking the leaves in slices of 1,000 elements (monkeypatched
    ``SLICE``) gives the same state as slices larger than any leaf."""
    _, cfg = tiny_cfgs()
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    batch = tensors(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 32, 2, seed=9)).packed_batches()))
    a = TS.init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    b = TS.init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    ptrs = [t.data_ptr() for _, t in paths(a)]
    assert max(t.numel() for _, t in paths(a)) > 1000
    monkeypatch.setattr(adamw, "SLICE", 1000)
    for _ in range(2):
        a, _ = TS.train_step(cfg, opt, a, batch, remat=False)
    assert [t.data_ptr() for _, t in paths(a)] == ptrs
    monkeypatch.setattr(adamw, "SLICE", 1 << 24)
    for _ in range(2):
        b, _ = TS.train_step(cfg, opt, b, batch, remat=False)
    for (p, x), (_, y) in zip(paths(a), paths(b)):
        assert torch.equal(x, y), p


def test_update_reads_bf16_moments_back():
    """bfloat16 moments (the >100B configs' choice): the update rounds m
    and v to bf16 and reads them back, as the reference does."""
    from repro.optim import adamw as radamw
    rng = np.random.default_rng(10)
    p, g = (rng.standard_normal((3, 700)).astype(np.float32)
            for _ in range(2))
    cfg = OptConfig(moment_dtype="bfloat16", warmup_steps=1)
    rcfg = ROpt(moment_dtype="bfloat16", warmup_steps=1)
    params = {"w": torch.from_numpy(p.copy())}
    opt = adamw.init(params, "bfloat16")
    rparams = {"w": jnp.asarray(p)}
    ropt = radamw.init(rparams, "bfloat16")
    for _ in range(3):
        adamw.update(cfg, {"w": torch.from_numpy(g)}, opt, params)
        rparams, ropt, _ = radamw.update(rcfg, {"w": jnp.asarray(g)}, ropt,
                                         rparams)
    assert opt["m"]["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(host(params["w"]), host(rparams["w"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(host(opt["v"]["w"]), host(ropt["v"]["w"]),
                               rtol=1e-2, atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_the_packages(tmp_path, dtype):
    """The reference's checkpoint restores into the port's state and the
    port's into the reference's; the two files of one state hold the same
    keys and bytes (a bf16 leaf as its raw 2-byte payload, ``|V2``)."""
    rcfg, tcfg = tiny_cfgs(dtype=dtype)
    rstate = RS.init_state(rcfg, jax.random.PRNGKey(3))
    ref_path = rstore.save(str(tmp_path / "ref"), rstate, step=1)
    like = TS.init_state(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    got = store.restore(ref_path, like)
    rflat = dict(paths(jax.device_get(rstate)))
    for p, t in paths(got):
        w = np.asarray(rflat[p])
        assert t.dtype == leaf(like, p).dtype
        if dtype == "bfloat16" and t.dtype == torch.bfloat16:
            assert w.dtype.name == "bfloat16"
        np.testing.assert_array_equal(host(t), w.astype(np.float32))
    port_path = store.save(str(tmp_path / "port"), got, step=1)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
        if dtype == "bfloat16":
            assert b["params/embed"].dtype == np.dtype("V2")
    rlike = jax.eval_shape(lambda: RS.init_state(rcfg,
                                                 jax.random.PRNGKey(0)))
    back = rstore.restore(port_path, rlike)
    for p, a in paths(back):
        assert np.asarray(a).tobytes() == np.asarray(rflat[p]).tobytes(), p


def test_restore_checks_the_template(tmp_path):
    _, cfg = tiny_cfgs()
    state = TS.init_state(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    path = store.save(str(tmp_path / "c.npz"), state)
    with pytest.raises(ValueError, match="keys mismatch"):
        store.restore(path, {"params": state["params"]})
    bad = TT.tree_map(lambda t: t, state)
    bad["opt"]["step"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        store.restore(path, bad)
    meta = TT.tree_map(lambda t: t.to("meta"), state)
    meta["params"] = state["params"]
    got = store.restore(path, meta)
    assert got["opt"]["m"]["embed"].device.type == "meta"
    assert torch.equal(got["params"]["embed"], state["params"]["embed"])


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_then_serve_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch.serve.engine import Engine, ServeConfig
    ck = tmp_path / "ck"
    log = LT.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                   "--steps", "4", "--batch", "2", "--seq", "32",
                   "--log-every", "1", "--ckpt-dir", str(ck),
                   "--ckpt-every", "2"])
    assert [r["step"] for r in log] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert sorted(os.listdir(ck)) == ["step_00000002.npz",
                                      "step_00000004.npz"]
    path = store.latest(str(ck))
    out = LS.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                   "--ckpt", path])
    # the same tokens as an Engine on the checkpoint's params
    cfg = tconfigs.get_arch("qwen2.5-3b").reduced()
    like = TS.init_state(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    params = store.restore(path, like)["params"]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    eng = Engine(cfg, params, ServeConfig(cache_len=12, max_new_tokens=4),
                 "cpu")
    np.testing.assert_array_equal(out, eng.generate(prompts))
    assert "checkpoint ->" in capsys.readouterr().out


def test_training_modules_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.optim.adamw, repro_torch.train.steps\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.store\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
