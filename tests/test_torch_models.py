"""The port's decoder models (``repro_torch.models.layers``, ``moe``,
``ssm``, ``transformer``) against the JAX package's, on the reference's
weights carried across (``transformer.params_from_reference``).

For every arch (reduced, float32; MoE with ample capacity) and a GQA arch
with the int8 KV cache: ``forward_train`` logits, ``prefill`` logits and
every cache tensor, and four ``decode_step``s, each within the reference's
own 2e-3 (the int8 cache within 1 LSB). Then the reference's model tests
(tests/test_models.py) mirrored on the port alone, and the flash route:
causal prefill above ``FLASH_THRESHOLD`` with no window runs
``ops.flash_attention`` once a layer (GQA and MLA, against the
reference's blockwise path within 2e-4); with a window it stays plain.

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
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list(rconfigs.registry())
#: every arch, and yi-6b with the int8 KV cache
CASES = ARCHS + ["yi-6b+kv_quant"]
TOL = 2e-3
B, S, EXTRA = 2, 8, 4


def configs(case: str, **kw):
    """(reference config, port config): the reduced arch, ample capacity
    for MoE (a 16-token prefill and a 1-token decode step then drop
    nothing), ``kv_quant`` for the ``+kv_quant`` case."""
    arch, _, flag = case.partition("+")
    r, t = (m.get_arch(arch).reduced() for m in (rconfigs, tconfigs))
    if r.is_moe:
        kw["capacity_factor"] = 16.0
    if flag:
        kw[flag] = True
    return dataclasses.replace(r, **kw), dataclasses.replace(t, **kw)


def carry(tree):
    return TT.params_from_reference(jax.device_get(tree), device="cpu")


def host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(host(got), host(want), rtol=tol, atol=tol,
                               err_msg=msg)


@functools.lru_cache(maxsize=None)
def run_case(case: str):
    """The reference's and the port's forward, prefill and decode steps on
    the reference's weights (computed once per case)."""
    rcfg, tcfg = configs(case)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(1))
    tp = carry(rp)
    rng = np.random.default_rng(len(case))
    toks = rng.integers(0, rcfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    if rcfg.frontend != "none":
        inputs = np.asarray(rp["embed"])[toks]
    else:
        inputs = toks
    ref, port = {}, {}
    ref["full"], _ = jax.jit(
        lambda p, x: RT.forward_train(rcfg, p, x, remat=False))(rp, inputs)
    port["full"], _ = TT.forward_train(tcfg, tp, torch.as_tensor(inputs))
    ref["prefill"] = jax.jit(
        lambda p, x: RT.prefill(rcfg, p, x, S + EXTRA))(rp, inputs[:, :S])
    port["prefill"] = TT.prefill(tcfg, tp, torch.as_tensor(inputs[:, :S]),
                                 S + EXTRA)
    port["prefill_cache"] = {k: v.clone()
                             for k, v in port["prefill"][1].items()}
    rdec = jax.jit(lambda p, c, t, pos: RT.decode_step(rcfg, p, c, t, pos))
    rcache, tcache = ref["prefill"][1], port["prefill"][1]
    ref["steps"], port["steps"] = [], []
    for i in range(EXTRA):
        tok = toks[:, S + i][:, None]
        logits, rcache = rdec(rp, rcache, tok, jnp.int32(S + i))
        ref["steps"].append(logits)
        logits, tcache = TT.decode_step(tcfg, tp, tcache,
                                        torch.as_tensor(tok), S + i)
        port["steps"].append(logits)
    ref["cache"], port["cache"] = rcache, tcache
    return ref, port


def hold_cache(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(w.shape), (label, name)
        if w.dtype == jnp.int8:
            assert g.dtype == torch.int8, (label, name)
            lsb = np.abs(g.numpy().astype(np.int32)
                         - np.asarray(w).astype(np.int32)).max()
            assert lsb <= 1, (label, name, lsb)
        else:
            close(g, w, msg=f"{label} {name}")


@pytest.mark.parametrize("case", CASES)
def test_forward_train_matches_reference(case):
    ref, port = run_case(case)
    assert tuple(port["full"].shape) == tuple(ref["full"].shape)
    close(port["full"], ref["full"], msg=case)


@pytest.mark.parametrize("case", CASES)
def test_prefill_matches_reference(case):
    """The last position's logits and every cache tensor (stacked over
    layers, padded to the cache length; int8 within 1 LSB)."""
    ref, port = run_case(case)
    close(port["prefill"][0], ref["prefill"][0], msg=case)
    hold_cache(port["prefill_cache"], ref["prefill"][1], f"{case} prefill")


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_reference(case):
    ref, port = run_case(case)
    for i, (g, w) in enumerate(zip(port["steps"], ref["steps"])):
        close(g, w, msg=f"{case} decode step {i}")
    hold_cache(port["cache"], ref["cache"], f"{case} after {EXTRA} steps")


# ---------------------------------------------------------------------------
# the reference's model tests, on the port alone
# ---------------------------------------------------------------------------


def port_params(cfg, seed):
    return TT.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill s tokens then decode one by one: each decode step's logits
    match the full-sequence forward at that position (KV ring buffers, RoPE
    offsets, SSM and token-shift states) within 2e-3."""
    _, cfg = configs(arch)
    params = port_params(cfg, 1)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32))
    full_inputs = params["embed"][toks.long()] if cfg.frontend != "none" \
        else toks
    full, _ = TT.forward_train(cfg, params, full_inputs)
    logits, cache = TT.prefill(cfg, params, full_inputs[:, :S], S + EXTRA)
    close(logits[:, 0], full[:, S - 1], msg=f"{arch} prefill")
    for i in range(EXTRA):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       toks[:, S + i][:, None], S + i)
        close(logits[:, 0], full[:, S + i], msg=f"{arch} decode step {i}")


def test_sliding_window_decode_bounded_cache():
    """A ring cache of the window's size equals a windowed full pass."""
    cfg = dataclasses.replace(tconfigs.get_arch("yi-6b").reduced(),
                              sliding_window=8)
    params = port_params(cfg, 2)
    total, w = 20, 8
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, total)).astype(np.int32))
    logits, cache = TT.prefill(cfg, params, toks[:, :w], w, window=w)
    assert cache["k"].shape[2] == w
    for i in range(w, total):
        logits, cache = TT.decode_step(cfg, params, cache, toks[:, i][:, None],
                                       i, window=w)
    want, _ = TT.prefill(cfg, params, toks, total, window=w)
    close(logits[:, 0], want[:, 0])


#: the ring with no window: a prompt of RING_SLOTS tokens fills the ring,
#: then RING_STEPS decode steps wrap it (long_500k's ring of
#: cache_len_for slots, at the reduced width)
RING_SLOTS, RING_STEPS = 8, 12


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b"])
def test_ring_without_window_wraps_like_the_reference(arch):
    """GQA and MLA: a prefill into as many ring slots as prompt tokens,
    window 0, then decode steps past the ring's end, so each step
    overwrites the oldest slot: every step's logits and the final cache
    within 2e-3 of the reference's ``decode_step`` on the same carried
    weights, the cache in its storage throughout."""
    rcfg, tcfg = configs(arch)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(9))
    tp = carry(rp)
    toks = np.random.default_rng(9).integers(
        0, rcfg.vocab_size, (B, RING_SLOTS + RING_STEPS)).astype(np.int32)
    rlogits, rcache = jax.jit(lambda p, x: RT.prefill(rcfg, p, x,
                                                      RING_SLOTS))(
        rp, toks[:, :RING_SLOTS])
    tlogits, tcache = TT.prefill(tcfg, tp, torch.as_tensor(
        toks[:, :RING_SLOTS]), RING_SLOTS)
    close(tlogits, rlogits, msg=f"{arch} prefill")
    ptrs = {k: v.data_ptr() for k, v in tcache.items()}
    rdec = jax.jit(lambda p, c, t, pos: RT.decode_step(rcfg, p, c, t, pos))
    for i in range(RING_STEPS):
        pos = RING_SLOTS + i
        tok = toks[:, pos:pos + 1]
        rlogits, rcache = rdec(rp, rcache, tok, jnp.int32(pos))
        tlogits, tcache = TT.decode_step(tcfg, tp, tcache,
                                         torch.as_tensor(tok), pos)
        close(tlogits, rlogits, msg=f"{arch} decode step at {pos}")
    assert {k: v.data_ptr() for k, v in tcache.items()} == ptrs
    assert all(v.shape[2] == RING_SLOTS for v in tcache.values())
    hold_cache(tcache, rcache, f"{arch} ring after {RING_STEPS} steps")


def test_int8_kv_cache_decode():
    """The int8 KV cache: decode matches the float forward within the
    reference's quantisation tolerance; the cache really is int8."""
    cfg = dataclasses.replace(tconfigs.get_arch("yi-6b").reduced(),
                              kv_quant=True)
    params = port_params(cfg, 5)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32))
    full, _ = TT.forward_train(cfg, params, toks)
    logits, cache = TT.prefill(cfg, params, toks[:, :S], S + EXTRA)
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    close(logits[:, 0], full[:, S - 1], 0.1)
    for i in range(EXTRA):
        logits, cache = TT.decode_step(cfg, params, cache,
                                       toks[:, S + i][:, None], S + i)
        close(logits[:, 0], full[:, S + i], 0.12, f"step {i}")


def test_decode_step_writes_the_cache_in_place():
    """Every stacked cache tensor keeps its storage through a decode step
    (the port's donated carry), and the step changes it."""
    for arch in ("qwen2.5-3b", "rwkv6-1.6b", "minicpm3-4b", "hymba-1.5b"):
        _, cfg = configs(arch)
        params = port_params(cfg, 3)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                             generator=torch.Generator().manual_seed(3))
        _, cache = TT.prefill(cfg, params, toks[:, :S], S + 1)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        before = {k: v.clone() for k, v in cache.items()}
        _, after = TT.decode_step(cfg, params, cache, toks[:, S:], S)
        assert after is cache
        assert {k: v.data_ptr() for k, v in after.items()} == ptrs, arch
        assert all(not torch.equal(before[k], after[k]) for k in ptrs), arch


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b",
                                  "hymba-1.5b"])
def test_decode_step_computes_its_shared_values_once(arch, monkeypatch):
    """A decode step computes the positions, ring slots and RoPE table
    once for all its layers, and the step with an int position equals the
    step with the same position as a (B,) tensor (the ragged form)."""
    _, cfg = configs(arch, num_layers=3)
    params = port_params(cfg, 4)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(4))
    _, cache = TT.prefill(cfg, params, toks[:, :S], S + 1)
    ragged = {k: v.clone() for k, v in cache.items()}
    calls = []
    real = TL.decode_step_values
    monkeypatch.setattr(TL, "decode_step_values",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    got, cache = TT.decode_step(cfg, params, cache, toks[:, S:], S)
    assert len(calls) == 1
    want, ragged = TT.decode_step(cfg, params, ragged, toks[:, S:],
                                  torch.full((B,), S))
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(cache[k], ragged[k]), k


# ---------------------------------------------------------------------------
# the flash route
# ---------------------------------------------------------------------------


#: above FLASH_THRESHOLD (2048): the reference's blockwise path
LONG = 2112


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts ``ops.flash_attention`` calls (the model's kernel route)."""
    calls = []
    real = TO.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), q.is_contiguous(), k.is_contiguous(),
                      v.is_contiguous()))
        return real(q, k, v, **kw)
    monkeypatch.setattr(TO, "flash_attention", counted)
    return calls


def long_attention_case(arch: str, window: int = 0):
    rcfg, tcfg = configs(arch)
    key = jax.random.PRNGKey(7)
    init = RL.mla_init if rcfg.attention == "mla" else RL.attn_init
    fwd = "mla_forward" if rcfg.attention == "mla" else "attn_forward"
    rp = init(rcfg, key)
    x = np.random.default_rng(7).standard_normal(
        (1, LONG, rcfg.d_model)).astype(np.float32)
    want, wcache = getattr(RL, fwd)(rp, jnp.asarray(x), rcfg, window)
    got, gcache = getattr(TL, fwd)(carry(rp), torch.as_tensor(x), tcfg,
                                   window)
    return rcfg, want, wcache, got, gcache


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b"])
def test_long_prefill_takes_the_flash_route(arch, flash_calls):
    """GQA (reduced qwen: 4 heads on 2 kv heads of 32) and MLA (reduced
    minicpm3: D = dn + dr = 48) at S = 2112: one ``flash_attention`` call
    on the folded (S, B·H, D) layout, contiguous, within 2e-4 of the
    reference's blockwise path (output and cache)."""
    cfg, want, wcache, got, gcache = long_attention_case(arch)
    d = cfg.head_dim + (cfg.rope_head_dim if cfg.attention == "mla" else 0)
    assert flash_calls == [((LONG, cfg.num_heads, d), True, True, True)]
    close(got, want, 2e-4, arch)
    for name, w in wcache.items():
        close(gcache[name], w, 2e-4, f"{arch} {name}")


def test_windowed_long_prefill_stays_plain(flash_calls):
    """A window (hybrid's sliding window) keeps the plain blockwise path:
    the kernel has no window mask."""
    _, want, _, got, _ = long_attention_case("qwen2.5-3b", window=300)
    assert flash_calls == []
    close(got, want, 2e-4)


def test_short_prefill_stays_plain(flash_calls):
    _, cfg = configs("qwen2.5-3b")
    params = port_params(cfg, 4)
    toks = torch.randint(0, cfg.vocab_size, (1, 64),
                         generator=torch.Generator().manual_seed(4))
    TT.prefill(cfg, params, toks)
    assert flash_calls == []


def test_prefill_above_the_threshold_launches_one_flash_a_layer(flash_calls):
    _, cfg = configs("qwen2.5-3b")
    params = port_params(cfg, 6)
    toks = torch.randint(0, cfg.vocab_size, (2, LONG),
                         generator=torch.Generator().manual_seed(6))
    TT.prefill(cfg, params, toks)
    assert flash_calls == [((LONG, 2 * cfg.num_heads, cfg.head_dim), True,
                            True, True)] * cfg.num_layers


def test_flash_matches_model_sdpa_blockwise():
    """The port's blockwise attention (the windowed prefill's path) is the
    flash kernel's algorithm: the two agree within 2e-4."""
    s, h, d = 96, 2, 32
    rng = np.random.default_rng(96)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, s, h, d))
                               .astype(np.float32)) for _ in range(3))
    a = TL._sdpa_blockwise(q, k, v, offset=0, window=0, block=32)[0]
    b = TO.flash_attention(q[0], k[0], v[0], block_q=32, block_k=32,
                           device="cpu")
    close(a, b, 2e-4)


@pytest.mark.parametrize("window", [0, 40])
def test_sdpa_blockwise_matches_reference(window):
    """GQA heads (4 on 2), T = 200 padded to blocks of 64."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 200, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 200, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = RL._sdpa_blockwise(*map(jnp.asarray, (q, k, v)), offset=0,
                              window=window, block=64)
    got = TL._sdpa_blockwise(*map(torch.as_tensor, (q, k, v)), offset=0,
                             window=window, block=64)
    close(got, want, 2e-4)


# ---------------------------------------------------------------------------
# weights, devices and imports
# ---------------------------------------------------------------------------


def test_params_from_reference_keeps_names_shapes_and_dtypes():
    """A bfloat16 tree (the configs' own dtype) carries exactly."""
    rcfg = dataclasses.replace(rconfigs.get_arch("hymba-1.5b").reduced(),
                               dtype="bfloat16")
    rp = jax.device_get(RT.init_params(rcfg, jax.random.PRNGKey(0)))
    tp = TT.params_from_reference(rp, device="cpu")
    rl = jax.tree_util.tree_leaves_with_path(rp)
    tl = dict(_paths(tp))
    assert len(rl) == len(tl)
    for path, leaf in rl:
        key = tuple(k.key for k in path)
        t = tl[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name, key
        np.testing.assert_array_equal(host(t), np.asarray(leaf, np.float32))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_init_params_matches_the_reference_tree():
    """The port's random init has the reference's names, shapes and
    dtypes (stacked over layers) for every arch."""
    for arch in ARCHS:
        rcfg, tcfg = configs(arch)
        shapes = jax.eval_shape(
            lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
        want = {tuple(k.key for k in p): (leaf.shape, leaf.dtype.name)
                for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in _paths(port_params(tcfg, 0))}
        assert got == want, arch
        rc = jax.eval_shape(lambda: RT.init_cache(rcfg, 3, 16))
        tc = TT.init_cache(tcfg, 3, 16, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tc.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in rc.items()}, arch


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None is the card: with none visible every entry point raises
    and none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.params_from_reference({"w": np.zeros(2, np.float32)})


def test_models_and_engines_import_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.models.transformer, repro_torch.serve.engine\n"
        "import repro_torch.serve.continuous, repro_torch.launch.serve\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
