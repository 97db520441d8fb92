"""The flash-attention backward on the CPU: ``flash_backward_plain`` (the
recomputation the card's ``csrc/flash_attention_bwd.cu`` runs) against
``torch.autograd`` of ``flash_plain`` and ``jax.vjp`` of the reference's
oracle ``repro.kernels.ref.attention``; the f32 kernel's dq summation
order (partials over key tiles, added ascending) emulated against both;
the ``FlashAttention`` Function's gradients; the backward's grids
through their Python mirror (``bwd_tile_walk``); and one training step on
the flash route (S = 2112) whose attention-projection gradients match the
reference's.

Inputs are made with numpy from seeds and cross the packages as arrays.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ref as RREF
from repro.models import transformer as RT
from repro.train import steps as RS

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import steps as TS

#: (atol, rtol) of the gradients, both scaled by the largest entry of the
#: gradient held against: f32 1e-4 (sums in other orders); bf16 the
#: rounding of bf16 inputs and outputs of a float32 computation
TOL = {"f32": (1e-4, 0.0), "bf16": (2e-2, 2e-2)}
_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

#: causal S = T at every length and width (96: MLA's folded nope 64 +
#: rope 32), causal T > S and non-causal
SHAPES = ([(n, n, 2, d, True) for n in (64, 130, 256)
           for d in (32, 64, 96, 128)]
          + [(64, 200, 2, 32, True), (130, 256, 3, 128, True),
             (130, 96, 2, 64, False), (256, 256, 1, 32, False)])


def _inputs(s, t, h, d, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((s, h, d), (t, h, d), (t, h, d), (s, h, d))]
    if dt == "bf16":  # values bf16 holds exactly, for both packages
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _hold(got, want, dt, label=""):
    atol, rtol = TOL[dt]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol * np.abs(w).max(),
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,t,h,d,causal", SHAPES)
def test_backward_plain_matches_autograd_and_the_reference(s, t, h, d,
                                                           causal, dt):
    q, k, v, do = _inputs(s, t, h, d, dt, s * 7 + t + d)
    ty = _TYPES[dt]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(ty) for a in (q, k, v, do))
    out, lse = TF.flash_plain_lse(tq, tk, tv, causal)
    got = TF.flash_backward_plain(tq, tk, tv, out, tdo, lse, causal)
    assert [g.dtype for g in got] == [ty] * 3
    # torch.autograd through the plain forward, in float32
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = TF.flash_plain(*leaves, causal)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(do))
    _hold([g.float() for g in got], auto, dt, "autograd")
    # jax.vjp of the reference's oracle, in float32
    _, vjp = jax.vjp(lambda a, b, c: RREF.attention(a, b, c, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    _hold([g.float() for g in got], ref, dt, "jax.vjp")


def _dq_by_key_tiles(q, k, v, o, do, lse, causal):
    """dq as the card's f32 one pass sums it: for each (head, query tile)
    of ``bwd_tile_walk(..., float32)``, each adding key tile's partial
    ``s dS K`` over its keys alone, added in the order of ``adders``
    (ascending key tiles; the first one written, not added), in float32."""
    s, h, d = q.shape
    t = k.shape[0]
    keys, rows = TF.BWD_TILES[torch.float32]
    _, adders = TF.bwd_tile_walk(s, t, h, causal, torch.float32)
    scale = d ** -0.5
    delta = (do * o).sum(-1)
    dq = torch.empty_like(q)
    for (head, qt), js in adders.items():
        r0, r1 = qt * rows, min((qt + 1) * rows, s)
        for j in js:
            k0, k1 = j * keys, min((j + 1) * keys, t)
            kk, vv = k[k0:k1, head], v[k0:k1, head]
            p = torch.exp(q[r0:r1, head] @ kk.T * scale
                          - lse[r0:r1, head, None])
            if causal:
                seen = (torch.arange(k0, k1)[None, :]
                        <= torch.arange(r0, r1)[:, None] + (t - s))
                p = torch.where(seen, p, torch.zeros(()))
            ds = p * (do[r0:r1, head] @ vv.T - delta[r0:r1, head, None])
            part = (ds @ kk) * scale
            dq[r0:r1, head] = part if j == 0 else dq[r0:r1, head] + part
    return dq


@pytest.mark.parametrize("s,t,h,d,causal", SHAPES)
def test_dq_in_the_one_pass_order_matches_plain_and_the_reference(
        s, t, h, d, causal):
    """The f32 kernel's dq summation order, emulated in torch (partials
    over key tiles, summed ascending per query tile), agrees with
    ``flash_backward_plain`` and with ``jax.vjp`` of the reference's oracle
    within the f32 tolerance."""
    q, k, v, do = _inputs(s, t, h, d, "f32", s * 5 + t + d)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = TF.flash_plain_lse(tq, tk, tv, causal)
    got = _dq_by_key_tiles(tq, tk, tv, out, tdo, lse, causal)
    plain = TF.flash_backward_plain(tq, tk, tv, out, tdo, lse, causal)
    _, vjp = jax.vjp(lambda a, b, c: RREF.attention(a, b, c, causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    atol, _ = TOL["f32"]
    for want, label in ((plain[0], "plain"), (ref[0], "jax.vjp")):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=atol * np.abs(want).max(),
                                   err_msg=label)


def test_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(130, 160, 2, 32, "f32", 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = TF.flash_plain_lse(tq, tk, tv, True)
    sc = torch.einsum("shd,thd->sht", tq.double(), tk.double()) / 32 ** 0.5
    mask = torch.arange(160)[None, :] <= torch.arange(130)[:, None] + 30
    sc = sc.masked_fill(~mask[:, None, :], -float("inf"))
    torch.testing.assert_close(lse.double(), torch.logsumexp(sc, -1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_on_the_cpu(causal):
    """``ops.flash_attention`` with inputs that require grad goes through
    ``FlashAttention``: its gradients are ``flash_backward_plain``'s on
    its own output and lse, and match autograd of the plain version."""
    q, k, v, do = _inputs(96, 128, 2, 64, "f32", 5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = TO.flash_attention(*leaves, causal=causal, device="cpu")
    assert y.grad_fn is not None and "FlashAttention" in type(
        y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, torch.from_numpy(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = TF.flash_plain_lse(tq, tk, tv, causal)
    want = TF.flash_backward_plain(tq, tk, tv, out, tdo, lse, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert TO.flash_attention(*leaves, causal=causal,
                                  device="cpu").grad_fn is None


def test_backward_refuses_causal_rows_that_see_no_key():
    q, k, v, _ = _inputs(64, 32, 2, 32, "f32", 6)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with pytest.raises(ValueError, match="T >= S"):
        TF.flash_attention_kernel(*leaves, True)
    with torch.no_grad():  # the forward alone still takes T < S
        TF.flash_attention_kernel(*leaves, True)


_WALKS = [(64, 64, True), (130, 130, True), (100, 260, True),
          (200, 77, False), (4096, 4096, True), (1, 300, True),
          (257, 257, False)]
_BF16_WALKS = _WALKS + [(129, 129, True), (257, 257, True),
                        (128, 384, True), (300, 200, False)]


@pytest.mark.parametrize("s,t,causal,dtype", [
    pytest.param(s, t, c, torch.float32, id=f"{s}-{t}-{c}")
    for s, t, c in _WALKS] + [
    pytest.param(s, t, c, torch.bfloat16, id=f"bf16-{s}-{t}-{c}")
    for s, t, c in _BF16_WALKS])
def test_bwd_tile_walk_visits_every_pair_once(s, t, causal, dtype):
    """Brute force over (query, key) pairs, with each type's tiles. bf16:
    128-row and 128-key CTAs of two warpgroups walking 64-key and 64-row
    tiles; each grid covers every pair a row sees exactly once a head, its
    walked tiles hold no pair outside the sequences, and none lies wholly
    past the causal edge; the dQ grid launches the heaviest tiles first,
    the dK/dV grid the first key tiles first. f32: the one pass of 64-key
    CTAs walking 64-row tiles (:func:`_check_f32_walk`). The tiles equal
    the constants of ``csrc/flash_attention_bwd.cu``."""
    h = 2
    src = (pathlib.Path(TF.__file__).parent / "csrc" /
           "flash_attention_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    seen = np.zeros((s, t), bool)
    if causal:
        seen = np.arange(t)[None, :] <= np.arange(s)[:, None] + (t - s)
    else:
        seen[:] = True
    if dtype == torch.float32:
        assert TF.BWD_TILES[dtype] == (const("BK"), const("BQ"))
        assert (TF.BWD_CTR0, TF.BWD_CTR_WARPS) == (const("CTR0"),
                                                   const("WARPS"))
        _check_f32_walk(s, t, h, causal, seen)
        return
    rows_q, keys_q, keys_kv, rows_kv = TF.BWD_TILES[dtype]
    dq, dkv = TF.bwd_tile_walk(s, t, h, causal, dtype)
    for grid, name in ((dq, "dq"), (dkv, "dkv")):
        count = np.zeros((h, s, t), np.int32)
        for cta in grid:
            if name == "dq":
                head, q0, q1, tiles = cta
                k0, k1 = 0, min(tiles * keys_q, t)
                walked = [(q0, q1, j * keys_q, min((j + 1) * keys_q, t))
                          for j in range(tiles)]
            else:
                head, k0, k1, first, last = cta
                q0, q1 = first * rows_kv, min(last * rows_kv, s)
                walked = [(i * rows_kv, min((i + 1) * rows_kv, s), k0, k1)
                          for i in range(first, last)]
            count[head, q0:q1, k0:k1] += 1
            for a0, a1, b0, b1 in walked:
                assert seen[a0:a1, b0:b1].any(), (name, cta, a0, b0)
        assert ((count == 1) | ~seen[None]).all(), name
        assert (count <= 1).all(), name
        assert len(grid) == h * -(-(s if name == "dq" else t)
                                  // (rows_q if name == "dq" else keys_kv))
    work = [c[3] for c in dq[::h]]
    assert work == sorted(work, reverse=True)
    assert [c[1] for c in dkv[::h]] == sorted(c[1] for c in dkv[::h])
    names = ("DQ_ROWS", "DQ_KEYS", "DKV_KEYS", "DKV_ROWS")
    assert TF.BWD_TILES[dtype] == tuple(const(n) for n in names)


def _check_f32_walk(s, t, h, causal, seen):
    """The f32 one pass (``bwd_tile_walk(..., float32)``): CTAs in ticket
    order, key tiles ascending and heads the fastest; each walks its query
    tiles from the last down, every walked tile holding a pair its keys
    see, and together they cover every seen pair exactly once a head.
    Each (head, query tile)'s adders are key tiles 0, 1, 2, ... in
    ascending order, so the counter that key tile j waits on reads j once
    key tile j - 1 has added: the CTA waited on has the earlier ticket
    and walks the tile too. Run as the counters run it (a CTA adds to a
    tile once its counter reads its key tile), with only a few CTAs
    resident at a time, taken in ticket order, every CTA finishes and
    each tile's adds come in ascending key-tile order."""
    keys, rows = TF.BWD_TILES[torch.float32]
    ctas, adders = TF.bwd_tile_walk(s, t, h, causal, torch.float32)
    nq, nk = -(-s // rows), -(-t // keys)
    assert [(c[0], c[1]) for c in ctas] == [
        (head, j * keys) for j in range(nk) for head in range(h)]
    count = np.zeros((h, s, t), np.int32)
    ticket = {}
    for n, (head, k0, k1, walk) in enumerate(ctas):
        ticket[(head, k0 // keys)] = n
        assert list(walk) == sorted(walk, reverse=True) and walk[0] == nq - 1
        for qt in walk:
            q0, q1 = qt * rows, min((qt + 1) * rows, s)
            assert seen[q0:q1, k0:k1].any(), (head, k0, qt)
            count[head, q0:q1, k0:k1] += 1
    assert ((count == 1) | ~seen[None]).all()
    assert (count <= 1).all()
    assert set(adders) == {(head, qt) for head in range(h)
                           for qt in range(nq)}
    for (head, qt), js in adders.items():
        assert js == list(range(len(js))), (head, qt, js)
        for j in js[1:]:  # waits on key tile j - 1 only: an earlier ticket
            assert ticket[(head, j - 1)] < ticket[(head, j)]
            assert qt in ctas[ticket[(head, j - 1)]][3]
    for resident in (1, 3):
        counter = {key: 0 for key in adders}
        order = {key: [] for key in adders}
        pos = [0] * len(ctas)
        live, nxt = [], 0
        while live or nxt < len(ctas):
            while len(live) < resident and nxt < len(ctas):
                live.append(nxt)
                nxt += 1
            moved = False
            for n in list(live):
                head, k0, _, walk = ctas[n]
                key = (head, walk[pos[n]])
                if counter[key] == k0 // keys:
                    order[key].append(k0 // keys)
                    counter[key] += 1
                    pos[n] += 1
                    moved = True
                    if pos[n] == len(walk):
                        live.remove(n)
            assert moved, ("the resident CTAs all wait", resident, live)
        assert order == adders


def _tiny(case="qwen2.5-3b", **kw):
    """The reference's and the port's tiny configs (tests/test_system.py's
    tiny_cfg), float32."""
    out = []
    for m in (rconfigs, tconfigs):
        r = m.get_arch(case).reduced()
        out.append(dataclasses.replace(r, vocab_size=128, d_ff=128,
                                       num_heads=2, num_kv_heads=1,
                                       d_model=64, head_dim=32, **kw))
    return out


def test_flash_route_step_gives_the_attention_projections_grads():
    """One loss at S = 2112, past ``FLASH_THRESHOLD``: the port's
    attention runs ``ops.flash_attention`` (the kernel's route; its plain
    version here) under autograd, and wq, wk, wv with their biases get
    gradients equal to the reference's (blockwise attention through XLA)
    within 1e-4, none of them zero."""
    rcfg, tcfg = _tiny(num_layers=1)
    s = 2112
    assert s > TL.FLASH_THRESHOLD
    rp = RT.init_params(rcfg, jax.random.PRNGKey(4))
    tp = TT.params_from_reference(jax.device_get(rp), device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, rcfg.vocab_size, (1, s + 1)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    (rl, _), rg = jax.value_and_grad(
        lambda p: RS.loss_fn(rcfg, p, batch, remat=False), has_aux=True)(rp)
    calls = []
    real = TO.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "flash_attention", counted)
        (tl, _), tg = TS.value_and_grad(
            tcfg, tp, {k: torch.as_tensor(v) for k, v in batch.items()},
            remat=False)
    assert len(calls) == 1
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)
    for name in ("wq", "wk", "wv"):
        for leaf in ("w", "b"):
            got = tg["blocks"]["attn"][name][leaf].numpy()
            want = np.asarray(rg["blocks"]["attn"][name][leaf])
            assert np.abs(got).max() > 0, (name, leaf)
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{name}/{leaf}")
