"""The port's MoE dispatch and SSM mixers (``repro_torch.models.moe``,
``repro_torch.models.ssm``): the reference's tests (tests/test_moe_ssm.py,
its first six) mirrored on the port alone at their 2e-4, and each function
against the JAX package's on the reference's weights carried across:
``_moe_ffn_local`` (output and aux), ``rwkv_forward`` chunked at S = 256
(the WKV kernel's route, its plain version on the CPU) and sequential,
``rwkv_decode``, ``mamba_forward`` and ``mamba_decode``.

Inputs are made with numpy from seeds and cross the packages as arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as rconfigs
from repro.models import moe as RM
from repro.models import ssm as RS

from repro_torch import configs as tconfigs
from repro_torch.kernels import wkv_chunk as TW
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

TOL = 2e-4


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want, np.float32)
        if not isinstance(want, torch.Tensor)
        else want.detach().float().numpy(), rtol=tol, atol=tol, err_msg=msg)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def moe_cfg(**kw):
    return dataclasses.replace(tconfigs.get_arch("olmoe-1b-7b").reduced(),
                               **kw)


def carry(tree):
    return TT.params_from_reference(jax.device_get(tree), device="cpu")


# ---------------------------------------------------------------------------
# the reference's tests, on the port alone
# ---------------------------------------------------------------------------


def test_moe_matches_dense_oracle_when_capacity_ample():
    """With capacity high enough that nothing drops, the capacity dispatch
    equals the brute-force weighted sum over the top-k experts."""
    cfg = moe_cfg(capacity_factor=8.0)
    p = TM.moe_init(cfg, gen(0), "cpu")
    x = torch.as_tensor(normal(0, 2, 8, cfg.d_model))
    out, aux = TM._moe_ffn_local(p, x, cfg)

    t = 16
    xf = x.reshape(t, cfg.d_model)
    probs = torch.softmax(xf @ p["router"]["w"], -1)
    gw, gi = torch.topk(probs, cfg.experts_per_token)
    gw = gw / gw.sum(-1, keepdim=True)
    want = torch.zeros((t, cfg.d_model))
    for i in range(t):
        for j in range(cfg.experts_per_token):
            e = int(gi[i, j])
            h = F.silu(xf[i] @ p["w_gate"][e]) * (xf[i] @ p["w_up"][e])
            want[i] += gw[i, j] * (h @ p["w_down"][e])
    close(out.reshape(t, -1), want)
    assert float(aux) > 0


def test_moe_capacity_drops_are_bounded():
    cfg = moe_cfg(capacity_factor=1.0)
    p = TM.moe_init(cfg, gen(1), "cpu")
    x = torch.as_tensor(normal(1, 4, 16, cfg.d_model))
    out, _ = TM._moe_ffn_local(p, x, cfg)
    assert torch.isfinite(out).all()


def test_rwkv_forward_equals_stepwise_decode():
    cfg = tconfigs.get_arch("rwkv6-1.6b").reduced()
    p = TS.rwkv_init(cfg, gen(2), "cpu")
    b, s = 2, 10
    x = torch.as_tensor(normal(2, b, s, cfg.d_model))
    y_full, state_full = TS.rwkv_forward(p, x, cfg)
    state = {"wkv": torch.zeros_like(state_full["wkv"]),
             "shift": torch.zeros((b, cfg.d_model))}
    ys = []
    for i in range(s):
        y, state = TS.rwkv_decode(p, x[:, i:i + 1], state, cfg)
        ys.append(y)
    close(y_full, torch.cat(ys, dim=1))
    close(state_full["wkv"], state["wkv"])


def test_mamba_forward_equals_stepwise_decode():
    cfg = tconfigs.get_arch("hymba-1.5b").reduced()
    p = TS.mamba_init(cfg, gen(3), "cpu")
    b, s = 2, 9
    x = torch.as_tensor(normal(3, b, s, cfg.d_model))
    y_full, st_full = TS.mamba_forward(p, x, cfg)
    di = cfg.d_model * cfg.ssm_expand
    state = {"ssm": torch.zeros((b, di, cfg.ssm_state)),
             "conv": torch.zeros((b, cfg.conv_kernel - 1, di))}
    ys = []
    for i in range(s):
        y, state = TS.mamba_decode(p, x[:, i:i + 1], state, cfg)
        ys.append(y)
    close(y_full, torch.cat(ys, dim=1))
    close(st_full["ssm"], state["ssm"])


def test_rwkv_state_is_input_size_independent():
    cfg = tconfigs.get_arch("rwkv6-1.6b").reduced()
    p = TS.rwkv_init(cfg, gen(4), "cpu")
    for s in (4, 32):
        x = torch.as_tensor(normal(s, 1, s, cfg.d_model))
        _, st = TS.rwkv_forward(p, x, cfg)
        assert tuple(st["wkv"].shape) == (1, cfg.d_model // 64, 64, 64)


def test_wkv_chunked_equals_sequential():
    """The chunked form (the WKV kernel's route) is the sequential
    recurrence."""
    cfg = tconfigs.get_arch("rwkv6-1.6b").reduced()
    p = TS.rwkv_init(cfg, gen(7), "cpu")
    x = torch.as_tensor(normal(8, 2, 256, cfg.d_model))
    y_seq, st_seq = TS.rwkv_forward(p, x, cfg, chunked=False)
    y_chk, st_chk = TS.rwkv_forward(p, x, cfg, chunked=True)
    close(y_seq, y_chk)
    close(st_seq["wkv"], st_chk["wkv"])


# ---------------------------------------------------------------------------
# the port against the reference, on carried weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf,b,s", [(8.0, 2, 8), (1.0, 4, 16)])
def test_moe_ffn_local_matches_reference(cf, b, s):
    """Output and aux, with ample capacity and with drops."""
    rcfg = dataclasses.replace(rconfigs.get_arch("olmoe-1b-7b").reduced(),
                               capacity_factor=cf)
    tcfg = moe_cfg(capacity_factor=cf)
    rp = RM.moe_init(rcfg, jax.random.PRNGKey(11))
    x = normal(11, b, s, rcfg.d_model)
    want, waux = RM._moe_ffn_local(rp, jnp.asarray(x), rcfg)
    got, gaux = TM._moe_ffn_local(carry(rp), torch.as_tensor(x), tcfg)
    close(got, want)
    close(gaux, waux)
    assert TM._capacity(b * s, tcfg) == RM._capacity(b * s, rcfg)


def rwkv_pair(seed):
    rcfg = rconfigs.get_arch("rwkv6-1.6b").reduced()
    tcfg = tconfigs.get_arch("rwkv6-1.6b").reduced()
    rp = RS.rwkv_init(rcfg, jax.random.PRNGKey(seed))
    # a nonzero bonus u, so that its term is held too
    rp = dict(rp, u=jnp.asarray(normal(seed, rcfg.d_model) * 0.3))
    return rcfg, tcfg, rp, carry(rp)


@pytest.mark.parametrize("chunked", [True, False])
def test_rwkv_forward_matches_reference(chunked, monkeypatch):
    """S = 256: chunked, the port calls the WKV kernel's entry point once
    (its plain version here) where the reference runs its chunked form;
    sequential, both scan."""
    rcfg, tcfg, rp, tp = rwkv_pair(12)
    x = normal(12, 2, 256, rcfg.d_model)
    calls = []
    real = TW.wkv_chunk_kernel

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(TW, "wkv_chunk_kernel", counted)
    want, wst = RS.rwkv_forward(rp, jnp.asarray(x), rcfg, chunked=chunked)
    got, gst = TS.rwkv_forward(tp, torch.as_tensor(x), tcfg, chunked=chunked)
    assert calls == ([{"q": TS.WKV_CHUNK, "device": torch.device("cpu")}]
                     if chunked else [])
    close(got, want, 3e-4)
    for name in ("wkv", "shift"):
        close(gst[name], wst[name], 3e-4, name)


def test_rwkv_decode_matches_reference():
    rcfg, tcfg, rp, tp = rwkv_pair(13)
    b, h = 2, rcfg.d_model // 64
    x = normal(13, b, 1, rcfg.d_model)
    wkv = normal(14, b, h, 64, 64)
    shift = normal(15, b, rcfg.d_model)
    want, wst = RS.rwkv_decode(rp, jnp.asarray(x), {
        "wkv": jnp.asarray(wkv), "shift": jnp.asarray(shift)}, rcfg)
    got, gst = TS.rwkv_decode(tp, torch.as_tensor(x), {
        "wkv": torch.as_tensor(wkv), "shift": torch.as_tensor(shift)}, tcfg)
    close(got, want)
    for name in ("wkv", "shift"):
        close(gst[name], wst[name], msg=name)


def test_rwkv_channel_mix_matches_reference():
    rcfg = rconfigs.get_arch("rwkv6-1.6b").reduced()
    rp = RS.rwkv_channel_mix_init(rcfg, jax.random.PRNGKey(16))
    x, xp = normal(16, 2, 5, rcfg.d_model), normal(17, 2, 5, rcfg.d_model)
    want = RS.rwkv_channel_mix(rp, jnp.asarray(x), jnp.asarray(xp))
    got = TS.rwkv_channel_mix(carry(rp), torch.as_tensor(x),
                              torch.as_tensor(xp))
    close(got, want)


def mamba_pair(seed):
    rcfg = rconfigs.get_arch("hymba-1.5b").reduced()
    tcfg = tconfigs.get_arch("hymba-1.5b").reduced()
    rp = RS.mamba_init(rcfg, jax.random.PRNGKey(seed))
    # nonzero a_log, so that the decays differ by channel
    rp = dict(rp, a_log=jnp.asarray(normal(seed, *rp["a_log"].shape) * 0.5))
    return rcfg, tcfg, rp, carry(rp)


def test_mamba_forward_matches_reference():
    rcfg, tcfg, rp, tp = mamba_pair(18)
    x = normal(18, 2, 12, rcfg.d_model)
    want, wst = RS.mamba_forward(rp, jnp.asarray(x), rcfg)
    got, gst = TS.mamba_forward(tp, torch.as_tensor(x), tcfg)
    close(got, want)
    for name in ("ssm", "conv"):
        close(gst[name], wst[name], msg=name)


def test_mamba_decode_matches_reference():
    rcfg, tcfg, rp, tp = mamba_pair(19)
    b, di = 2, rcfg.d_model * rcfg.ssm_expand
    x = normal(19, b, 1, rcfg.d_model)
    ssm = normal(20, b, di, rcfg.ssm_state)
    conv = normal(21, b, rcfg.conv_kernel - 1, di)
    want, wst = RS.mamba_decode(rp, jnp.asarray(x), {
        "ssm": jnp.asarray(ssm), "conv": jnp.asarray(conv)}, rcfg)
    got, gst = TS.mamba_decode(tp, torch.as_tensor(x), {
        "ssm": torch.as_tensor(ssm), "conv": torch.as_tensor(conv)}, tcfg)
    close(got, want)
    for name in ("ssm", "conv"):
        close(gst[name], wst[name], msg=name)
