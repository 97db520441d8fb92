"""Attention-free sequence mixers: RWKV6 (Finch) and a Mamba-style selective
SSM (used by the Hymba hybrid blocks).

The counterpart of the reference's ``src/repro/models/ssm.py``: (a) a
full-sequence form for train/prefill, a Python loop over time where the
reference scans, and (b) an O(1)-state single-step form for decode.

RWKV6 recurrence (per head, D = head dim, state S in R^{D x D}):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent decay w_t = exp(-exp(decay(x_t))).

**The kernel route.** Where the reference takes its chunked closed form
(``S % 64 == 0 and S > 64``), :func:`rwkv_forward` runs the ``wkv_chunk``
kernel (:func:`_wkv_chunked`) on the input's own device: three launches a
layer for the whole batch on the card, its plain version ``wkv_plain`` on
the CPU.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv_chunk as W
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dense_init, dtype_of, linear, randn,
                                       uniform)

Params = Dict[str, torch.Tensor]

_RWKV_HEAD = 64


def rwkv_heads(cfg: ArchConfig) -> int:
    return cfg.d_model // _RWKV_HEAD


# ---------------------------------------------------------------------------
# RWKV6 time mixing
# ---------------------------------------------------------------------------


def rwkv_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = dtype_of(cfg)
    d = cfg.d_model
    return {
        "mu": uniform(gen, (5, d), dt, device),  # token-shift mixes r,k,v,w,g
        "wr": dense_init(gen, d, d, dt, device),
        "wk": dense_init(gen, d, d, dt, device),
        "wv": dense_init(gen, d, d, dt, device),
        "wd": dense_init(gen, d, d, dt, device, scale=0.002),  # decay
        "wg": dense_init(gen, d, d, dt, device),
        "wo": dense_init(gen, d, d, dt, device),
        "u": torch.zeros((d,), dtype=dt, device=device),  # bonus per channel
    }


def _rwkv_proj(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift interpolation then the five projections.
    x, x_prev: (B,S,d) where x_prev is x shifted right by one."""
    def mix(i):
        return x * p["mu"][i] + x_prev * (1 - p["mu"][i])
    r = linear(p["wr"], mix(0))
    k = linear(p["wk"], mix(1))
    v = linear(p["wv"], mix(2))
    w = torch.exp(-torch.exp(linear(p["wd"], mix(3)).float()))
    g = F.silu(linear(p["wg"], mix(4)))
    return r, k, v, w, g


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], h, _RWKV_HEAD)


def _rwkv_step(state, rkvw, u):
    """state: (B,H,D,D). r,k,v: (B,H,D); w: (B,H,D) decay in [0,1]."""
    r, k, v, w = rkvw
    kv = k[..., :, None] * v[..., None, :]                    # (B,H,D,D)
    out = torch.einsum("bhd,bhde->bhe", r, state + u[..., :, None] * kv)
    state = w[..., :, None] * state + kv
    return state, out


#: chunk of the chunked WKV form, used from S = 2 chunks when S is a
#: multiple of it
WKV_CHUNK = 64


def rwkv_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 chunked: bool = True) -> Tuple[torch.Tensor, Params]:
    """Full-sequence RWKV6 time mixing from state zero. Returns (y, final
    state)."""
    b, s, d = x.shape
    h = rwkv_heads(cfg)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g = _rwkv_proj(p, x, x_prev)
    rh, kh, vh = (_heads(t, h).float() for t in (r, k, v))
    # the projections' own copies are dead once cast: at long_500k's
    # 524,288 tokens each is 2 GiB beside the kernel's float32 inputs
    del x_prev, r, k, v
    wh = _heads(w, h)
    u = _heads(p["u"].float()[None], h)[0]                    # (H,D)

    if chunked and s % WKV_CHUNK == 0 and s > WKV_CHUNK:
        state, y = _wkv_chunked(rh, kh, vh, wh, u, WKV_CHUNK)
    else:
        state = torch.zeros((b, h, _RWKV_HEAD, _RWKV_HEAD),
                            dtype=torch.float32, device=x.device)
        outs = []
        for t in range(s):
            state, out = _rwkv_step(
                state, (rh[:, t], kh[:, t], vh[:, t], wh[:, t]), u)
            outs.append(out)
        y = torch.stack(outs, dim=1)
    y = y.reshape(b, s, d).to(x.dtype)
    y = y * g
    y = linear(p["wo"], y)
    return y, {"wkv": state, "shift": x[:, -1]}


def _wkv_chunked(r, k, v, w, u, q):
    """The chunked WKV from state zero through the ``wkv_chunk`` kernel on
    the inputs' device, the whole batch in one call (three launches on the
    card). Its log-decays are the reference's ``log(max(w, 1e-38))``.
    r,k,v: (B,S,H,D) f32, w: (B,S,H,D) in (0,1), u: (H,D). Returns
    (S', y (B,S,H,D))."""
    logw = torch.log(torch.clamp(w, min=1e-38))
    y, state = W.wkv_chunk_kernel(r, k, v, logw, u, q=q, device=r.device)
    return state, y


def rwkv_decode(p: Params, x: torch.Tensor, state: Params, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One-token step. state = {wkv: (B,H,D,D) f32, shift: (B,d)}."""
    b, _, d = x.shape
    h = rwkv_heads(cfg)
    x1 = x[:, 0]
    r, k, v, w, g = _rwkv_proj(p, x1[:, None], state["shift"][:, None])
    rh, kh, vh = (_heads(t[:, 0], h).float() for t in (r, k, v))
    wh = _heads(w[:, 0], h)
    u = _heads(p["u"].float()[None], h)[0]
    st, out = _rwkv_step(state["wkv"], (rh, kh, vh, wh), u)
    y = out.reshape(b, 1, d).to(x.dtype) * g
    return linear(p["wo"], y), {"wkv": st, "shift": x1}


def rwkv_channel_mix_init(cfg: ArchConfig, gen: torch.Generator,
                          device) -> Params:
    dt = dtype_of(cfg)
    return {
        "mu": uniform(gen, (2, cfg.d_model), dt, device),
        "wk": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device),
        "wv": dense_init(gen, cfg.d_ff, cfg.d_model, dt, device),
    }


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
    k = linear(p["wk"], x * p["mu"][0] + x_prev * (1 - p["mu"][0]))
    k = torch.square(torch.relu(k))
    return linear(p["wv"], k)


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba's parallel SSM heads)
# ---------------------------------------------------------------------------


def mamba_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = dtype_of(cfg)
    d = cfg.d_model
    di = d * cfg.ssm_expand
    n = cfg.ssm_state
    return {
        "w_in": dense_init(gen, d, 2 * di, dt, device),
        "conv": randn(gen, (cfg.conv_kernel, di), dt, device, 0.02),
        "w_bc": dense_init(gen, di, 2 * n, dt, device),
        "w_dt": dense_init(gen, di, di, dt, device, scale=0.002),
        "a_log": torch.zeros((di, n), dtype=torch.float32, device=device),
        "d_skip": torch.ones((di,), dtype=dt, device=device),
        "w_out": dense_init(gen, di, d, dt, device),
    }


def _mamba_scan_inputs(p: Params, xz: torch.Tensor, conv_state: torch.Tensor):
    """xz: (B,S,2*di) already projected. Returns gate z and per-step (x, dt,
    B, C) plus the new conv ring state (last K-1 pre-conv activations)."""
    di = p["conv"].shape[1]
    kk = p["conv"].shape[0]
    x, z = xz[..., :di], xz[..., di:]
    hist = torch.cat([conv_state, x], dim=1)                 # (B,K-1+S,di)
    s = x.shape[1]
    conv = hist[:, 0:s] * p["conv"][0]
    for i in range(1, kk):
        conv = conv + hist[:, i:i + s] * p["conv"][i]
    conv = F.silu(conv)
    # jax.nn.softplus has no threshold; F.softplus returns x above 20,
    # where the two differ by under exp(-20) (within tolerance)
    dt = F.softplus(linear(p["w_dt"], conv).float())
    bc = linear(p["w_bc"], conv)
    n = bc.shape[-1] // 2
    bmat, cmat = bc[..., :n], bc[..., n:]
    new_conv_state = hist[:, hist.shape[1] - (kk - 1):]
    return z, conv, dt, bmat, cmat, new_conv_state


def _mamba_step(state, inp, a):
    """state: (B,di,N); x,dt: (B,di); b,c: (B,N)."""
    x, dt, bmat, cmat = inp
    da = torch.exp(dt[..., None] * a[None])                   # (B,di,N)
    state = state * da + (dt * x)[..., None] * bmat[:, None, :].float()
    y = torch.einsum("bdn,bn->bd", state, cmat.float())
    return state, y


def mamba_forward(p: Params, x: torch.Tensor, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Params]:
    b, s, d = x.shape
    di = d * cfg.ssm_expand
    kk = cfg.conv_kernel
    xz = linear(p["w_in"], x)
    conv0 = torch.zeros((b, kk - 1, di), dtype=x.dtype, device=x.device)
    z, conv, dt, bmat, cmat, conv_state = _mamba_scan_inputs(p, xz, conv0)
    a = -torch.exp(p["a_log"])                                # (di,N)
    state = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                        device=x.device)
    convf = conv.float()
    ys = []
    for t in range(s):
        state, y = _mamba_step(
            state, (convf[:, t], dt[:, t], bmat[:, t], cmat[:, t]), a)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype)
    y = (y + conv * p["d_skip"]) * F.silu(z)
    return linear(p["w_out"], y), {"ssm": state, "conv": conv_state}


def mamba_decode(p: Params, x: torch.Tensor, state: Params, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Params]:
    xz = linear(p["w_in"], x)                                  # (B,1,2di)
    z, conv, dt, bmat, cmat, conv_state = _mamba_scan_inputs(
        p, xz, state["conv"])
    a = -torch.exp(p["a_log"])
    st, y = _mamba_step(state["ssm"],
                        (conv[:, 0].float(), dt[:, 0], bmat[:, 0],
                         cmat[:, 0]), a)
    y = y[:, None].to(x.dtype)
    y = (y + conv * p["d_skip"]) * F.silu(z)
    return linear(p["w_out"], y), {"ssm": st, "conv": conv_state}
