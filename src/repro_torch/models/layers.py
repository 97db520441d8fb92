"""Transformer building blocks: norms, RoPE, GQA/MLA attention, MLPs.

Pure functions over parameter dicts, as in the reference's
``src/repro/models/layers.py``: the same names, the same dict keys and the
``x @ w`` orientation (``w`` is ``(d_in, d_out)``), so carrying weights
across is a copy. All attention math keeps a float32 softmax; parameters
live in ``cfg.dtype``.

Cache convention: decode caches are ring buffers of length ``cache_len``;
``pos`` is the number of tokens already consumed (an int, or a ``(B,)``
tensor for ragged batches). The decode functions write the new token's
entries into the cache tensors they are given, in place, and return them.

**The kernel route.** Causal prefill longer than :data:`FLASH_THRESHOLD`
with no window, where the reference takes ``_sdpa_blockwise``, runs the
``flash_attention`` kernel (:func:`_flash_prefill`) on the tensors' own
device: the kernel on the card, its plain version ``flash_plain`` on the
CPU. A windowed blockwise prefill keeps the plain :func:`_sdpa_blockwise`
on both devices (the kernel has no window mask); short prefill and every
decode step stay plain PyTorch, as the reference computes them outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def randn(gen: torch.Generator, shape, dtype: torch.dtype,
          device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """Normal draws from ``gen`` (on the generator's own device, float32),
    scaled, then cast and moved to ``device``. On the meta device (the
    dry run's shapes) nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (t * scale).to(device=device, dtype=dtype)


def uniform(gen: torch.Generator, shape, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return t.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = 0.02, bias: bool = False) -> Params:
    p = {"w": randn(gen, (d_in, d_out), dtype, device, scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # theta filled on the device: a host tensor would cost a copy and a
    # wait for the card on every call
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of RoPE's angles, (..., S, 1, D/2) for positions
    broadcastable to (..., S)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., S, D/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). ``table``:
    :func:`rope_table` of these positions at D, where the caller has it."""
    cos, sin = table or rope_table(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masked multi-head attention core
# ---------------------------------------------------------------------------


#: sequences longer than this use the blockwise online-softmax path (the
#: flash kernel where there is no window)
FLASH_THRESHOLD = 2048
FLASH_BLOCK = 1024


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,KV,D) with H % KV == 0; mask (B,1,S,T) bool."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.reshape(b, s, kv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / (d ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _sdpa_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    offset: int, window: int,
                    block: int = FLASH_BLOCK) -> torch.Tensor:
    """Causal attention with online softmax over KV blocks, the reference's
    plain form: never materialises the (S,T) score matrix. q:(B,S,H,D),
    k/v:(B,T,KV,D). Runs the windowed blockwise prefill (the flash kernel
    has no window mask)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    nb = -(-t // block)
    tp = nb * block
    if tp != t:
        k = F.pad(k, (0, 0, 0, 0, 0, tp - t))
        v = F.pad(v, (0, 0, 0, 0, 0, tp - t))
    dev = q.device
    qf = q.reshape(b, s, kvh, g, d).float() / (d ** 0.5)
    qpos = offset + torch.arange(s, device=dev)
    m = torch.full((b, kvh, g, s), -float("inf"), device=dev)
    l = torch.zeros((b, kvh, g, s), device=dev)
    acc = torch.zeros((b, kvh, g, s, d), device=dev)
    zero = torch.zeros((), device=dev)
    for bi in range(nb):
        kblk = k[:, bi * block:(bi + 1) * block].float()
        vblk = v[:, bi * block:(bi + 1) * block].float()
        kpos = bi * block + torch.arange(block, device=dev)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, kblk)
        msk = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < t)
        if window:
            msk &= kpos[None, :] > qpos[:, None] - window
        sc = torch.where(msk, sc, torch.full_like(sc, -float("inf")))
        m_new = torch.maximum(m, sc.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(sc - m_safe[..., None])
        p = torch.where(torch.isfinite(sc), p, zero)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out.to(q.dtype)


def _flash_prefill(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Causal attention with no window through the ``flash_attention``
    kernel on the tensors' own device, one launch for the whole batch:
    ``(B, S, H, D)`` folded into ``(S, B·H, D)`` (one contiguous copy each),
    the grouped k/v heads expanded to q's H (head ``h`` reads kv head
    ``h // g``, the reference's ``reshape(b, s, kv, g, d)``).
    q:(B,S,H,D), k/v:(B,S,KV,D) -> (B,S,H,D). A shape outside the kernel's
    domain raises. On the meta device (the dry run's count) the same work
    in the reference's blockwise form."""
    if q.device.type == "meta":
        return _sdpa_blockwise(q, k, v, offset=0, window=0)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh

    def fold(t: torch.Tensor) -> torch.Tensor:
        if t.shape[2] != h:
            t = t[:, :, :, None].expand(b, s, kvh, g, d)
        return t.transpose(0, 1).reshape(s, b * h, d)

    y = ops.flash_attention(fold(q), fold(k), fold(v), causal=True,
                            device=q.device)
    return y.reshape(s, b, h, d).transpose(0, 1)


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int) -> torch.Tensor:
    """Full causal self-attention of a prefill: the reference's choice of
    path by length, with the flash kernel where it takes the blockwise one
    with no window."""
    s = q.shape[1]
    if s > FLASH_THRESHOLD:
        if window:
            return _sdpa_blockwise(q, k, v, offset=0, window=window)
        return _flash_prefill(q, k, v)
    return _sdpa(q, k, v, causal_mask(s, s, 0, window, q.device))


def causal_mask(s: int, t: int, offset: int, window: int = 0,
                device=None) -> torch.Tensor:
    """(1,1,S,T) bool: query i (global pos offset+i) may see key j<=pos,
    optionally within a trailing window."""
    qpos = offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None]


# ---------------------------------------------------------------------------
# GQA attention (optional sliding window; optional QKV bias)
# ---------------------------------------------------------------------------


def attn_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = dtype_of(cfg)
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dt, device,
                         bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device,
                         bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device,
                         bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dt, device),
    }


def _qkv(p: Params, x: torch.Tensor, cfg: ArchConfig, positions,
         table=None) -> Tuple:
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = linear(p["wk"], x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = linear(p["wv"], x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    table = table or rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, table)
    k = apply_rope(k, positions, cfg.rope_theta, table)
    return q, k, v


def attn_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 window: int = 0) -> Tuple[torch.Tensor, Params]:
    """Training / prefill: full causal attention over x. Returns output and
    the KV cache {k, v} (B,S,KV,D). Long sequences take the flash kernel
    (or, with a window, the plain blockwise path)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    y = _prefill_attention(q, k, v, window)
    y = linear(p["wo"], y.reshape(b, s, cfg.q_dim))
    return y, {"k": k, "v": v}


def _quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t: (B,S,KV,D) -> int8 values + per-(B,S,KV) scale. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _ring(posv: torch.Tensor, cache_len: int, window: int):
    """(slot (B,), valid (B,C)): each request's ring slot for this token
    and the slots holding tokens (pos-window, pos]."""
    slot = posv % cache_len
    idx = torch.arange(cache_len, device=posv.device)
    age = (slot[:, None] - idx[None, :]) % cache_len         # 0 = newest
    valid = age < torch.clamp(posv + 1, max=cache_len)[:, None]
    if window:
        valid &= age < window
    return slot, valid


def _positions(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long).expand(b).contiguous()
    # filled on the device: no host copy, no wait for the card
    return torch.full((b,), int(pos), dtype=torch.long, device=device)


class DecodeStep(NamedTuple):
    """A decode step's values that every layer shares: each request's
    position (B,), its ring slot (B,) and valid slots (B, C), and RoPE's
    (cos, sin) at that position (:func:`rope_table`)."""
    pos: torch.Tensor
    slot: torch.Tensor
    valid: torch.Tensor
    rope: Tuple[torch.Tensor, torch.Tensor]


def decode_step_values(pos, b: int, cache_len: int, window: int,
                       rope_dim: int, theta: float, device) -> DecodeStep:
    """:class:`DecodeStep` for one decode step; ``rope_dim`` is the width
    RoPE turns (GQA's head dim, MLA's rope head dim)."""
    posv = _positions(pos, b, device)
    slot, valid = _ring(posv, cache_len, window)
    return DecodeStep(posv, slot, valid,
                      rope_table(posv[:, None], rope_dim, theta))


def attn_decode(p: Params, x: torch.Tensor, cache: Params, pos,
                cfg: ArchConfig, window: int = 0,
                step: Optional[DecodeStep] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. cache: {k,v} (B,C,KV,D) ring buffer, written in
    place; pos = tokens already in cache, an int or a (B,) tensor for ragged
    batches (continuous-batching serving). When the cache is int8
    (cfg.kv_quant) values carry per-(slot, kv-head) scales and are
    dequantised on read. ``step``: the step's shared values, where the
    caller computed them once for every layer. Returns output (B,1,d) and
    the cache."""
    b = x.shape[0]
    step = step or decode_step_values(pos, b, cache["k"].shape[1], window,
                                      cfg.head_dim, cfg.rope_theta,
                                      x.device)
    slot, valid = step.slot, step.valid
    q, k, v = _qkv(p, x, cfg, step.pos[:, None], step.rope)
    bi = torch.arange(b, device=x.device)
    quant = cache["k"].dtype == torch.int8
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k_scale"][bi, slot] = ks[:, 0]
        cache["v_scale"][bi, slot] = vs[:, 0]
        k, v = kq, vq
    cache["k"][bi, slot] = k[:, 0]
    cache["v"][bi, slot] = v[:, 0]
    ck, cv = cache["k"], cache["v"]
    if quant:
        ck = ck.float() * cache["k_scale"][..., None]
        cv = cv.float() * cache["v_scale"][..., None]
    y = _sdpa(q, ck, cv, valid[:, None, None, :])
    y = linear(p["wo"], y.reshape(b, 1, cfg.q_dim))
    return y, cache


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-style latent KV compression)
# ---------------------------------------------------------------------------


def mla_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = dtype_of(cfg)
    h, dn, dr, dv = (cfg.num_heads, cfg.head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim or cfg.head_dim)
    return {
        "wq_a": dense_init(gen, cfg.d_model, cfg.q_lora_rank, dt, device),
        "q_norm": rms_norm_init(cfg.q_lora_rank, dt, device),
        "wq_b": dense_init(gen, cfg.q_lora_rank, h * (dn + dr), dt, device),
        "wkv_a": dense_init(gen, cfg.d_model, cfg.kv_lora_rank + dr, dt,
                            device),
        "kv_norm": rms_norm_init(cfg.kv_lora_rank, dt, device),
        "wk_b": dense_init(gen, cfg.kv_lora_rank, h * dn, dt, device),
        "wv_b": dense_init(gen, cfg.kv_lora_rank, h * dv, dt, device),
        "wo": dense_init(gen, h * dv, cfg.d_model, dt, device),
    }


def _mla_q(p: Params, x: torch.Tensor, cfg: ArchConfig, positions,
           table=None):
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    q = linear(p["wq_b"], rms_norm(p["q_norm"], linear(p["wq_a"], x)))
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, table)
    return q_nope, q_rope


def _mla_latent(p: Params, x: torch.Tensor, cfg: ArchConfig, positions,
                table=None):
    kv = linear(p["wkv_a"], x)
    c_kv = rms_norm(p["kv_norm"], kv[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta, table)[..., 0, :]
    return c_kv, k_rope


def mla_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                window: int = 0) -> Tuple[torch.Tensor, Params]:
    b, s, _ = x.shape
    h, dn, dv = cfg.num_heads, cfg.head_dim, cfg.v_head_dim or cfg.head_dim
    dr = cfg.rope_head_dim
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = linear(p["wk_b"], c_kv).reshape(b, s, h, dn)
    v = linear(p["wv_b"], c_kv).reshape(b, s, h, dv)
    # fold the shared rope sub-dim into per-head keys so both score terms run
    # through one attention call (the flash kernel's D = dn + dr)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, dr)],
                       dim=-1)
    if dv < dn + dr:
        v = F.pad(v, (0, dn + dr - dv))
    y = _prefill_attention(q_full, k_full, v, window)
    y = y[..., :dv]
    y = linear(p["wo"], y.reshape(b, s, h * dv))
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p: Params, x: torch.Tensor, cache: Params, pos,
               cfg: ArchConfig, window: int = 0,
               step: Optional[DecodeStep] = None
               ) -> Tuple[torch.Tensor, Params]:
    """Absorbed-form MLA decode: attention runs in the compressed latent
    space (the cache stores c_kv + k_rope only), the cache written in
    place. ``step`` as in :func:`attn_decode`."""
    b = x.shape[0]
    h, dn, dv = cfg.num_heads, cfg.head_dim, cfg.v_head_dim or cfg.head_dim
    r = cfg.kv_lora_rank
    step = step or decode_step_values(pos, b, cache["c_kv"].shape[1], window,
                                      cfg.rope_head_dim, cfg.rope_theta,
                                      x.device)
    slot, valid = step.slot, step.valid
    positions = step.pos[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions, step.rope)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions, step.rope)
    bi = torch.arange(b, device=x.device)
    cache["c_kv"][bi, slot] = c_kv[:, 0]
    cache["k_rope"][bi, slot] = k_rope[:, 0]
    cc, cr = cache["c_kv"].float(), cache["k_rope"].float()
    # absorb W_uk into q: (B,1,H,dn) @ (r,H,dn) -> (B,H,r)
    wk_b = p["wk_b"]["w"].reshape(r, h, dn).float()
    q_lat = torch.einsum("bshd,rhd->bhr", q_nope.float(), wk_b)
    scores = (torch.einsum("bhr,btr->bht", q_lat, cc)
              + torch.einsum("bshd,btd->bht", q_rope.float(), cr))
    scores = scores / ((dn + cfg.rope_head_dim) ** 0.5)
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    lat = torch.einsum("bht,btr->bhr", w, cc)
    wv_b = p["wv_b"]["w"].reshape(r, h, dv).float()
    y = torch.einsum("bhr,rhd->bhd", lat, wv_b)
    y = y.reshape(b, 1, h * dv).to(x.dtype)
    return linear(p["wo"], y), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(cfg: ArchConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None) -> Params:
    dt = dtype_of(cfg)
    ff = d_ff or cfg.d_ff
    p = {
        "w_up": dense_init(gen, cfg.d_model, ff, dt, device),
        "w_down": dense_init(gen, ff, cfg.d_model, dt, device),
    }
    if cfg.activation == "silu":  # gated (SwiGLU)
        p["w_gate"] = dense_init(gen, cfg.d_model, ff, dt, device)
    return p


def mlp(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    up = linear(p["w_up"], x)
    if cfg.activation == "silu":
        h = F.silu(linear(p["w_gate"], x)) * up
    elif cfg.activation == "sq_relu":
        r = torch.relu(up)
        h = r * r
    elif cfg.activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return linear(p["w_down"], h)
