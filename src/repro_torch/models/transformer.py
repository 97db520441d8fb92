"""Config-driven decoder stack covering all assigned families.

The counterpart of the reference's ``src/repro/models/transformer.py``.
Layers keep the stacked layout (a leading ``L`` dim on every block tensor)
and are walked by a Python loop: the full passes over ``torch.unbind`` of
each stacked tensor (one view a layer, whose backward is one ``stack`` a
tensor), prefill and decode over the views ``t[l]``.

Entry points:
  forward_hidden(cfg, params, inputs, remat)    -> hidden, aux
  forward_train(cfg, params, inputs, remat)     -> logits, aux
  prefill(cfg, params, inputs, cache_len)       -> logits, cache
  decode_step(cfg, params, cache, tokens, pos)  -> logits, cache

``inputs`` is a token tensor (B,S) of integers, or pre-computed embeddings
(B,S,d_model) for the audio/VLM frontend-stub families. Tensors run where
they lie: on the card, long causal prefill attention is the
``flash_attention`` kernel and RWKV's chunked time mixing the
``wkv_chunk`` kernel; on the CPU, their plain versions.

:func:`decode_step` writes each layer's new cache entries into the stacked
cache in place, with no copy of the stack: the port's counterpart of the
reference's donated scan carry, the serving side's ``O_s = |out|`` case.

``remat`` is the reference's ``jax.checkpoint`` of the scan body:
``torch.utils.checkpoint`` (non-reentrant) over each group of
:data:`REMAT_GROUP` layers (one layer below
:data:`REMAT_GROUP_MIN_LAYERS`), applied only while grad is enabled, so
serving under ``inference_mode`` is unchanged. Each group's forward runs
again in the backward, the flash kernel's launches with it, under the
axis env installed at the forward (``sharding.keep_env``: on the card the
backward runs on autograd's own thread).

The reference's four ``repro.sharding.constrain`` calls stand at the same
places (each block's two residual sums, the embedding, the logits) as
``repro_torch.sharding.constrain``, the identity on one card. Not here:
the reference's ``identity_barrier``, an XLA scheduling fence whose value
and gradient are the identity (nothing to fence in eager PyTorch).

With a :mod:`repro_torch.trace` recorder on, :func:`prefill` records
``repro/model/prefill`` (``tokens``) and :func:`decode_step`
``repro/model/decode`` (``slots``); inside them each layer's
``repro/model/attn`` (norm, mixer, residual) and ``repro/model/ffn``
(norm, MLP, MoE or channel mix, residual) with its ``layer``, the
prefill's ``repro/model/cache_fill`` a layer, and ``repro/model/head``
(final norm and unembedding).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import constrain, keep_env

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree, device=None) -> Params:
    """The reference's parameter tree (nested dicts of numpy arrays, as
    ``jax.device_get`` gives them) as the same tree of tensors on
    ``device`` (None: the card; ``"cpu"``), with the same names, shapes and
    dtypes. bfloat16 arrays are carried through float32, which is exact."""
    dev = resolve_device(device)

    def carry(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)
    return tree_map(carry, tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _block_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = L.dtype_of(cfg)
    p: Params = {"norm1": L.rms_norm_init(cfg.d_model, dt, device),
                 "norm2": L.rms_norm_init(cfg.d_model, dt, device)}
    if cfg.attention == "gqa":
        p["attn"] = L.attn_init(cfg, gen, device)
    elif cfg.attention == "mla":
        p["attn"] = L.mla_init(cfg, gen, device)
    elif cfg.attention == "hybrid":
        p["attn"] = L.attn_init(cfg, gen, device)
        p["mamba"] = S.mamba_init(cfg, gen, device)
    elif cfg.attention == "none":
        p["rwkv"] = S.rwkv_init(cfg, gen, device)
    else:
        raise ValueError(cfg.attention)
    if cfg.attention == "none":
        p["cmix"] = S.rwkv_channel_mix_init(cfg, gen, device)
    elif cfg.is_moe:
        p["moe"] = M.moe_init(cfg, gen, device)
    else:
        p["mlp"] = L.mlp_init(cfg, gen, device)
    return p


def _stack_into(stacked, l: int, tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _stack_into(stacked[k], l, v)
    else:
        stacked[l].copy_(tree)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, shard: Optional[Callable] = None) -> Params:
    """Random weights drawn from ``generator`` (on its own device), placed
    on ``device`` (None: the card; ``"cpu"``). The draws cannot equal
    ``jax.random``'s: a comparison with the reference carries its weights
    (:func:`params_from_reference`). ``shard(path, t)``, where given, cuts
    each layer's leaf (path as ``"blocks/moe/w_gate"``) before it is
    stacked: a rank's shard (``launch/specs.py::rank_init_params``)."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)

    def block():
        b = _block_init(cfg, generator, dev)
        if shard is None:
            return b

        def cut(tree, prefix):
            if isinstance(tree, dict):
                return {k: cut(v, f"{prefix}{k}/") for k, v in tree.items()}
            return shard(prefix[:-1], tree)
        return cut(b, "blocks/")

    embed = L.randn(generator, (cfg.vocab_size, cfg.d_model), dt, dev, 0.02)
    first = block()
    blocks = tree_map(lambda t: t.new_empty((cfg.num_layers, *t.shape)),
                      first)
    _stack_into(blocks, 0, first)
    del first
    for l in range(1, cfg.num_layers):
        _stack_into(blocks, l, block())
    p = {"embed": embed, "blocks": blocks,
         "final_norm": L.rms_norm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.randn(generator, (cfg.d_model, cfg.vocab_size), dt,
                               dev, 0.02)
    return p


def layer(blocks: Params, l: int) -> Params:
    """Layer ``l``'s parameters: views ``t[l]`` of the stacked tensors."""
    return tree_map(lambda t: t[l], blocks)


def unbind_layers(blocks: Params, n: int) -> List[Params]:
    """Every layer's parameters from one ``torch.unbind`` of each stacked
    tensor. In training this is the walk to take: autograd's backward of
    ``unbind`` is one ``stack`` a tensor, where each view ``t[l]`` would
    add a zero tensor the size of the whole stack."""
    if isinstance(blocks, dict):
        parts = {k: unbind_layers(v, n) for k, v in blocks.items()}
        return [{k: p[l] for k, p in parts.items()} for l in range(n)]
    return list(torch.unbind(blocks, 0))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _block_seq(cfg: ArchConfig, bp: Params, x: torch.Tensor, window: int,
               index: Optional[int] = None
               ) -> Tuple[torch.Tensor, Params, torch.Tensor]:
    """Full-sequence block (train / prefill). Returns (x, cache, aux).
    ``index``: the layer's, for its spans."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with trace.span("repro/model/attn", layer=index):
        h = L.rms_norm(bp["norm1"], x)
        cache: Params = {}
        if cfg.attention == "gqa":
            y, cache = L.attn_forward(bp["attn"], h, cfg, window)
        elif cfg.attention == "mla":
            y, cache = L.mla_forward(bp["attn"], h, cfg, window)
        elif cfg.attention == "hybrid":
            ya, ca = L.attn_forward(bp["attn"], h, cfg,
                                    window or cfg.sliding_window)
            ym, cm = S.mamba_forward(bp["mamba"], h, cfg)
            y = 0.5 * (ya + ym)
            cache = {**ca, **cm}
        else:  # rwkv
            y, cache = S.rwkv_forward(bp["rwkv"], h, cfg)
        x = constrain(x + y, "batch", None, None)
    with trace.span("repro/model/ffn", layer=index):
        h = L.rms_norm(bp["norm2"], x)
        if cfg.attention == "none":
            hp = F.pad(h, (0, 0, 1, 0))[:, :-1]
            y = S.rwkv_channel_mix(bp["cmix"], h, hp)
            cache["cm_shift"] = h[:, -1]
        elif cfg.is_moe:
            y, aux = M.moe_ffn(bp["moe"], h, cfg)
        else:
            y = L.mlp(bp["mlp"], h, cfg)
        return constrain(x + y, "batch", None, None), cache, aux


def _block_dec(cfg: ArchConfig, bp: Params, x: torch.Tensor, cache: Params,
               pos, window: int, step: Optional[L.DecodeStep] = None,
               index: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Single-token decode block. Attention caches are written in place;
    the returned dict holds every new cache entry. ``step``: the decode
    step's values shared by every layer (:func:`_step_values`); ``index``:
    the layer's, for its spans."""
    with trace.span("repro/model/attn", layer=index):
        h = L.rms_norm(bp["norm1"], x)
        new: Params = {}
        if cfg.attention == "gqa":
            y, new = L.attn_decode(bp["attn"], h, cache, pos, cfg, window,
                                   step=step)
        elif cfg.attention == "mla":
            y, new = L.mla_decode(bp["attn"], h, cache, pos, cfg, window,
                                  step=step)
        elif cfg.attention == "hybrid":
            ya, ca = L.attn_decode(bp["attn"], h,
                                   {"k": cache["k"], "v": cache["v"]}, pos,
                                   cfg, window or cfg.sliding_window,
                                   step=step)
            ym, cm = S.mamba_decode(bp["mamba"], h,
                                    {"ssm": cache["ssm"],
                                     "conv": cache["conv"]}, cfg)
            y = 0.5 * (ya + ym)
            new = {**ca, **cm}
        else:
            y, new = S.rwkv_decode(bp["rwkv"], h, cache, cfg)
        x = x + y
    with trace.span("repro/model/ffn", layer=index):
        h = L.rms_norm(bp["norm2"], x)
        if cfg.attention == "none":
            y = S.rwkv_channel_mix(bp["cmix"], h, cache["cm_shift"][:, None])
            new["cm_shift"] = h[:, 0]
        elif cfg.is_moe:
            y, _ = M.moe_ffn(bp["moe"], h, cfg)
        else:
            y = L.mlp(bp["mlp"], h, cfg)
        return x + y, new


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed(cfg: ArchConfig, params: Params, inputs: torch.Tensor
          ) -> torch.Tensor:
    if not inputs.is_floating_point():
        x = params["embed"][inputs.long()]
    else:  # frontend stub already produced embeddings
        x = inputs.to(L.dtype_of(cfg))
    return constrain(x, "batch", None, None)


def unembed(cfg: ArchConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    x = L.rms_norm(params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head, "batch", None, "model")


# ---------------------------------------------------------------------------
# Full passes (a loop over the stacked layers)
# ---------------------------------------------------------------------------


#: layers per remat group: the backward saves one residual a group, so
#: grouping halves (G=2) the saved residuals at the cost of one extra
#: in-group forward during backprop; only for deep stacks (the reference's
#: values)
REMAT_GROUP = 2
REMAT_GROUP_MIN_LAYERS = 48


def _group_seq(cfg: ArchConfig, group: List[Params], x: torch.Tensor,
               l0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A group of full-sequence blocks, the first layer ``l0``: (x, the
    sum of their aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(group):
        x, _, a = _block_seq(cfg, bp, x, window=0, index=l0 + i)
        aux = aux + a
    return x, aux


def forward_hidden(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
                   remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d) pre-norm/head, moe aux loss) —
    callers that want a memory-bounded loss apply the head per seq chunk.
    With ``remat`` and grad enabled, each group of layers is recomputed in
    the backward instead of keeping its activations."""
    x = embed(cfg, params, inputs)
    n = cfg.num_layers
    g = REMAT_GROUP if (remat and n % REMAT_GROUP == 0
                        and n >= REMAT_GROUP_MIN_LAYERS) else 1
    layers = unbind_layers(params["blocks"], n)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l0 in range(0, n, g):
        group = layers[l0:l0 + g]
        if remat and torch.is_grad_enabled():
            # the recompute runs the group under the env installed now
            x, a = checkpoint(keep_env(_group_seq), cfg, group, x, l0,
                              use_reentrant=False)
        else:
            x, a = _group_seq(cfg, group, x, l0)
        aux = aux + a
    return x, aux / n


def forward_train(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
                  remat: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V), moe aux loss)."""
    x, aux = forward_hidden(cfg, params, inputs, remat=remat)
    return unembed(cfg, params, x), aux


def prefill(cfg: ArchConfig, params: Params, inputs: torch.Tensor,
            cache_len: Optional[int] = None, window: int = 0
            ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence pass that also materialises the decode cache (stacked
    over layers, each layer's entries copied into it as they come)."""
    with trace.span("repro/model/prefill",
                    tokens=int(inputs.shape[0] * inputs.shape[1])):
        x = embed(cfg, params, inputs)
        s = x.shape[1]
        cache_len = cache_len or s
        cache: Params = {}
        for l in range(cfg.num_layers):
            x, c, _ = _block_seq(cfg, layer(params["blocks"], l), x,
                                 window=window, index=l)
            with trace.span("repro/model/cache_fill", layer=l):
                c = _pad_cache(cfg, c, cache_len, s)
                if not cache:
                    cache = {k: v.new_empty((cfg.num_layers, *v.shape))
                             for k, v in c.items()}
                for k, v in c.items():
                    cache[k][l].copy_(v)
        with trace.span("repro/model/head"):
            logits = unembed(cfg, params, x[:, -1:])
        return logits, cache


def _pad_cache(cfg: ArchConfig, cache: Params, cache_len: int,
               s: int) -> Params:
    out = {}
    for k, v in cache.items():
        if k in ("k", "v", "c_kv", "k_rope") and v.dim() >= 3 \
                and v.shape[1] == s:
            if cache_len > s:
                pad = [0, 0] * (v.dim() - 2) + [0, cache_len - s]
                v = F.pad(v, pad)
            elif cache_len < s:  # sliding window: keep the trailing window
                v = v[:, s - cache_len:]
        out[k] = v
    if cfg.kv_quant and cfg.attention == "gqa" and "k" in out:
        for name in ("k", "v"):
            q, sc = L._quantize_kv(out[name])
            out[name], out[name + "_scale"] = q, sc
    return out


def _step_values(cfg: ArchConfig, cache: Params, pos, b: int, window: int,
                 device) -> Optional[L.DecodeStep]:
    """The attention families' per-step positions, ring slots and RoPE
    table, computed once for every layer (None for RWKV)."""
    if cfg.attention in ("gqa", "hybrid"):
        w = window
        if cfg.attention == "hybrid":
            w = window or cfg.sliding_window
        return L.decode_step_values(pos, b, cache["k"].shape[2], w,
                                    cfg.head_dim, cfg.rope_theta, device)
    if cfg.attention == "mla":
        return L.decode_step_values(pos, b, cache["c_kv"].shape[2], window,
                                    cfg.rope_head_dim, cfg.rope_theta,
                                    device)
    return None


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos, window: int = 0
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B,1) integers (all families embed decoded tokens); pos an
    int, or a (B,) tensor for ragged batches.

    Each layer's new cache entries are written into ``cache[name][l]`` in
    place (the ring slot of an attention cache; the whole state of an
    SSM); the stacked cache is never copied. Returns the logits and the
    same cache dict."""
    with trace.span("repro/model/decode", slots=int(tokens.shape[0])):
        x = embed(cfg, params, tokens)
        step = _step_values(cfg, cache, pos, x.shape[0], window, x.device)
        for l in range(cfg.num_layers):
            c_l = {k: t[l] for k, t in cache.items()}
            x, new_l = _block_dec(cfg, layer(params["blocks"], l), x, c_l,
                                  pos, window, step, index=l)
            for k, v in new_l.items():
                if v.data_ptr() != c_l[k].data_ptr():
                    c_l[k].copy_(v)
        with trace.span("repro/model/head"):
            logits = unembed(cfg, params, x)
        return logits, cache


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> Params:
    """Zeroed decode cache (stacked over layers) on ``device`` (None: the
    card; ``"cpu"``)."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)
    lyr, b, c = cfg.num_layers, batch, cache_len

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)
    cache: Params = {}
    if cfg.attention in ("gqa", "hybrid"):
        kvshape = (lyr, b, c, cfg.num_kv_heads, cfg.head_dim)
        if cfg.kv_quant and cfg.attention == "gqa":
            cache["k"] = zeros(kvshape, torch.int8)
            cache["v"] = zeros(kvshape, torch.int8)
            cache["k_scale"] = zeros(kvshape[:-1], torch.float32)
            cache["v_scale"] = zeros(kvshape[:-1], torch.float32)
        else:
            cache["k"] = zeros(kvshape)
            cache["v"] = zeros(kvshape)
    if cfg.attention == "mla":
        cache["c_kv"] = zeros((lyr, b, c, cfg.kv_lora_rank))
        cache["k_rope"] = zeros((lyr, b, c, cfg.rope_head_dim))
    if cfg.attention == "none":
        h = S.rwkv_heads(cfg)
        cache["wkv"] = zeros((lyr, b, h, 64, 64), torch.float32)
        cache["shift"] = zeros((lyr, b, cfg.d_model))
        cache["cm_shift"] = zeros((lyr, b, cfg.d_model))
    if cfg.attention == "hybrid":
        di = cfg.d_model * cfg.ssm_expand
        cache["ssm"] = zeros((lyr, b, di, cfg.ssm_state), torch.float32)
        cache["conv"] = zeros((lyr, b, cfg.conv_kernel - 1, di))
    return cache
