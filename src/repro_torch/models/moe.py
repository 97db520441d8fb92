"""Mixture-of-Experts layer: top-k router + capacity-based dispatch.

The counterpart of the reference's ``src/repro/models/moe.py``, its local
dispatch only. Each token copy is assigned a slot in its expert's capacity
buffer via a cumulative-sum position; copies beyond capacity are dropped.
Expert FFNs are one batched product over the (E, C, d) buffer. The
Switch-style auxiliary load-balancing loss is returned beside the output.

The reference's expert-parallel ``shard_map`` path (taken under an
installed mesh, ``repro.sharding.current_env``) waits for the port's mesh
tooling: one card has no mesh, so :func:`moe_ffn` is always the local
dispatch. The reference's scatters become ``index_put_`` and
``index_add_``; on the card ``index_add_`` adds in no fixed order, so MoE
outputs there may differ in their last bits between runs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, dtype_of, randn

Params = Dict[str, torch.Tensor]


def moe_init(cfg: ArchConfig, gen: torch.Generator, device) -> Params:
    dt = dtype_of(cfg)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    s = 0.02
    return {
        "router": dense_init(gen, d, e, torch.float32, device),
        "w_gate": randn(gen, (e, d, f), dt, device, s),
        "w_up": randn(gen, (e, d, f), dt, device, s),
        "w_down": randn(gen, (e, f, d), dt, device, s),
    }


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    c = int(tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(cfg.experts_per_token, c)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (B,S,d), aux load-balance loss (scalar f32)."""
    return _moe_ffn_local(p, x, cfg)


def _moe_ffn_local(p: Params, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)

    logits = (xf @ p["router"]["w"].to(xf.dtype)).float()            # (T,E)
    probs = torch.softmax(logits, dim=-1)
    # sorted top-k, as jax.lax.top_k (ties to the lower index; random
    # inputs have none)
    gate_w, gate_i = torch.topk(probs, k, dim=-1, sorted=True)       # (T,k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * mean(importance) . mean(load)
    importance = probs.mean(0)                                       # (E,)
    load = torch.zeros((e,), device=dev).index_add_(
        0, gate_i.reshape(-1), torch.ones((t * k,), device=dev)) / (t * k)
    aux = e * torch.sum(importance * load)

    # slot assignment: position of each copy within its expert, by cumsum
    flat_e = gate_i.reshape(t * k)                                   # (T*k,)
    onehot = F.one_hot(flat_e, e)                                    # (T*k,E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    cap = _capacity(t, cfg)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))            # drop row

    # dispatch: (E*C, d) buffer of token copies (pad row at the end)
    token_row = torch.arange(t, device=dev).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((dest,), xf[token_row])
    expert_in = buf[:e * cap].reshape(e, cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    y_exp = torch.einsum("ecf,efd->ecd", h, p["w_down"])              # (E,C,d)

    # combine: gather each copy's expert output, weight, sum per token
    y_flat = y_exp.reshape(e * cap, d)
    y_copy = torch.where(keep[:, None],
                         y_flat[torch.clamp(dest, max=e * cap - 1)],
                         torch.zeros((), dtype=y_flat.dtype, device=dev))
    w_copy = (gate_w.reshape(t * k) * keep).to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, token_row, y_copy * w_copy[:, None])
    return out.reshape(b, s, d), aux
