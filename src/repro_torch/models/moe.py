"""Mixture-of-Experts layer: top-k router + capacity-based dispatch.

The counterpart of the reference's ``src/repro/models/moe.py``. Each
token copy is assigned a slot in its expert's capacity buffer via a
cumulative-sum position; copies beyond capacity are dropped. Expert FFNs
are one batched product over the (E, C, d) buffer. The Switch-style
auxiliary load-balancing loss is returned beside the output.

:func:`moe_ffn` takes the local dispatch, or under a runtime mesh
(``repro_torch.sharding.runtime_env``: a (data, model) mesh of processes,
``launch/mesh.py``) the expert-parallel body, the counterpart of the
reference's ``_moe_ffn_shardmap``: each data rank routes its own rows
against all E experts (GShard groups: capacity and aux per group, aux then
averaged over data), each model rank runs only its E / model experts, and
the partial outputs are summed over the model group. With ``fsdp`` the
expert leaves hold f / data of each expert and are gathered along f.

Every sum runs in an order fixed by the shapes, so a MoE model's outputs
and gradients repeat bit for bit on the card: a token's k copies are its
row repeated (an expand, whose backward sums the k copies' gradients in a
reduction), and the combine sums each token's weighted copies over k in
one reduction, in top-k order on the CPU at the configured widths
(``tests/test_torch_moe_order.py``). The reference's scatters become
``index_put_`` with distinct rows (dropped copies share the discarded pad
row) and the expert load an integer count; no floating-point
``index_add_`` remains, whose atomic adds on the card fall in no fixed
order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as SH
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
    """x: (B,S,d) -> (B,S,d), aux load-balance loss (scalar f32). Under a
    runtime mesh, x is this rank's rows and p holds its expert shards."""
    env = SH.runtime_env()
    if env is not None:
        return _moe_ffn_expert_parallel(p, x, cfg, env)
    return _moe_ffn_local(p, x, cfg)


def _route(p: Params, xf: torch.Tensor, cfg: ArchConfig):
    """The router over xf (T,d): (gate weights (T,k), expert of each copy
    (T,k), aux loss, keep (T*k,), each copy's buffer row (T*k,),
    capacity). A kept copy's row is its expert's next free slot; a
    dropped copy's is the pad row ``E * C``."""
    t = xf.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = (xf @ p["router"]["w"].to(xf.dtype)).float()            # (T,E)
    probs = torch.softmax(logits, dim=-1)
    # sorted top-k, as jax.lax.top_k (ties to the lower index; random
    # inputs have none)
    gate_w, gate_i = torch.topk(probs, k, dim=-1, sorted=True)       # (T,k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # slot assignment: position of each copy within its expert, by cumsum
    flat_e = gate_i.reshape(t * k)                                   # (T*k,)
    onehot = F.one_hot(flat_e, e)                                    # (T*k,E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    cap = _capacity(t, cfg)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))            # drop row

    # Switch aux loss: E * mean(importance) . mean(load); the load an
    # integer count of each expert's copies
    importance = probs.mean(0)                                       # (E,)
    load = onehot.sum(0).float() / (t * k)
    aux = e * torch.sum(importance * load)
    return gate_w, gate_i, aux, keep, dest, cap


def _experts(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The expert FFNs, one batched product over (E,C,d) -> (E,C,d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    return torch.einsum("ecf,efd->ecd", h, p["w_down"])


def _moe_ffn_local(p: Params, x: torch.Tensor, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    gate_w, _, aux, keep, dest, cap = _route(p, xf, cfg)

    # dispatch: (E*C, d) buffer of token copies (pad row at the end); the
    # copies are each token's row repeated k times
    copies = xf[:, None].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((dest,), copies)
    y_exp = _experts(p, buf[:e * cap].reshape(e, cap, d))             # (E,C,d)

    # combine: gather each copy's expert output, weight, sum each token's
    # k copies in one reduction
    y_flat = y_exp.reshape(e * cap, d)
    y_copy = torch.where(keep[:, None],
                         y_flat[torch.clamp(dest, max=e * cap - 1)],
                         torch.zeros((), dtype=y_flat.dtype, device=x.device))
    w_copy = (gate_w.reshape(t * k) * keep).to(x.dtype)
    out = (y_copy * w_copy[:, None]).reshape(t, k, d).sum(1)
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Expert-parallel path
# ---------------------------------------------------------------------------


def _moe_ffn_expert_parallel(p: Params, x: torch.Tensor, cfg: ArchConfig,
                             env: SH.AxisEnv
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ffn_shardmap`` on this rank: route the rows
    in hand against all E experts (the router replicated), keep only the
    copies bound for this model rank's experts, run them and sum the
    partial outputs over the model group in ascending index. The rows are
    split over ``env.batch``; a batch the data axis does not divide is
    run whole on every rank under ``sharding.replicated_rows()`` (no batch
    axes: aux is not averaged), as the reference replicates it.

    The backward: the dispatched rows and the gate weights enter the
    local-expert region through ``sharding.enter`` (their cotangents are
    summed over the model group), so every model rank ends with the whole
    gradient of x and of the router, and aux counts once. Under grad the
    body is checkpointed, as the reference's (its collectives run again,
    in the same order on every rank, in the backward)."""
    mesh, model = env.mesh, env.model
    e_loc = cfg.num_experts // mesh.shape[model]
    e0 = mesh.index(model) * e_loc

    def body(router_w, wg, wu, wd, xl):
        bl, sl, d = xl.shape
        t, k = bl * sl, cfg.experts_per_token
        xf = xl.reshape(t, d)
        if env.fsdp:  # gather the FSDP-split expert dims
            wg = SH.gather_last(wg, mesh, "data")
            wu = SH.gather_last(wu, mesh, "data")
            wd = SH.gather_last(wd.transpose(1, 2), mesh, "data"
                                ).transpose(1, 2)
        gate_w, gate_i, aux, keep, dest, cap = _route(
            {"router": {"w": router_w}}, xf, cfg)
        for ax in env.batch:   # none where the rows are replicated
            aux = SH.pmean(aux, mesh, ax)
        flat_e = gate_i.reshape(t * k)
        local = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
        dest = torch.where(local, dest - e0 * cap,
                           torch.full_like(dest, e_loc * cap))

        xin = SH.enter(xf, mesh, model)
        copies = xin[:, None].expand(t, k, d).reshape(t * k, d)
        buf = torch.zeros((e_loc * cap + 1, d), dtype=xl.dtype,
                          device=xl.device)
        buf.index_put_((dest,), copies)
        y_exp = _experts({"w_gate": wg, "w_up": wu, "w_down": wd},
                         buf[:e_loc * cap].reshape(e_loc, cap, d))
        y_flat = y_exp.reshape(e_loc * cap, d)
        y_copy = torch.where(local[:, None],
                             y_flat[torch.clamp(dest, max=e_loc * cap - 1)],
                             torch.zeros((), dtype=y_flat.dtype,
                                         device=xl.device))
        w_copy = (SH.enter(gate_w, mesh, model).reshape(t * k)
                  * local).to(xl.dtype)
        part = (y_copy * w_copy[:, None]).reshape(t, k, d).sum(1)
        return SH.psum(part, mesh, model).reshape(bl, sl, d), aux

    args = (p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"], x)
    if torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)
