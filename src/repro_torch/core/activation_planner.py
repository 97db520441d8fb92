"""DMO applied to the assigned architectures' layer graphs.

For each arch we build the tensor-op graph of ONE decoder block at a given
(batch, seq) — the repeating memory unit of a microcontroller-style
sequential execution — and plan its activation arena with and without
diagonal overlap. This is the paper's technique carried to the transformer
substrate: elementwise chains (norm scales, activations, residual adds) are
the ``O_s = |out|`` diagonal case, matmuls are ``O_s = 0`` barriers, and the
planner packs around them.

(The 6ND matmuls dominate transformer FLOPs, but the *activation arena* is
what bounds deployability on small devices — same argument as the paper.)
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core import pipeline
from repro_torch.core.graph import Graph, Tensor
from repro_torch.core.planner import Plan
from repro_torch.models.config import ArchConfig


def block_graph(cfg: ArchConfig, batch: int = 1, seq: int = 128,
                dtype_bytes: int = 2) -> Graph:
    """One decoder block as a tensor-op graph (activations only)."""
    g = Graph(f"{cfg.name}_block")
    t = batch * seq
    d = cfg.d_model
    x = g.tensor("x", (t, d), dtype_bytes, "input")

    def fc(inp: Tensor, width: int, name: str) -> Tensor:
        return g.op("fully_connected", [inp], (t, width), name=name)

    def ew(inp, name, fn="relu", other=None):
        ins = [inp] if other is None else [inp, other]
        return g.op("elementwise", ins, inp.shape, dict(fn=fn), name=name)

    n1 = ew(x, "norm1", "identity")
    if cfg.attention in ("gqa", "hybrid"):
        q = fc(n1, cfg.q_dim, "wq")
        k = fc(n1, cfg.kv_dim, "wk")
        v = fc(n1, cfg.kv_dim, "wv")
        att = g.op("custom", [q, k, v], (t, cfg.q_dim), name="attention")
        y = fc(att, d, "wo")
    elif cfg.attention == "mla":
        ql = fc(n1, cfg.q_lora_rank, "wq_a")
        q = fc(ew(ql, "q_norm", "identity"),
               cfg.num_heads * (cfg.head_dim + cfg.rope_head_dim), "wq_b")
        kv = fc(n1, cfg.kv_lora_rank + cfg.rope_head_dim, "wkv_a")
        kup = fc(kv, cfg.num_heads * cfg.head_dim, "wk_b")
        vup = fc(kv, cfg.num_heads * (cfg.v_head_dim or cfg.head_dim), "wv_b")
        att = g.op("custom", [q, kup, vup],
                   (t, cfg.num_heads * (cfg.v_head_dim or cfg.head_dim)),
                   name="attention")
        y = fc(att, d, "wo")
    else:  # rwkv time mix
        r = fc(n1, d, "wr")
        k = fc(n1, d, "wk")
        v = fc(n1, d, "wv")
        wkv = g.op("custom", [r, k, v], (t, d), name="wkv_scan")
        y = fc(ew(wkv, "gate", "sigmoid"), d, "wo")
    if cfg.attention == "hybrid":
        xz = fc(n1, 2 * d * cfg.ssm_expand, "mamba_in")
        ssm = g.op("custom", [xz], (t, d * cfg.ssm_expand), name="ssm_scan")
        ym = fc(ssm, d, "mamba_out")
        y = ew(y, "merge", "add", ym)
    x2 = ew(x, "res1", "add", y)

    n2 = ew(x2, "norm2", "identity")
    if cfg.is_moe:
        router = fc(n2, cfg.num_experts, "router")
        # per-token expert compute at top-k width (capacity view)
        up = fc(n2, cfg.experts_per_token * cfg.moe_d_ff, "experts_up")
        gate = fc(n2, cfg.experts_per_token * cfg.moe_d_ff, "experts_gate")
        h = ew(up, "silu_mul", "mul", gate)
        down = fc(h, d, "experts_down")
        y2 = g.op("custom", [down, router], (t, d), name="combine")
    else:
        up = fc(n2, cfg.d_ff, "w_up")
        if cfg.activation == "silu":
            gate = fc(n2, cfg.d_ff, "w_gate")
            h = ew(up, "act", "mul", gate)
        else:
            h = ew(up, "act", "relu")
        y2 = fc(h, d, "w_down")
    g.op("elementwise", [x2, y2], (t, d), dict(fn="add"), name="res2",
         out_kind="output")
    g.validate()
    return g


def plan_block(cfg: ArchConfig, batch: int = 1, seq: int = 128,
               dtype_bytes: int = 2) -> Tuple[Plan, Plan]:
    """(original, dmo) plans of one block's activation arena, via the
    unified compile pipeline (cached per graph signature)."""
    g = block_graph(cfg, batch, seq, dtype_bytes)
    compiled = pipeline.compile(g, profile="paper", method="algorithmic")
    return compiled.baseline, compiled.plan


def compile_block(cfg: ArchConfig, batch: int = 1, seq: int = 128,
                  dtype_bytes: int = 2, profile: str = "paper",
                  method: str = "algorithmic",
                  **kwargs) -> "pipeline.CompiledPlan":
    """Full pipeline result (pass log, provenance, report) for one block."""
    g = block_graph(cfg, batch, seq, dtype_bytes)
    return pipeline.compile(g, profile=profile, method=method, **kwargs)
