"""Plain float32 reference of a Qwen2 decoder: RMSNorm, GQA with QKV bias
and RoPE (rotate-half), SwiGLU MLP, and the output head: the embedding's
transpose where the configuration ties them. It runs one
sequence at a time over the whole prompt and its served tokens, layer by
layer, with causal attention in blocks of queries so that a 16k-token
sequence fits beside the port's weights.

``make_weights`` draws the weights the benchmark hands to both sides, in
the port's tree layout (stacked over layers, ``x @ w`` orientation)."""
import math

import torch
import torch.nn.functional as F

from bench.reference import draw, fp8

#: queries a block of attention
Q_BLOCK = 1024


def head_dim(c: dict) -> int:
    return c["hidden_size"] // c["num_attention_heads"]


def make_weights(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Weights from ``seed`` on ``device`` in ``dtype``: one draw a stacked
    leaf, in a fixed order."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    L, d = c["num_hidden_layers"], c["hidden_size"]
    ff, V = c["intermediate_size"], c["vocab_size"]
    q = c["num_attention_heads"] * head_dim(c)
    kv = c["num_key_value_heads"] * head_dim(c)

    def n(*shape, scale=0.02, shift=0.0):
        return draw(g, shape, dtype, device, scale, shift)
    w = {
        "embed": n(V, d),
        "blocks": {
            "norm1": {"scale": n(L, d, scale=0.1, shift=1.0)},
            "norm2": {"scale": n(L, d, scale=0.1, shift=1.0)},
            "attn": {"wq": {"w": n(L, d, q), "b": n(L, q)},
                     "wk": {"w": n(L, d, kv), "b": n(L, kv)},
                     "wv": {"w": n(L, d, kv), "b": n(L, kv)},
                     "wo": {"w": n(L, q, d)}},
            "mlp": {"w_gate": {"w": n(L, d, ff)},
                    "w_up": {"w": n(L, d, ff)},
                    "w_down": {"w": n(L, ff, d)}},
        },
        "final_norm": {"scale": n(d, scale=0.1, shift=1.0)},
    }
    if not c["tie_word_embeddings"]:
        w["lm_head"] = n(d, V)
    return w


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _linear(x, w, b=None, low=False):
    w = w.float()
    if low:
        x, w = fp8(x, -1), fp8(w, 0)
    y = x @ w
    return y if b is None else y + b.float()


def _rope(x, pos, theta):
    """x: (S, H, D); rotate-half RoPE at positions ``pos`` (S,)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float64) / d)
    ang = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attention(q, k, v, low=False):
    """Causal attention, q: (S, H, D), k, v: (S, KV, D), f32, queries in
    blocks of :data:`Q_BLOCK`; ``low``: both products with float8
    operands."""
    s, h, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    out = torch.empty_like(q)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        qb = q[q0:q1].reshape(q1 - q0, kvh, g, d)
        kb, vb = k[:q1], v[:q1]
        if low:
            qb, kb, vb = fp8(qb, -1), fp8(kb, -1), fp8(vb, 0)
        sc = torch.einsum("qkgd,tkd->kgqt", qb, kb) / math.sqrt(d)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(q1, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        if low:
            p = fp8(p, -1)
        ob = torch.einsum("kgqt,tkd->qkgd", p, vb)
        out[q0:q1] = ob.reshape(q1 - q0, h, d)
    return out


@torch.no_grad()
def logits_at(c: dict, w: dict, tokens: torch.Tensor, at: torch.Tensor,
              low: bool = False) -> torch.Tensor:
    """Float32 logits (len(at), V) of the sequence ``tokens`` (S,) at the
    positions ``at``. ``low``: the control, every matrix product (the
    projections, attention's two, the MLP and the head) with float8 e4m3
    operands, one scale a row of the left operand and a column of the
    right."""
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    h, kvh, d = (c["num_attention_heads"], c["num_key_value_heads"],
                 head_dim(c))
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    x = w["embed"][tokens].float()
    b = w["blocks"]
    for l in range(c["num_hidden_layers"]):
        a, m = b["attn"], b["mlp"]
        y = _rms(x, b["norm1"]["scale"][l], eps)
        q = _linear(y, a["wq"]["w"][l], a["wq"]["b"][l], low)
        k = _linear(y, a["wk"]["w"][l], a["wk"]["b"][l], low)
        v = _linear(y, a["wv"]["w"][l], a["wv"]["b"][l], low)
        q = _rope(q.reshape(s, h, d), pos, theta)
        k = _rope(k.reshape(s, kvh, d), pos, theta)
        o = _attention(q, k, v.reshape(s, kvh, d), low).reshape(s, h * d)
        del q, k, v
        x = x + _linear(o, a["wo"]["w"][l], None, low)
        y = _rms(x, b["norm2"]["scale"][l], eps)
        gate = F.silu(_linear(y, m["w_gate"]["w"][l], None, low))
        up = _linear(y, m["w_up"]["w"][l], None, low)
        x = x + _linear(gate * up, m["w_down"]["w"][l], None, low)
        del gate, up, y
    y = _rms(x[at], w["final_norm"]["scale"], eps)
    head = w["embed"].T if c["tie_word_embeddings"] else w["lm_head"]
    return _linear(y, head, None, low)
