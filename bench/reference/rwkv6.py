"""Plain float32 reference of the port's RWKV6 (Finch) stack, and of its
training: the loss and gradients by autograd, AdamW as the configuration
states it.

The time mix is the port's (``configs/rwkv6-1.6b.json``, ``assumed``):
five token-shift mixes, r, k, v, g = silu and the log decay
``-exp(x Wd)``, the WKV recurrence with bonus u, the output projection;
the channel mix a squared ReLU. Norms are RMSNorm. The WKV runs in chunks
of :data:`CHUNK` steps in closed form, each decay factor a single
``exp`` of a sum of log decays that is never positive, so no factor
overflows; only the state passes from chunk to chunk in a loop. Each layer is
recomputed in the backward (``torch.utils.checkpoint``), one sequence a
pass, so a 4096-token row fits beside nothing else of the port.

``make_weights`` draws the weights the benchmark hands to both sides, in
the port's tree layout."""
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import draw, leaves

#: steps of one closed-form WKV chunk
CHUNK = 32


def make_weights(c: dict, seed: int, device, dtype=torch.float32) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    L, d = c["num_hidden_layers"], c["hidden_size"]
    ff, V = c["intermediate_size"], c["vocab_size"]

    def n(*shape, scale=0.02, shift=0.0):
        return draw(g, shape, dtype, device, scale, shift)

    def u(*shape):
        return draw(g, shape, dtype, device, kind="uniform")
    return {
        "embed": n(V, d),
        "blocks": {
            "norm1": {"scale": n(L, d, scale=0.1, shift=1.0)},
            "norm2": {"scale": n(L, d, scale=0.1, shift=1.0)},
            "rwkv": {"mu": u(L, 5, d),
                     "wr": {"w": n(L, d, d)}, "wk": {"w": n(L, d, d)},
                     "wv": {"w": n(L, d, d)},
                     "wd": {"w": n(L, d, d, scale=0.002)},
                     "wg": {"w": n(L, d, d)}, "wo": {"w": n(L, d, d)},
                     "u": n(L, d, scale=0.5)},
            "cmix": {"mu": u(L, 2, d), "wk": {"w": n(L, d, ff)},
                     "wv": {"w": n(L, ff, d)}},
        },
        "final_norm": {"scale": n(d, scale=0.1, shift=1.0)},
        "lm_head": n(d, V),
    }


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u):
    """r, k, v, logw: (B, S, H, D), u: (H, D); returns (y (B, S, H, D),
    final state (B, H, D, D)). S_t = diag(w_t) S_{t-1} + k_tᵀ v_t and
    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t), from state zero.

    Every chunk's own part is computed for all chunks at once; only the
    state carried from chunk to chunk is a loop, two small products a
    chunk. S must be a multiple of :data:`CHUNK`."""
    b, s, h, d = r.shape
    n = CHUNK
    nc = s // n

    def chunks(t):                                      # (B, H, NC, n, D)
        return t.reshape(b, nc, n, h, d).permute(0, 3, 1, 2, 4)
    r, k, v, logw = (chunks(t) for t in (r, k, v, logw))
    cum = torch.cumsum(logw, dim=3)                     # through t
    prev = cum - logw                                   # through t - 1
    lower = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)
    expo = prev[..., :, None, :] - cum[..., None, :, :]  # (.., t, s, D)
    expo = expo.masked_fill(~lower[:, :, None], float("-inf"))
    att = torch.einsum("bhctsd,bhcsd->bhcts",
                       r[..., :, None, :] * torch.exp(expo), k)
    bonus = torch.einsum("bhctd,hd,bhctd->bhct", r, u, k)
    y = torch.einsum("bhcts,bhcse->bhcte", att, v) + bonus[..., None] * v
    last = cum[..., -1, :]                              # (B, H, NC, D)
    own = torch.einsum("bhcsd,bhcse->bhcde",
                       k * torch.exp(last[..., None, :] - cum), v)
    decay = torch.exp(last)
    state = r.new_zeros(b, h, d, d)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = decay[:, :, c, :, None] * state + own[:, :, c]
    start = torch.stack(starts, dim=2)                  # (B, H, NC, D, D)
    y = y + torch.einsum("bhctd,bhcde->bhcte", r * torch.exp(prev), start)
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, d), state


def _time_mix(p, l, x):
    b, s, d = x.shape
    xp = _shift(x)
    mu = p["mu"][l]

    def mix(i):
        return x * mu[i] + xp * (1 - mu[i])
    r = mix(0) @ p["wr"]["w"][l]
    k = mix(1) @ p["wk"]["w"][l]
    v = mix(2) @ p["wv"]["w"][l]
    logw = -torch.exp(mix(3) @ p["wd"]["w"][l])
    g = F.silu(mix(4) @ p["wg"]["w"][l])
    hs = 64
    heads = d // hs
    y, _ = wkv(*(t.reshape(b, s, heads, hs) for t in (r, k, v, logw)),
               p["u"][l].reshape(heads, hs))
    return (y.reshape(b, s, d) * g) @ p["wo"]["w"][l]


def _channel_mix(p, l, x):
    mu = p["mu"][l][0]
    k = torch.relu((x * mu + _shift(x) * (1 - mu)) @ p["wk"]["w"][l])
    return (k * k) @ p["wv"]["w"][l]


def _block(w, l, x):
    b = w["blocks"]
    x = x + _time_mix(b["rwkv"], l, _rms(x, b["norm1"]["scale"][l]))
    return x + _channel_mix(b["cmix"], l, _rms(x, b["norm2"]["scale"][l]))


def loss(c: dict, w: dict, inputs: torch.Tensor, targets: torch.Tensor
         ) -> torch.Tensor:
    """Mean next-token NLL of (B, S) ``inputs`` against ``targets``, every
    layer recomputed in the backward."""
    x = w["embed"][inputs.long()]
    for l in range(c["num_hidden_layers"]):
        x = checkpoint(_block, w, l, x, use_reentrant=False)
    x = _rms(x, w["final_norm"]["scale"])
    logits = x @ w["lm_head"]
    return torch.mean(torch.logsumexp(logits, -1)
                      - logits.gather(-1, targets.long()[..., None])[..., 0])


def lr_at(opt: dict, step: int) -> float:
    """Warm-up then cosine to ``min_lr_ratio``, as the configuration
    states."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1, opt["warmup_steps"])
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["total_steps"] - opt["warmup_steps"])))
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def train(c: dict, w: dict, batches, opt: dict, steps: int):
    """``steps`` AdamW steps of ``w`` (float32 leaves, updated in place) on
    ``batches`` (each {"inputs", "targets"} (B, S), one row a pass).
    Returns (losses, the first step's clipped gradient's norm a leaf, the
    norm of each leaf's change after the steps), leaves in path order."""
    paths = [p for p, _ in leaves(w)]
    ps = [t for _, t in leaves(w)]
    start = [t.detach().clone() for t in ps]
    m = [torch.zeros_like(t) for t in ps]
    v = [torch.zeros_like(t) for t in ps]
    losses, first = [], None
    for step in range(1, steps + 1):
        batch = next(batches)
        rows = batch["inputs"].shape[0]
        grads = [torch.zeros_like(t) for t in ps]
        tot = 0.0
        for i in range(rows):
            alias = [t.detach().requires_grad_() for t in ps]
            tree = _like(w, dict(zip(paths, alias)))
            lo = loss(c, tree, batch["inputs"][i:i + 1],
                      batch["targets"][i:i + 1]) / rows
            gs = torch.autograd.grad(lo, alias)
            for a, g in zip(grads, gs):
                a.add_(g)
            tot += float(lo.detach())
            del alias, tree, gs, lo
        losses.append(tot)
        gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
        scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-9))
        lr = lr_at(opt, step)
        b1, b2 = opt["b1"], opt["b2"]
        if first is None:
            first = [float(torch.linalg.vector_norm(g)) * scale
                     for g in grads]
        with torch.no_grad():
            for p, g, mm, vv in zip(ps, grads, m, v):
                g = g * scale
                mm.mul_(b1).add_(g, alpha=1 - b1)
                vv.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mm / (1 - b1 ** step)) / (
                    torch.sqrt(vv / (1 - b2 ** step)) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
        del grads
    change = [float(torch.linalg.vector_norm(p - s0))
              for p, s0 in zip(ps, start)]
    return losses, first, change


def _like(tree, by_path, prefix=""):
    if isinstance(tree, dict):
        return {k: _like(v, by_path, f"{prefix}{k}/") for k, v in tree.items()}
    return by_path[prefix[:-1]]
