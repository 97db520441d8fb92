"""Chunked WKV (RWKV6): the recurrence of one (batch, head) pair in
chunks of ``q`` steps, the ``D x D`` state carried from chunk to chunk.

The kernel, ``csrc/wkv_chunk.cu``, follows the reference's grid: one CTA
per (batch, head) walks the chunks in order with the state in shared
memory, so r, k, v and log-w are read once and y is written once; the
``(q, q, D)`` pairwise decay tensor is never built (each pair computes its
decays on the fly, the difference of the cumulative log-decays inside one
exp).

The counterpart of the reference's
``src/repro/kernels/wkv_chunk.py::wkv_chunk_kernel``, reached directly, as
there, with ``interpret`` replaced by ``device``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.arena_ops import resolve_device

#: Launches of ``csrc/wkv_chunk.cu`` since :func:`reset_launches`; the
#: wrapper adds one where it launches the kernel and nowhere else.
LAUNCHES = 0

#: the kernel's largest head width and chunk (its tiles in shared memory)
MAX_D = 64
MAX_Q = 64


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, q: int = 64):
    """The plain PyTorch version: the reference's chunk body (its pairwise
    decay tensor included), all (batch, head) programs at once, one chunk
    at a time. Inputs as :func:`wkv_chunk_kernel` takes them, float32."""
    b, s, h, d = r.shape
    bh = b * h
    tr = lambda t: t.permute(0, 2, 1, 3).reshape(bh, s, d)  # noqa: E731
    rr, kk, vv, ll = tr(r), tr(k), tr(v), tr(logw)
    uu = u[None].expand(b, h, d).reshape(bh, d)
    tq = torch.arange(q, device=r.device)
    mask_lt = (tq[:, None] > tq[None, :])[None, :, :, None]      # j < t
    eye = (tq[:, None] == tq[None, :]).float()
    state = torch.zeros((bh, d, d), dtype=torch.float32, device=r.device)
    ys = []
    for ci in range(s // q):
        sl = slice(ci * q, (ci + 1) * q)
        rc, kc, vc, lw = rr[:, sl], kk[:, sl], vv[:, sl], ll[:, sl]
        lwc = torch.cumsum(lw, dim=1)
        lwp = torch.cat([torch.zeros_like(lwc[:, :1]), lwc[:, :-1]], dim=1)
        lr = lwp[:, :, None, :] - lwc[:, None, :, :]              # (n,t,j,d)
        dec = torch.where(mask_lt, torch.exp(lr), torch.zeros_like(lr))
        att = torch.einsum("ntjd,ntd,njd->ntj", dec, rc, kc)
        att = att + eye * torch.einsum("ntd,nd,ntd->nt", rc, uu,
                                       kc)[..., None]
        y = att @ vc + (rc * torch.exp(lwp)) @ state
        ys.append(y)
        k_dec = kc * torch.exp(lwc[:, -1:] - lwc)
        state = (torch.exp(lwc[:, -1])[..., None] * state
                 + k_dec.transpose(1, 2) @ vc)
    y = torch.cat(ys, dim=1).reshape(b, h, s, d).permute(0, 2, 1, 3)
    return y.contiguous(), state.reshape(b, h, d, d)


def wkv_chunk_kernel(r, k, v, logw, u, q: int = 64, device=None):
    """r, k, v, logw: (B, S, H, D) (logw = log decay, <= 0); u: (H, D);
    tensors or arrays, cast to float32 as the reference casts them. Returns
    (y (B, S, H, D) float32, final state (B, H, D, D) float32) on
    ``device`` (None: the card, raising without one; ``"cpu"``: the plain
    version). S must be a multiple of q; on the card D and q are at most
    64."""
    dev = resolve_device(device)
    r, k, v, logw = (torch.as_tensor(t).to(dev, torch.float32).contiguous()
                     for t in (r, k, v, logw))
    u = torch.as_tensor(u).to(dev, torch.float32).contiguous()
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv_chunk: r, k, v, logw must be one (B, S, H, D) "
                         f"shape; got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, d = r.shape
    if u.shape != (h, d):
        raise ValueError(f"wkv_chunk: u must be {(h, d)}, got "
                         f"{tuple(u.shape)}")
    if q <= 0 or s % q:
        raise ValueError(f"wkv_chunk: S = {s} is not a multiple of q = {q}")
    if dev.type == "cpu":
        return wkv_plain(r, k, v, logw, u, q)
    if d > MAX_D or q > MAX_Q or min(b, s, h, d) == 0:
        raise ValueError(f"wkv_chunk: the kernel takes 0 < D, q <= 64 and a "
                         f"non-empty input; got D = {d}, q = {q}, shape "
                         f"{tuple(r.shape)}")
    from repro_torch.kernels import build
    y = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.entry("wkv_chunk")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, d, q, stream),
        "wkv_chunk")
    global LAUNCHES
    LAUNCHES += 1
    return y, state
