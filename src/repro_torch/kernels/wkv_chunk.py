"""Chunked WKV (RWKV6): the recurrence of one (batch, head) pair in
chunks of ``q`` steps, the ``D x D`` state carried from chunk to chunk.

The kernel, ``csrc/wkv_chunk.cu``, runs every chunk at once: three
launches on the caller's stream, (A) each chunk's contribution to the
state, (B) the state scan, one thread per state element over the chunks,
(C) each chunk's outputs from the state it starts from. Phase C cuts a
chunk into sub-chunks of 16 steps: pairs inside one keep the pairwise
decay, blocks below them factor it at the sub-chunk's first step into two
factors of at most 1 each, a product on register tiles (the source's
header gives the argument). The workspace between the phases comes from
PyTorch's allocator (:func:`workspace_floats`); :func:`wkv_phases_plain`
mirrors the decomposition in plain PyTorch for the tests.

The counterpart of the reference's
``src/repro/kernels/wkv_chunk.py::wkv_chunk_kernel``, reached directly, as
there, with ``interpret`` replaced by ``device``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.arena_ops import resolve_device

#: Kernel launches of ``csrc/wkv_chunk.cu`` since :func:`reset_launches`;
#: the wrapper adds :data:`KERNELS_PER_CALL` where it launches them and
#: nowhere else.
LAUNCHES = 0
#: phases A, B and C, one launch each
KERNELS_PER_CALL = 3

#: the kernel's largest head width and chunk (its tiles in shared memory)
MAX_D = 64
MAX_Q = 64
#: steps of a sub-chunk in phase C
SUB = 16
#: the kernel's log-decays are in units of log2: logw times log2(e)
LOG2E = 1.4426950408889634


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


def workspace_floats(b: int, s: int, h: int, d: int, q: int) -> int:
    """Floats of the kernel's workspace: per (batch, head, chunk) the
    chunk's D x D state contribution (then the state it starts from) and
    its D decays."""
    return b * h * (s // q) * (d * d + d)


def wkv_phases_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, q: int = 64):
    """The kernel's decomposition in plain PyTorch, float32, for the tests
    (never on the card path): chunk tiles zero-padded to a multiple of
    :data:`SUB` steps, the cumulative log-decay as the kernel's segmented
    scan, phase A (each chunk's state contribution and decay), phase B
    (the state each chunk starts from, in the reference's order), phase C
    (pairwise decays inside each sub-chunk, the factored product below
    them, the cross-chunk term through E_a). Log-decays are in units of
    log2, as the kernel keeps them, and every exp2 takes an argument <= 0.
    Inputs and outputs as :func:`wkv_plain`."""
    b, s, h, d = r.shape
    n, nc = b * h, s // q
    qp = -(-q // SUB) * SUB
    na = qp // SUB

    def tiles(t):  # (n, nc, qp, d), rows past q zero
        t = t.permute(0, 2, 1, 3).reshape(n, nc, q, d)
        return F.pad(t, (0, 0, 0, qp - q))
    rr, kk, vv, ll = (tiles(t) for t in (r, k, v, logw))
    uu = u[None].expand(b, h, d).reshape(n, 1, 1, d)
    seg = (ll * LOG2E).reshape(n, nc, na, SUB, d).cumsum(3)
    off = F.pad(seg[:, :, :-1, -1], (0, 0, 1, 0)).cumsum(2)
    lwc = (seg + off[:, :, :, None]).reshape(n, nc, qp, d)
    lwp = F.pad(lwc[:, :, :-1], (0, 0, 1, 0))
    last = lwc[:, :, q - 1]                                    # (n, nc, d)

    # A: each chunk's contribution to the state, and its decay
    ds = (kk * torch.exp2(last[:, :, None] - lwc)).transpose(2, 3) @ vv
    wd = torch.exp2(last)
    # B: the state each chunk starts from
    state = torch.zeros((n, d, d), dtype=torch.float32, device=r.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = wd[:, c, :, None] * state + ds[:, c]
    sc = torch.stack(starts, 1)                                # (n,nc,d,d)
    # C: att by sub-chunk, then y = att v + (r~ E_a) S_c
    att = torch.zeros((n, nc, qp, qp), dtype=torch.float32, device=r.device)
    tq = torch.arange(SUB, device=r.device)
    below = (tq[:, None] > tq[None, :])[:, :, None]            # j < t
    ref = torch.zeros_like(lwc)                 # lwp at the sub-chunk start
    for a in range(na):
        sl = slice(a * SUB, (a + 1) * SUB)
        ra, ka = rr[:, :, sl], kk[:, :, sl]
        lr = lwp[:, :, sl, None] - lwc[:, :, None, sl]         # (n,nc,t,j,d)
        dec = torch.where(below, torch.exp2(torch.where(below, lr, 0.0)),
                          0.0)
        blk = torch.einsum("nctjd,nctd,ncjd->nctj", dec, ra, ka)
        att[:, :, sl, sl] = blk + torch.diag_embed((ra * uu * ka).sum(-1))
        if a:
            pt = lwc[:, :, a * SUB - 1]                        # lwp[s_a]
            ref[:, :, sl] = pt[:, :, None]
            kt = kk[:, :, :a * SUB] * torch.exp2(pt[:, :, None]
                                                - lwc[:, :, :a * SUB])
            rt = ra * torch.exp2(lwp[:, :, sl] - pt[:, :, None])
            att[:, :, sl, :a * SUB] = rt @ kt.transpose(2, 3)
    rx = rr * torch.exp2(lwp - ref) * torch.exp2(ref)
    y = (att @ vv + rx @ sc)[:, :, :q]
    y = y.reshape(b, h, s, d).permute(0, 2, 1, 3)
    return y.contiguous(), state.reshape(b, h, d, d)


def wkv_chunk_kernel(r, k, v, logw, u, q: int = 64, device=None):
    """r, k, v, logw: (B, S, H, D) (logw = log decay, <= 0); u: (H, D);
    tensors or arrays, cast to float32 as the reference casts them. Returns
    (y (B, S, H, D) float32, final state (B, H, D, D) float32) on
    ``device`` (None: the card, raising without one; ``"cpu"``: the plain
    version). S must be a multiple of q; on the card D and q are at most
    64. On the card it raises ``RuntimeError`` when grad is enabled and an
    input requires it: the kernel has no backward yet."""
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u)):
        # the kernel writes y and the state through ctypes, which carries
        # no autograd graph: refuse rather than drop the gradient
        raise RuntimeError(
            "wkv_chunk: no backward kernel for the chunked WKV on the card "
            "yet (csrc/wkv_chunk.cu is forward only), so it cannot train; "
            "call it under torch.no_grad() or inference_mode, or train on "
            "the CPU, whose plain version is differentiable")
    if d > MAX_D or q > MAX_Q or min(b, s, h, d) == 0:
        raise ValueError(f"wkv_chunk: the kernel takes 0 < D, q <= 64 and a "
                         f"non-empty input; got D = {d}, q = {q}, shape "
                         f"{tuple(r.shape)}")
    from repro_torch.kernels import build
    y = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    ws = torch.empty(workspace_floats(b, s, h, d, q), dtype=torch.float32,
                     device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.entry("wkv_chunk")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(), b, s, h,
        d, q, stream), "wkv_chunk")
    global LAUNCHES
    LAUNCHES += KERNELS_PER_CALL
    return y, state
