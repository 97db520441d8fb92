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

**Training.** Where grad is enabled and an input requires it, the call
goes through :class:`WkvChunk`, an autograd Function: its forward keeps
the inputs and the forward's workspace (the state each chunk starts from,
34 MB a call at rwkv6-1.6b's microbatch, freed with the layer's saved
tensors), and its backward is ``csrc/wkv_chunk_bwd.cu`` on the card (four
launches: each chunk's part of the state's gradient, a reverse state
scan, each chunk's gradients, the du sum) and :func:`wkv_backward_plain`
on the CPU; :func:`wkv_backward_phases_plain` mirrors the kernel's
phases. The reference differentiates its chunked form through XLA and
never its Pallas kernel; the port's RWKV trains through this kernel.

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
#: Kernel launches of ``csrc/wkv_chunk_bwd.cu`` since
#: :func:`reset_launches`: :data:`BWD_KERNELS_PER_CALL` a backward call
#: (phases A', B', C' and the du sum), added where they launch.
BWD_LAUNCHES = 0
BWD_KERNELS_PER_CALL = 4
#: the backward's kernels in launch order (phases A', B', C', D')
BWD_KERNELS = ("grad_parts", "grad_scan", "chunk_grads", "du_sum")

#: the kernel's largest head width and chunk (its tiles in shared memory)
MAX_D = 64
MAX_Q = 64
#: steps of a sub-chunk in phase C
SUB = 16
#: the kernel's log-decays are in units of log2: logw times log2(e)
LOG2E = 1.4426950408889634


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0


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


def _phase_tiles(q: int, *ts):
    """Per-chunk tiles (n, nc, qp, d) of (B, S, H, D) tensors, rows past q
    zero, as the kernel holds them in shared memory."""
    b, s, h, d = ts[0].shape
    qp = -(-q // SUB) * SUB
    return [F.pad(t.permute(0, 2, 1, 3).reshape(b * h, s // q, q, d),
                  (0, 0, 0, qp - q)) for t in ts]


def _log2_scan(ll: torch.Tensor, q: int):
    """The kernel's segmented scan of a logw tile (n, nc, qp, d): lwc in
    units of log2 (16-step segments, each offset by the totals before it),
    lwp (lwc one step earlier, 0 at the first) and the chunk's last lwc."""
    n, nc, qp, d = ll.shape
    seg = (ll * LOG2E).reshape(n, nc, qp // SUB, SUB, d).cumsum(3)
    off = F.pad(seg[:, :, :-1, -1], (0, 0, 1, 0)).cumsum(2)
    lwc = (seg + off[:, :, :, None]).reshape(n, nc, qp, d)
    return lwc, F.pad(lwc[:, :, :-1], (0, 0, 1, 0)), lwc[:, :, q - 1]


def _state_starts(kk, vv, lwc, last):
    """Phases A and B: each chunk's state contribution and decay wd, the
    state each chunk starts from (n, nc, d, d), in the reference's order,
    and the final state."""
    ds = (kk * torch.exp2(last[:, :, None] - lwc)).transpose(2, 3) @ vv
    wd = torch.exp2(last)
    n, nc, d = wd.shape
    state = torch.zeros((n, d, d), dtype=torch.float32, device=kk.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = wd[:, c, :, None] * state + ds[:, c]
    return torch.stack(starts, 1), state, wd


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
    rr, kk, vv, ll = _phase_tiles(q, r, k, v, logw)
    qp = rr.shape[2]
    na = qp // SUB
    uu = u[None].expand(b, h, d).reshape(n, 1, 1, d)
    lwc, lwp, last = _log2_scan(ll, q)
    sc, state, _ = _state_starts(kk, vv, lwc, last)
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


def _grad_inputs(r, dy, dstate, zero_state: bool = True):
    """dy and the final state's gradient as contiguous float32 tensors of
    r's shape and (B, H, D, D), zeros where autograd passes none; a None
    ``dstate`` stays None when ``zero_state`` is false (the card's null
    pointer). A wrong shape raises."""
    b, s, h, d = r.shape
    if dy is None:
        dy = torch.zeros_like(r)
    if dy.shape != r.shape:
        raise ValueError(f"wkv_chunk: dy must be {tuple(r.shape)}, got "
                         f"{tuple(dy.shape)}")
    if dstate is None:
        if not zero_state:
            return dy.float().contiguous(), None
        dstate = torch.zeros((b, h, d, d), dtype=torch.float32,
                             device=r.device)
    if dstate.shape != (b, h, d, d):
        raise ValueError(f"wkv_chunk: the state's gradient must be "
                         f"{(b, h, d, d)}, got {tuple(dstate.shape)}")
    return dy.float().contiguous(), dstate.float().contiguous()


def wkv_backward_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       logw: torch.Tensor, u: torch.Tensor, dy, dstate,
                       q: int = 64):
    """The gradients of :func:`wkv_plain`'s (y, final state) from explicit
    formulas, float32, natural logs: ``(dr, dk, dv, dlogw, du)`` for the
    output gradient ``dy`` (B, S, H, D) and the final state's ``dstate``
    (B, H, D, D) (either None: zeros). Chunk by chunk, with S_c the state
    a chunk starts from and G_c the gradient of the state it ends with
    (G = dstate for the last chunk, G_{c-1} = w_c G_c + (r e^lwp)^T dy):

    - dv = att^T dy + k_dec G_c, datt[t, j] = dy_t . v_j (j <= t);
    - dr = sum_{j<t} datt[t, j] k_j e^(lwp_t - lwc_j) + e^lwp_t (S_c dy_t)
      (together d^r, the part through lwp) plus the u term datt[t, t] u k_t;
    - dk = sum_{t>j} datt[t, j] r_t e^(lwp_t - lwc_j) + e^(lwc_{q-1} -
      lwc_j) (G_c v_j) (d^k, the part through -lwc_j) plus datt[j, j] r_j u;
    - du = sum over the batch and the steps of datt[t, t] r_t k_t;
    - dlogw: inside a chunk y and the state it ends with depend on logw
      only through the chunk's cumulative sums, so the gradient of lwc_j
      is r_{j+1} d^r_{j+1} (j + 1 in the chunk) - k_j d^k_j, plus at the
      chunk's last step sum_j k_j e^(lwc_{q-1} - lwc_j) (G_c v_j) and
      e^lwc_{q-1} sum_e G_c S_c; dlogw is its reverse cumulative sum over
      the chunk. No carry between chunks.

    Every exp takes an argument <= 0. The sums run in float64 and the
    results are float32: dw = dlogw / w on the way to the decay's
    projection magnifies dlogw's rounding where w is small, and float32
    sums leave about 1e-5 of the leaf's largest entry there (the
    reference's own float32 gradient 2e-5 to 6e-5). For the tests and
    ``chip_smoke.py`` (and the CPU's backward); never on the card path."""
    dy, dstate = _grad_inputs(r, dy, dstate)
    b, s, h, d = r.shape
    n, nc = b * h, s // q
    tr = lambda t: t.permute(0, 2, 1, 3).reshape(n, s, d)  # noqa: E731
    rr, kk, vv, ll, gy = (tr(t.double()) for t in (r, k, v, logw, dy))
    uu = u.double()[None].expand(b, h, d).reshape(n, 1, d)
    tq = torch.arange(q, device=r.device)
    mask_lt = (tq[:, None] > tq[None, :])[None, :, :, None]      # j < t
    chunks = []
    state = torch.zeros((n, d, d), dtype=torch.float64, device=r.device)
    starts = []
    for ci in range(nc):
        sl = slice(ci * q, (ci + 1) * q)
        lwc = torch.cumsum(ll[:, sl], dim=1)
        lwp = F.pad(lwc[:, :-1], (0, 0, 1, 0))
        fk = torch.exp(lwc[:, -1:] - lwc)                         # (n,q,d)
        chunks.append((sl, lwc, lwp, fk))
        starts.append(state)
        state = (torch.exp(lwc[:, -1])[..., None] * state
                 + (kk[:, sl] * fk).transpose(1, 2) @ vv[:, sl])
    g = dstate.reshape(n, d, d).double()
    ends = [None] * nc
    for ci in reversed(range(nc)):
        sl, lwc, lwp, _ = chunks[ci]
        ends[ci] = g
        g = (torch.exp(lwc[:, -1])[..., None] * g
             + (rr[:, sl] * torch.exp(lwp)).transpose(1, 2) @ gy[:, sl])
    dr, dk, dv, dl = (torch.empty_like(rr) for _ in range(4))
    du = torch.zeros((n, d), dtype=torch.float64, device=r.device)
    for ci, (sl, lwc, lwp, fk) in enumerate(chunks):
        rc, kc, vc, gc = rr[:, sl], kk[:, sl], vv[:, sl], gy[:, sl]
        sc, ge = starts[ci], ends[ci]
        lr = lwp[:, :, None, :] - lwc[:, None, :, :]              # (n,t,j,d)
        dec = torch.where(mask_lt, torch.exp(torch.where(mask_lt, lr, 0.0)),
                          0.0)
        att = torch.einsum("ntjd,ntd,njd->ntj", dec, rc, kc)
        dd = (gc * vc).sum(-1)                                    # datt[t, t]
        att = att + torch.diag_embed((rc * uu * kc).sum(-1))
        datt = torch.where(mask_lt[..., 0], gc @ vc.transpose(1, 2), 0.0)
        dv[:, sl] = att.transpose(1, 2) @ gc + (kc * fk) @ ge
        drh = (torch.einsum("ntj,ntjd,njd->ntd", datt, dec, kc)
               + torch.exp(lwp) * (gc @ sc.transpose(1, 2)))
        dks = fk * (vc @ ge.transpose(1, 2))
        dkh = torch.einsum("ntj,ntjd,ntd->njd", datt, dec, rc) + dks
        dr[:, sl] = drh + dd[..., None] * uu * kc
        dk[:, sl] = dkh + dd[..., None] * rc * uu
        du += (dd[..., None] * rc * kc).sum(1)
        dlwc = -kc * dkh
        dlwc[:, :-1] += rc[:, 1:] * drh[:, 1:]
        dlwc[:, -1] += ((kc * dks).sum(1)
                        + torch.exp(lwc[:, -1]) * (ge * sc).sum(-1))
        dl[:, sl] = dlwc.flip(1).cumsum(1).flip(1)
    back = lambda t: (t.reshape(b, h, s, d).permute(0, 2, 1, 3)  # noqa: E731
                      .float().contiguous())
    return (back(dr), back(dk), back(dv), back(dl),
            du.reshape(b, h, d).sum(0).float())


def wkv_backward_phases_plain(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, logw: torch.Tensor,
                              u: torch.Tensor, dy, dstate, q: int = 64):
    """The backward kernel's decomposition in plain PyTorch, float32, for
    the tests (never on the card path), as :func:`wkv_phases_plain`
    mirrors the forward: the tiles and the log2 scan of the forward, the
    states S_c of its phases A and B (the workspace the forward keeps),
    then A' (each chunk's part of the state's gradient, (r 2^lwp)^T dy),
    B' (the reverse scan G_{c-1} = w_c G_c + A'_c from dstate), C' and D'
    (du summed over the batch, then the chunks, in order). C' cuts the
    chunk into sub-chunks of :data:`SUB` steps, as the forward's phase C:

    - the factors, once a chunk: r~ = r 2^(lwp - ref_a) (ref_a = lwc at
      the step before sub-chunk a, 0 for the first), k's decay 2^(last -
      lwc), k~_a = k 2^(ref_a - lwc) on the rows before sub-chunk a and
      E_a = 2^ref_a;
    - att: pairwise inside each sub-chunk (u on the diagonal), r~_a
      k~_a^T below it; datt = dy v^T;
    - dv = att^T dy + (k 2^(last - lwc)) G_c;
    - d^r = 2^(lwp - ref_a) (E_a (dy S_c^T) + datt[:, :s_a] k~_a) plus the
      sub-chunk's pairs;
    - d^k = 2^(last - lwc) (v G_c^T) + sum over the later sub-chunks a of
      2^(ref_a - lwc) (datt[s_a.., :]^T r~_a) plus the sub-chunk's pairs;
    - the gradient of lwc and its reverse cumulative sum into dlogw, each
      chunk's share of du, as the header of ``csrc/wkv_chunk_bwd.cu``
      gives them.

    Log-decays are in units of log2, as the kernel keeps them, and every
    exp2 takes an argument <= 0. Inputs and outputs as
    :func:`wkv_backward_plain`."""
    dy, dstate = _grad_inputs(r, dy, dstate)
    b, s, h, d = r.shape
    n, nc = b * h, s // q
    rr, kk, vv, ll, gy = _phase_tiles(q, r, k, v, logw, dy)
    qp = rr.shape[2]
    na = qp // SUB
    uu = u[None].expand(b, h, d).reshape(n, 1, 1, d)
    lwc, lwp, last = _log2_scan(ll, q)
    sc, _, wd = _state_starts(kk, vv, lwc, last)
    # A': each chunk's part of the state's gradient
    gp = (rr * torch.exp2(lwp)).transpose(2, 3) @ gy
    # B': the gradient of the state each chunk ends with
    g = dstate.reshape(n, d, d)
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = g
        g = wd[:, c, :, None] * g + gp[:, c]
    ge = torch.stack(ends, 1)
    # C': the factors, one exp2 each, every argument <= 0
    ref = torch.zeros_like(lwc)
    for a in range(1, na):
        ref[:, :, a * SUB:(a + 1) * SUB] = lwc[:, :, a * SUB - 1, None]
    fr = torch.exp2(lwp - ref)                                 # r~ / r
    rt = rr * fr
    kd = torch.exp2(last[:, :, None] - lwc)                    # k's decay
    ea = torch.exp2(ref)                                       # E_a by row
    kt = [None] + [kk[:, :, :a * SUB] * torch.exp2(
        lwc[:, :, a * SUB - 1, None] - lwc[:, :, :a * SUB])
        for a in range(1, na)]
    # att and datt; the pairwise decays inside each sub-chunk
    tq = torch.arange(SUB, device=r.device)
    below = (tq[:, None] > tq[None, :])[:, :, None]            # j < t
    att = torch.zeros((n, nc, qp, qp), dtype=torch.float32, device=r.device)
    decs = []
    for a in range(na):
        sl = slice(a * SUB, (a + 1) * SUB)
        ra, ka = rr[:, :, sl], kk[:, :, sl]
        lr = lwp[:, :, sl, None] - lwc[:, :, None, sl]         # (n,nc,t,j,d)
        dec = torch.where(below, torch.exp2(torch.where(below, lr, 0.0)),
                          0.0)
        decs.append(dec)
        att[:, :, sl, sl] = (torch.einsum("nctjd,nctd,ncjd->nctj", dec, ra,
                                          ka)
                             + torch.diag_embed((ra * uu * ka).sum(-1)))
        if a:
            att[:, :, sl, :a * SUB] = rt[:, :, sl] @ kt[a].transpose(2, 3)
    dfull = gy @ vv.transpose(2, 3)
    tqp = torch.arange(qp, device=r.device)
    dlow = torch.where(tqp[:, None] > tqp[None, :], dfull, 0.0)
    dd = dfull.diagonal(0, 2, 3)
    dv = att.transpose(2, 3) @ gy + (kk * kd) @ ge
    # d^r and d^k, less their u terms
    q1 = gy @ sc.transpose(2, 3)                               # S_c dy_t
    dks = kd * (vv @ ge.transpose(2, 3))                       # its state part
    drh = torch.empty_like(rr)
    dkh = dks.clone()
    for a in range(na):
        sl = slice(a * SUB, (a + 1) * SUB)
        part = ea[:, :, sl] * q1[:, :, sl]
        if a:
            part = part + dlow[:, :, sl, :a * SUB] @ kt[a]
            dkh[:, :, :a * SUB] += torch.exp2(
                lwc[:, :, a * SUB - 1, None] - lwc[:, :, :a * SUB]) * (
                dlow[:, :, sl, :a * SUB].transpose(2, 3) @ rt[:, :, sl])
        dl_a = dlow[:, :, sl, sl]
        drh[:, :, sl] = fr[:, :, sl] * part + torch.einsum(
            "nctj,nctjd,ncjd->nctd", dl_a, decs[a], kk[:, :, sl])
        dkh[:, :, sl] += torch.einsum("nctj,nctjd,nctd->ncjd", dl_a, decs[a],
                                      rr[:, :, sl])
    dr = drh + dd[..., None] * uu * kk
    dk = dkh + dd[..., None] * rr * uu
    dlwc = -kk * dkh
    dlwc[:, :, :-1] += rr[:, :, 1:] * drh[:, :, 1:]
    dlwc[:, :, q - 1] += ((kk * dks).sum(2)
                          + torch.exp2(last) * (ge * sc).sum(-1))
    dl = dlwc[:, :, :q].flip(2).cumsum(2).flip(2)
    # D': du over the batch, then the chunks, in order
    dup = (dd[..., None] * rr * kk).sum(2).reshape(b, h, nc, d)
    du = torch.zeros((h, d), dtype=torch.float32, device=r.device)
    for bi in range(b):
        for c in range(nc):
            du = du + dup[bi, :, c]
    back = lambda t: (t[:, :, :q].reshape(b, h, s, d)  # noqa: E731
                      .permute(0, 2, 1, 3).contiguous())
    return back(dr), back(dk), back(dv), back(dl), du


def _check_args(r, k, v, logw, u, q: int) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv_chunk: r, k, v, logw must be one (B, S, H, D) "
                         f"shape; got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, d = r.shape
    if u.shape != (h, d):
        raise ValueError(f"wkv_chunk: u must be {(h, d)}, got "
                         f"{tuple(u.shape)}")
    if q <= 0 or s % q:
        raise ValueError(f"wkv_chunk: S = {s} is not a multiple of q = {q}")
    if r.device.type == "cuda" and (d > MAX_D or q > MAX_Q
                                    or min(b, s, h, d) == 0):
        raise ValueError(f"wkv_chunk: the kernel takes 0 < D, q <= 64 and a "
                         f"non-empty input; got D = {d}, q = {q}, shape "
                         f"{tuple(r.shape)}")


def wkv_forward_saved(r, k, v, logw, u, q: int = 64):
    """(y, final state, workspace): on the CPU (and the meta device,
    shapes only) :func:`wkv_plain` and no workspace; on the card the three launches of ``csrc/wkv_chunk.cu``,
    whose workspace then holds each chunk's starting state S_c and decay
    w_c, what :func:`wkv_backward_kernel` reads. Float32 contiguous
    inputs as :func:`wkv_chunk_kernel` makes them."""
    _check_args(r, k, v, logw, u, q)
    if r.device.type != "cuda":
        return (*wkv_plain(r, k, v, logw, u, q), None)
    from repro_torch.kernels import build
    b, s, h, d = r.shape
    y = torch.empty_like(r)
    state = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    ws = torch.empty(workspace_floats(b, s, h, d, q), dtype=torch.float32,
                     device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(build.entry("wkv_chunk")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(), b, s, h,
        d, q, stream), "wkv_chunk")
    global LAUNCHES
    LAUNCHES += KERNELS_PER_CALL
    return y, state, ws


def wkv_backward_kernel(r, k, v, logw, u, dy, dstate, q: int = 64,
                        ws=None):
    """``(dr, dk, dv, dlogw, du)`` of the chunked WKV for the gradients
    ``dy`` of y and ``dstate`` of the final state (either None: zeros).
    On the CPU (and the meta device) :func:`wkv_backward_plain`; on the
    card the four launches
    of ``csrc/wkv_chunk_bwd.cu``, which read the forward's workspace
    ``ws`` (from :func:`wkv_forward_saved` on the same inputs). Float32
    contiguous inputs as :func:`wkv_chunk_kernel` makes them."""
    _check_args(r, k, v, logw, u, q)
    if r.device.type != "cuda":
        return wkv_backward_plain(r, k, v, logw, u, dy, dstate, q)
    b, s, h, d = r.shape
    if ws is None or ws.numel() != workspace_floats(b, s, h, d, q):
        raise ValueError("wkv_chunk: the backward needs the forward's "
                         "workspace (wkv_forward_saved) on the same inputs")
    from repro_torch.kernels import build
    dy, dstate = _grad_inputs(r, dy, dstate, zero_state=False)
    dr, dk, dv, dl = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((h, d), dtype=torch.float32, device=r.device)
    gws = torch.empty(workspace_floats(b, s, h, d, q), dtype=torch.float32,
                      device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(build.entry("wkv_chunk_bwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), ws.data_ptr(),
        gws.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dl.data_ptr(), du.data_ptr(), b, s, h, d, q, stream),
        "wkv_chunk_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += BWD_KERNELS_PER_CALL
    return dr, dk, dv, dl, du


def bwd_occupancy() -> dict:
    """Per backward kernel (:data:`BWD_KERNELS`): the CTAs an SM holds at
    once at its launch's threads and shared memory, the threads of a CTA
    and the warps an SM, from the card's occupancy calculator
    (``wkv_chunk_bwd_occupancy`` in ``csrc/wkv_chunk_bwd.cu``). Card
    only."""
    import ctypes
    from repro_torch.kernels import build
    out = (ctypes.c_int * (2 * len(BWD_KERNELS)))()
    build.check(build.entry("wkv_chunk_bwd_occupancy")(
        ctypes.addressof(out)), "wkv_chunk_bwd_occupancy")
    return {name: {"ctas_an_sm": out[2 * i], "threads": out[2 * i + 1],
                   "warps_an_sm": out[2 * i] * out[2 * i + 1] // 32}
            for i, name in enumerate(BWD_KERNELS)}


class WkvChunk(torch.autograd.Function):
    """The chunked WKV with the kernel's own backward: the forward keeps
    r, k, v, logw, u and (on the card) its workspace, which holds the
    state each chunk starts from; the backward is
    :func:`wkv_backward_kernel` (the kernel on the card, the plain
    version on the CPU), for y's gradient and the final state's."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, q: int):
        y, state, ws = wkv_forward_saved(r, k, v, logw, u, q)
        ctx.save_for_backward(r, k, v, logw, u, ws)
        ctx.q = q
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u, ws = ctx.saved_tensors
        return (*wkv_backward_kernel(r, k, v, logw, u, dy, dstate, ctx.q,
                                     ws), None)


def wkv_chunk_kernel(r, k, v, logw, u, q: int = 64, device=None):
    """r, k, v, logw: (B, S, H, D) (logw = log decay, <= 0); u: (H, D);
    tensors or arrays, cast to float32 as the reference casts them. Returns
    (y (B, S, H, D) float32, final state (B, H, D, D) float32) on
    ``device`` (None: the card, raising without one; ``"cpu"``: the plain
    version). S must be a multiple of q; on the card D and q are at most
    64. With grad enabled and an input that requires it, the call goes
    through :class:`WkvChunk`, whose backward is ``csrc/wkv_chunk_bwd.cu``
    on the card and :func:`wkv_backward_plain` on the CPU."""
    dev = resolve_device(device)
    r, k, v, logw = (torch.as_tensor(t).to(dev, torch.float32).contiguous()
                     for t in (r, k, v, logw))
    u = torch.as_tensor(u).to(dev, torch.float32).contiguous()
    _check_args(r, k, v, logw, u, q)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u)):
        return WkvChunk.apply(r, k, v, logw, u, q)
    return wkv_forward_saved(r, k, v, logw, u, q)[:2]
