"""Blockwise online-softmax (flash) attention.

The kernel, ``csrc/flash_attention.cu``, gives each (query tile, head) one
CTA and walks 64-key K/V tiles through shared memory in two ``cp.async``
stages, keeping the running ``(m, l, acc)`` online softmax in registers,
so the score matrix never reaches device memory. bfloat16 runs on the
tensor cores (``mma.sync`` m16n8k16, bf16 products accumulated in
float32; 128-row query tiles of 8 warps, Q held in registers, P passed
from the score fragments to the P·V product in registers); float32 runs on
the FMA units (no TF32; 128-row query tiles of 256 threads, each an 8 x 4
score tile and an 8 x 8 output tile fed by float4 shared-memory loads).
Every softmax statistic is float32; the result is cast to q's type at
the end. q, k and v must start on 16-byte boundaries on the card.

The counterpart of the reference's
``src/repro/kernels/flash_attention.py::flash_attention_kernel``, in its
layout: q (S, H, D), k and v (T, H, D) with q's H, out (S, H, D).

**Training.** Where grad is enabled and an input requires it, the call
goes through :class:`FlashAttention`, an autograd Function: its forward
also writes each row's logsumexp (``lse``, (S, H) float32), and its
backward is ``csrc/flash_attention_bwd.cu`` on the card (two launches,
recomputing P from ``lse``: bfloat16 dQ over query tiles, then dK and dV
over key tiles, on ``wgmma`` fed by a TMA tile ring; float32 a pre-pass
for D = rowsum(dout o out), then one pass over key tiles that also sums
dQ's partials in a fixed order, :func:`bwd_tile_walk`) and
:func:`flash_backward_plain` on the CPU. The reference never
differentiates its Pallas kernel (its training attends blockwise through
XLA); the port's long causal attention runs this kernel in training too,
so it has a backward. Under ``inference_mode`` or ``no_grad`` the forward
writes no ``lse`` and saves nothing.
"""
from __future__ import annotations

import torch

from repro_torch import trace

#: the finite mask value of the reference (never -inf: a row that sees no
#: key then averages v over all keys)
NEG = -1e30

#: Launches of ``csrc/flash_attention.cu`` since :func:`reset_launches`;
#: the wrapper adds one where it launches the kernel and nowhere else.
LAUNCHES = 0

_TYPES = (torch.float32, torch.bfloat16)

#: The kernel's own tiles on the card (``csrc/flash_attention.cu``), one
#: size for both types: query rows of a CTA, and keys of a K/V tile.
TILE_Q = 128
TILE_K = 64
#: Bytes every q, k, v (and out) must start on: the kernel copies rows in
#: 16-byte ``cp.async`` units.
ALIGN = 16


#: Launches of ``csrc/flash_attention_bwd.cu`` since :func:`reset_launches`
#: (:data:`BWD_KERNELS_PER_CALL` a backward call, either type: bfloat16
#: dQ, then dK/dV; float32 the pre-pass, then the one pass).
BWD_LAUNCHES = 0
BWD_KERNELS_PER_CALL = 2
#: The backward's tiles by type (``csrc/flash_attention_bwd.cu``). float32
#: (``BK``, ``BQ``): keys of a CTA and rows of the query tiles it walks.
#: bfloat16 (``DQ_ROWS``, ``DQ_KEYS``, ``DKV_KEYS``, ``DKV_ROWS``): query
#: rows of a dQ CTA, keys of the key tiles it walks, keys of a dK/dV CTA,
#: rows of the query tiles it walks (two warpgroups of 64 rows or keys a
#: CTA, each walked tile through the ring).
BWD_TILES = {torch.float32: (64, 64),
             torch.bfloat16: (128, 64, 128, 64)}
#: The workspace's rows are S rounded up to this: both bodies keep each
#: row's lse·log2(e) and D there in (H, S_pad) order.
BWD_PAD_ROWS = 128
#: The float32 body's counters after those rows (ints): its ticket (in a
#: slot of ``BWD_CTR0``), then ``BWD_CTR_WARPS`` a (head, query tile), one
#: a warp of a CTA (``CTR0``, ``WARPS`` in the source).
BWD_CTR0 = 4
BWD_CTR_WARPS = 8


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0


def _divisor_block(block: int, n: int) -> int:
    """The reference's block: ``min(block, n)`` shrunk to a divisor of n."""
    b = min(block, n)
    while n % b:
        b -= 1
    return b


def tile_walk(s: int, t: int, h: int, causal: bool) -> list:
    """The kernel's CTAs in launch order, a plain-Python mirror of
    ``csrc/flash_attention.cu``'s grid: ``(head, q0, q1, tiles)`` for
    query rows ``[q0, q1)`` of one head and key tiles ``0 .. tiles - 1``
    of :data:`TILE_K` keys each (the last one masked past T). The grid is
    (heads, query tiles) with the heads the fastest dimension and the
    query tiles reversed, so the heaviest tiles launch first. The keys end
    at the last one the tile's last row sees when every row sees one
    (causal with T >= S), where a skipped key would add exactly zero;
    else all T are walked (a row that sees no key averages them all)."""
    bq = TILE_Q
    nq = -(-s // bq)
    walk = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bq
        q1 = min(q0 + bq, s)
        kend = t if not causal or t < s else min(q1 + (t - s), t)
        tiles = -(-kend // TILE_K)
        walk.extend((head, q0, q1, tiles) for head in range(h))
    return walk


def bwd_tile_walk(s: int, t: int, h: int, causal: bool,
                  dtype: torch.dtype = torch.bfloat16) -> tuple:
    """The backward's grids for one type, a plain-Python mirror of
    ``csrc/flash_attention_bwd.cu`` with the tiles of :data:`BWD_TILES`.
    Causal with T >= S or non-causal, the backward's domain.

    bfloat16, two grids in launch order, ``(dq, dkv)``: ``dq`` lists the
    dQ CTAs as ``(head, q0, q1, tiles)``: query rows ``[q0, q1)`` of one
    head (heaviest first, heads the fastest grid dimension) and key tiles
    ``0 .. tiles - 1``, ending where the forward's walk ends for the CTA's
    last row. ``dkv`` lists the dK/dV CTAs as ``(head, k0, k1, first,
    last)``: keys ``[k0, k1)`` (the first key tiles first) and query tiles
    ``first .. last - 1``, from the first one holding a row that sees key
    ``k0``.

    float32, the one pass, ``(ctas, adders)``: ``ctas`` lists the CTAs in
    ticket order (key tiles ascending, heads the fastest) as ``(head, k0,
    k1, walk)``: keys ``[k0, k1)`` and the query tiles the CTA walks, in
    its order, from the last down to the first holding a row that sees key
    ``k0``. ``adders`` maps each ``(head, query tile)`` to the key tiles
    whose dQ partials it sums, in the order the counters let them add:
    key tile ``j`` adds once the tile's counter reads ``j``, so ascending,
    and they must be ``0, 1, 2, ...`` for every wait to end."""
    if dtype == torch.float32:
        keys, rows = BWD_TILES[dtype]
        nq, nk = -(-s // rows), -(-t // keys)
        ctas, adders = [], {}
        for j in range(nk):
            k0 = j * keys
            first = max(0, k0 - (t - s)) // rows if causal else 0
            for head in range(h):
                walk = tuple(range(nq - 1, first - 1, -1))
                ctas.append((head, k0, min(k0 + keys, t), walk))
                for qt in walk:
                    adders.setdefault((head, qt), []).append(j)
        return ctas, adders
    rows_q, keys_q, keys_kv, rows_kv = BWD_TILES[dtype]
    nq, nk = -(-s // rows_q), -(-t // keys_kv)
    dq = []
    for y in range(nq):
        q0 = (nq - 1 - y) * rows_q
        q1 = min(q0 + rows_q, s)
        kend = min(q1 + (t - s), t) if causal else t
        dq.extend((head, q0, q1, -(-kend // keys_q)) for head in range(h))
    dkv = []
    for y in range(nk):
        k0 = y * keys_kv
        first = max(0, k0 - (t - s)) // rows_kv if causal else 0
        dkv.extend((head, k0, min(k0 + keys_kv, t), first, -(-s // rows_kv))
                   for head in range(h))
    return dq, dkv


def bwd_workspace_floats(s: int, h: int) -> int:
    """Floats of the backward's workspace: 2·H·S_pad (S rounded up to
    :data:`BWD_PAD_ROWS`), where both bodies keep each row's lse·log2(e)
    and D in (H, S_pad) order, then the float32 body's counters (ints of
    the same size): :data:`BWD_CTR0` and :data:`BWD_CTR_WARPS` a (head,
    query tile of ``BWD_TILES[float32][1]`` rows)."""
    rows = BWD_TILES[torch.float32][1]
    return (2 * h * (-(-s // BWD_PAD_ROWS) * BWD_PAD_ROWS) + BWD_CTR0
            + h * -(-s // rows) * BWD_CTR_WARPS)


def check_card_inputs(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *more: torch.Tensor) -> None:
    """What the kernels need beyond the shapes and types: contiguous q, k,
    v (and, for the backward, out and its gradient), each starting on a
    16-byte boundary (:data:`ALIGN`). Raises ``ValueError``; a misaligned
    view is refused, not copied and not routed to the plain version."""
    named = [("q", q), ("k", k), ("v", v)] + list(zip(("out", "dout"),
                                                       more))
    if not all(a.is_contiguous() for _, a in named):
        raise ValueError(f"flash_attention: "
                         f"{', '.join(n for n, _ in named)} must be "
                         f"contiguous")
    for name, a in named:
        if a.data_ptr() % ALIGN:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"{ALIGN}-byte boundary, got data_ptr "
                             f"{a.data_ptr():#x}")


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True, block_q: int = 128,
                block_k: int = 128) -> torch.Tensor:
    """The plain PyTorch version: the reference's blocks (each shrunk to a
    divisor of S or T) and online softmax, all heads and query blocks at
    once (the reference's parallel grid), one key block at a time."""
    return flash_plain_lse(q, k, v, causal, block_q, block_k)[0]


def flash_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """:func:`flash_plain` and, from the same online softmax, each row's
    float32 logsumexp of its scaled scores, ``m + log l`` as an (S, H)
    tensor: what the kernel writes for the backward."""
    s, h, d = q.shape
    t = k.shape[0]
    bq, bk = _divisor_block(block_q, s), _divisor_block(block_k, t)
    nq = s // bq
    qf = (q.float() / (d ** 0.5)).permute(1, 0, 2).reshape(h, nq, bq, d)
    kf = k.float().permute(1, 0, 2)
    vf = v.float().permute(1, 0, 2)
    qpos = (t - s) + torch.arange(s, device=q.device).reshape(1, nq, bq, 1)
    m = torch.full((h, nq, bq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((h, nq, bq, d), dtype=torch.float32, device=q.device)
    for j in range(t // bk):
        kb, vb = kf[:, j * bk:(j + 1) * bk], vf[:, j * bk:(j + 1) * bk]
        sc = torch.einsum("hnqd,hkd->hnqk", qf, kb)
        if causal:
            kpos = j * bk + torch.arange(bk, device=q.device)
            sc = torch.where(kpos <= qpos, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("hnqk,hkd->hnqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = (m + torch.log(l)).reshape(h, s).T.contiguous()
    return (out.reshape(h, s, d).permute(1, 0, 2).contiguous().to(q.dtype),
            lse)


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor,
                         lse: torch.Tensor, causal: bool = True,
                         block: int = 512):
    """The backward's plain PyTorch version, the kernel's recomputation in
    float32: ``P = exp(q k^T / sqrt(D) - lse)`` under the forward's mask,
    ``D = rowsum(do o)``, ``dS = P (do v^T - D)``; returns ``(dq, dk,
    dv)`` in the inputs' types. For bfloat16 inputs P and dS are rounded
    to bfloat16 before the products that take them (``dv = P^T do``,
    ``dq = dS k``, ``dk = dS^T q``), where the kernel rounds them for its
    tensor cores; float32 rounds nothing. Query rows go ``block`` at a
    time, so the score matrix never exceeds (H, block, T). Causal with
    T >= S or non-causal."""
    s, h, d = q.shape
    t = k.shape[0]
    if causal and t < s:
        raise ValueError(f"flash_attention: the backward takes causal "
                         f"T >= S, got S = {s}, T = {t}")
    root = d ** 0.5
    kf = k.float().permute(1, 0, 2)
    vf = v.float().permute(1, 0, 2)
    delta = (do.float() * o.float()).sum(-1)                    # (S, H)
    dq = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((h, t, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    kpos = torch.arange(t, device=q.device)
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        qb = (q[r0:r1].float() / root).permute(1, 0, 2)         # (H, b, D)
        dob = do[r0:r1].float().permute(1, 0, 2)
        p = torch.exp(qb @ kf.transpose(1, 2) - lse[r0:r1].T[..., None])
        if causal:
            qpos = (t - s) + torch.arange(r0, r1, device=q.device)
            p = torch.where(kpos[None, :] <= qpos[:, None], p,
                            torch.zeros((), device=q.device))
        ds = p * (dob @ vf.transpose(1, 2) - delta[r0:r1].T[..., None])
        if q.dtype == torch.bfloat16:
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dq[r0:r1] = ((ds @ kf) / root).permute(1, 0, 2)
        dk += (ds.transpose(1, 2) @ q[r0:r1].float().permute(1, 0, 2)
               ) / root
        dv += p.transpose(1, 2) @ dob
    return (dq.to(q.dtype), dk.permute(1, 0, 2).to(k.dtype),
            dv.permute(1, 0, 2).to(v.dtype))


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (S, H, D), k and v (T, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    s, h, d = q.shape
    t = k.shape[0]
    if k.shape[1:] != (h, d):
        raise ValueError(f"flash_attention: k, v must have q's heads and "
                         f"width {(h, d)} (expand grouped heads first); got "
                         f"{tuple(k.shape[1:])}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v float32 or bfloat16, "
                         f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or not 16 <= d <= 128:
        raise ValueError(f"flash_attention: D must be a multiple of 8 from "
                         f"16 to 128, got {d}")
    if s == 0 or t == 0:
        raise ValueError("flash_attention: empty sequence")
    if q.device != k.device or q.device != v.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _forward(q, k, v, causal: bool, block_q: int, block_k: int,
             with_lse: bool):
    """(out, lse or None): the plain version on the CPU, else one launch
    of the kernel, which writes ``lse`` only when asked. Recorded as the
    span ``repro/kernels/flash_fwd`` (``s``, ``bh``, ``d``)."""
    s, h, d = q.shape
    with trace.span("repro/kernels/flash_fwd", s=s, bh=h, d=d):
        if q.device.type == "cpu":
            out, lse = flash_plain_lse(q, k, v, causal, block_q, block_k)
            return out, (lse if with_lse else None)
        check_card_inputs(q, k, v)
        from repro_torch.kernels import build
        out = torch.empty_like(q)
        lse = torch.empty((s, h), dtype=torch.float32,
                          device=q.device) if with_lse else None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(build.entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), s, k.shape[0], h, d,
            int(causal), int(q.dtype == torch.bfloat16), stream),
            "flash_attention")
        global LAUNCHES
        LAUNCHES += 1
        return out, lse


def flash_backward_kernel(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, o: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          causal: bool = True):
    """(dq, dk, dv) of attention from the forward's output ``o``, its
    ``lse`` ((S, H) float32) and the output's gradient ``do``. On the CPU
    :func:`flash_backward_plain`; on the card the two launches of
    ``csrc/flash_attention_bwd.cu`` (:data:`BWD_KERNELS_PER_CALL`), which
    need the forward's domain with causal T >= S, and contiguous q, k, v,
    o, do on 16-byte boundaries."""
    _check_args(q, k, v)
    s, h, d = q.shape
    t = k.shape[0]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"flash_attention: out and its gradient must be "
                         f"q's {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    if lse.shape != (s, h) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention: lse must be ({s}, {h}) float32,"
                         f" got {tuple(lse.shape)} {lse.dtype}")
    if causal and t < s:
        raise ValueError(f"flash_attention: the backward takes causal "
                         f"T >= S, got S = {s}, T = {t}")
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, do, lse, causal)
    check_card_inputs(q, k, v, o, do)
    from repro_torch.kernels import build
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = torch.empty(bwd_workspace_floats(s, h), dtype=torch.float32,
                       device=q.device)
    lse = lse.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(build.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), s, t, h, d, int(causal),
        int(q.dtype == torch.bfloat16), stream), "flash_attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += BWD_KERNELS_PER_CALL
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel's own backward: the forward keeps q, k,
    v, the output and its ``lse``; the backward is
    :func:`flash_backward_kernel` (the kernel on the card, the plain
    version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: int, block_k: int):
        out, lse = _forward(q, k, v, causal, block_q, block_k, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        if do.device.type == "cuda" and do.data_ptr() % ALIGN:
            do = do.clone()
        dq, dk, dv = flash_backward_kernel(q, k, v, out, do, lse, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True,
                           block_q: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """q: (S, H, D); k, v: (T, H, D) -> (S, H, D) in q's type. float32 or
    bfloat16 (one type for all three); D a multiple of 8 from 16 to 128.
    On the CPU this is :func:`flash_plain`, which walks ``block_q`` x
    ``block_k`` blocks as the reference does; the kernel on the card uses
    its own tiles whatever the blocks (:func:`tile_walk`; the last key tile
    masked past T), with the same mask and the same online softmax, and
    needs contiguous q, k, v on 16-byte boundaries
    (:func:`check_card_inputs`). With grad enabled and an input that
    requires it, the call is differentiable through :class:`FlashAttention`
    (causal T >= S or non-causal)."""
    _check_args(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if causal and k.shape[0] < q.shape[0]:
            raise ValueError(f"flash_attention: the backward takes causal "
                             f"T >= S, got S = {q.shape[0]}, T = "
                             f"{k.shape[0]}")
        return FlashAttention.apply(q, k, v, causal, block_q, block_k)
    return _forward(q, k, v, causal, block_q, block_k, False)[0]
