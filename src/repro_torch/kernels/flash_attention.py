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
"""
from __future__ import annotations

import torch

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


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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


def check_card_inputs(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """What the kernel needs beyond the shapes and types: contiguous q, k,
    v, each starting on a 16-byte boundary (:data:`ALIGN`). Raises
    ``ValueError``; a misaligned view is refused, not copied and not
    routed to the plain version."""
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    for name, a in (("q", q), ("k", k), ("v", v)):
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
    return out.reshape(h, s, d).permute(1, 0, 2).contiguous().to(q.dtype)


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
    (:func:`check_card_inputs`)."""
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
    if q.device.type == "cpu":
        return flash_plain(q, k, v, causal, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    check_card_inputs(q, k, v)
    from repro_torch.kernels import build
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), s, t, h, d,
        int(causal), int(q.dtype == torch.bfloat16), stream),
        "flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    return out

