"""The causal attention forward of one call, counted from the model's
shapes: ``b`` sequences of ``s`` tokens, ``h`` query heads and ``kv``
key/value heads of width ``d``.

- bytes: q and the output at the ``h`` query heads, k and v at the
  ``kv`` heads, each read or written once, in ``esize`` bytes;
- operations: 4·d per visible causal (query, key) pair and query head
  (q·k and p·v); the exponentials are not counted.

The grouped heads' copy that a kernel may make before the call is not the
model's work, so it is not counted."""
from bench.costs import peaks


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal self-attention of ``s`` tokens sees."""
    return s * (s + 1) // 2


def forward_bytes(b: int, s: int, h: int, kv: int, d: int,
                  esize: int) -> int:
    return b * s * d * esize * (2 * h + 2 * kv)


def forward_ops(b: int, s: int, h: int, d: int) -> int:
    return 4 * d * h * b * causal_pairs(s)


def forward_bound_s(b: int, s: int, h: int, kv: int, d: int,
                    esize: int) -> float:
    """Seconds the forward needs at least on one H100: bf16 products at the
    tensor cores' peak, float32 at the FMA units'."""
    flops = peaks.BF16_FLOPS if esize == 2 else peaks.F32_FLOPS
    return peaks.bound_s(forward_bytes(b, s, h, kv, d, esize),
                         forward_ops(b, s, h, d), flops)
