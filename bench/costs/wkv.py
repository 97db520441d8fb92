"""RWKV6's WKV of one call, float32, counted from the model's shapes:
``b`` sequences of ``s`` steps, ``h`` heads of width ``d``.

- forward bytes: r, k, v, the log decay (b·s·h·d each) and u (h·d) read
  once; y (b·s·h·d) and the final state (b·h·d·d) written once;
- backward bytes: r, k, v, the log decay, u and y's gradient read once;
  the gradients of r, k, v, the log decay and u written once;
- operations: only the state products that every chunked or sequential
  form computes, for each step and head: forward 4·d² (r·S, and k·vᵀ
  added into S); backward 8·d² (rᵀ·dy into the state's gradient, then dr,
  dk and dv from the states).

No term depends on a chunk or a sub-chunk: a kernel that cuts its work
differently keeps the same bound."""
from bench.costs import peaks

ESIZE = 4


def forward_bytes(b: int, s: int, h: int, d: int) -> int:
    return ESIZE * (5 * b * s * h * d + h * d + b * h * d * d)


def forward_ops(b: int, s: int, h: int, d: int) -> int:
    return 4 * d * d * b * s * h


def backward_bytes(b: int, s: int, h: int, d: int) -> int:
    return ESIZE * (9 * b * s * h * d + 2 * h * d)


def backward_ops(b: int, s: int, h: int, d: int) -> int:
    return 8 * d * d * b * s * h


def forward_bound_s(b: int, s: int, h: int, d: int) -> float:
    return peaks.bound_s(forward_bytes(b, s, h, d), forward_ops(b, s, h, d),
                         peaks.F32_FLOPS)


def backward_bound_s(b: int, s: int, h: int, d: int) -> float:
    return peaks.bound_s(backward_bytes(b, s, h, d),
                         backward_ops(b, s, h, d), peaks.F32_FLOPS)
