"""Safe buffer overlap (``O_s``) calculators — the paper's Section III.

Three methods, in increasing order of speed / decreasing generality:

- :mod:`.trace`       — bottom-up: replay the reference loop nest and record
                        every load/store event (the Valgrind stand-in).
- :mod:`.algorithmic` — Alg. 2: vectorised ``minR``/``maxW`` construction.
- :mod:`.analytic`    — Eqs. (5)-(15): closed-form truncated-linear bound.

All return ``O_s`` in **bytes**: the maximum number of bytes the start of the
given input buffer may overlap the end of the output buffer.
"""
from repro_torch.core.overlap.algorithmic import safe_overlap_algorithmic
from repro_torch.core.overlap.analytic import safe_overlap_analytic
from repro_torch.core.overlap.trace import safe_overlap_trace


#: Op kinds for which the PAPER derives O_s solutions (§III-D + Fig. 3):
#: conv family, pooling, elementwise (incl. the in-place special case) and
#: the degenerate matmul. Everything else is treated as O_s = 0 in
#: paper-faithful mode; ``extended`` mode (beyond paper) also overlaps
#: concat / pad / mean / embedding via the algorithmic method.
PAPER_KINDS = frozenset({
    "conv2d", "depthwise_conv2d", "pool", "elementwise", "softmax",
    "fully_connected", "matmul", "mean",
})


def _image_op(op):
    """A per-image (batch-1) clone of a batched op: the three calculators
    replay the per-image loop nest, so their element counts and byte sizes
    must exclude the batch axis. The planner re-scales the per-image O_s to
    the batch (``planner.batched_os_bytes``). Batch-1 ops pass through
    untouched."""
    if all(t.batch == 1 for t in list(op.inputs) + list(op.outputs)):
        return op
    from repro_torch.core.graph import Op, Tensor

    def img(t):
        return Tensor(t.name, t.shape, t.dtype_bytes, t.kind, None, batch=1)

    return Op(op.kind, [img(t) for t in op.inputs],
              [img(t) for t in op.outputs], dict(op.params), op.name)


def safe_overlap(op, input_index: int = 0, method: str = "auto",
                 profile: str = "paper") -> int:
    """Dispatch: ``auto`` prefers the analytic closed form (cheapest, always a
    safe lower bound) and falls back to the algorithmic method for op kinds
    without a derived analytic solution. ``profile='paper'`` restricts the
    overlap to the op kinds the paper derives; ``'extended'`` covers all.
    Batched ops are evaluated per-image (see :func:`_image_op`); the result
    is always the PER-IMAGE ``O_s`` in bytes."""
    if profile == "paper" and op.kind not in PAPER_KINDS:
        return 0
    op = _image_op(op)
    if method == "trace":
        return safe_overlap_trace(op, input_index)
    if method == "algorithmic":
        return safe_overlap_algorithmic(op, input_index)
    if method == "analytic":
        r = safe_overlap_analytic(op, input_index)
        if r is None:
            raise ValueError(f"no analytic O_s for op kind {op.kind!r}")
        return r
    if method == "auto":
        r = safe_overlap_analytic(op, input_index)
        if r is None:
            r = safe_overlap_algorithmic(op, input_index)
        return r
    raise ValueError(method)


__all__ = [
    "safe_overlap",
    "safe_overlap_trace",
    "safe_overlap_algorithmic",
    "safe_overlap_analytic",
]
