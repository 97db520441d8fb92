"""Analytic method for the safe buffer overlap (paper §III-D, Eqs. 1-15).

``minR(i)`` is lower-bounded by the truncated linear function
``max(0, a*i + b)`` and ``maxW(i) = i``; the minimum of their difference over
``[0, i_c]`` gives ``minD`` and (Eq. 11):

    O_s = OB_s + min{ b/a, a*i_c + b - i_c } * T_s

The per-kind constants:

  depthwise conv (Eqs. 7, 8):  a = Sh*Iw / (Ow*Kc)
                               b = (Ow*Sw - Ph*Iw - Sh*Iw - Sw - Pw + 1) * Id
  2D conv (Eqs. 12, 13):       a = Sh*Iw*Id / (Ow*Od)
                               b = (Ow*Sw - Ph*Iw - Sh*Iw - Sw - Pw) * Id + 1
  pooling (Eqs. 14, 15):       a = Sh*Iw / Ow
                               b = (Ow*Sw - Ph*Iw - Sh*Iw - Sw - Pw) * Id + 1

Elementwise/softmax/mean are the ideal diagonal (``O_s = |out|``);
matmul/fully-connected is the degenerate case (``O_s = 0``).

Both the paper's closed form and a robust piecewise evaluation (min over the
breakpoints of the piecewise-linear difference) are provided; they agree on
every op in the model zoo (tested), the robust form is used by default.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from repro_torch.core.graph import Op, op_pads
from repro_torch.core.overlap.algorithmic import _hwc


def _conv_family_constants(op: Op) -> Tuple[float, float, int]:
    """Return (a, b, i_c) in input-buffer elements / steps."""
    ih, iw, idep = _hwc(op.inputs[0].shape)
    oh, ow, od = _hwc(op.output.shape)
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    kh, kw = op.params["kernel"]
    # band-aware: the constants take the band's effective padding (op_pads
    # substitutes the explicit per-band pads for row_range-carrying ops;
    # a producer band's negative ph only raises minR, so the truncated
    # linear bound stays a lower bound)
    ph, pw = op_pads(op)
    if op.kind == "depthwise_conv2d":
        kc = op.params.get("multiplier", 1)
        a = (sh * iw) / (ow * kc)
        b = (ow * sw - ph * iw - sh * iw - sw - pw + 1) * idep
        i_c = oh * ow * idep * kc
    elif op.kind == "conv2d":
        a = (sh * iw * idep) / (ow * od)
        b = (ow * sw - ph * iw - sh * iw - sw - pw) * idep + 1
        i_c = oh * ow * od
    elif op.kind == "pool":
        a = (sh * iw) / ow
        b = (ow * sw - ph * iw - sh * iw - sw - pw) * idep + 1
        i_c = oh * ow * idep
    else:  # pragma: no cover
        raise ValueError(op.kind)
    return a, b, i_c


def _min_diff_piecewise(a: float, b: float, i_c: int) -> float:
    """Robust min over i in [0, i_c] of max(0, a*i + b) - i.

    The difference is piecewise linear with at most one breakpoint (the
    truncation point i* = -b/a); the minimum is attained at i=0, i=i_c or i*.
    """
    cands = [0.0, float(i_c)]
    if a > 0 and b < 0:
        cands.append(min(float(i_c), -b / a))
    return min(max(0.0, a * i + b) - i for i in cands)


def paper_closed_form(a: float, b: float, i_c: int) -> float:
    """Eq. (11)'s min term: min{ b/a, a*i_c + b - i_c }."""
    return min(b / a, a * i_c + b - i_c)


def safe_overlap_analytic(op: Op, input_index: int = 0,
                          use_paper_form: bool = False) -> Optional[int]:
    """Closed-form lower bound of ``O_s`` in bytes, or None if this op kind
    has no derived analytic solution (caller falls back to algorithmic)."""
    out = op.output
    ts = out.dtype_bytes
    if op.kind in ("elementwise", "softmax", "mean"):
        x = op.inputs[input_index]
        if op.kind == "elementwise" and x.elems != out.elems:
            return None  # broadcast operand: no derived form, fall back
        return out.nbytes
    if op.kind in ("fully_connected", "matmul"):
        return 0  # paper §III-A: "can not be overlapped at all"
    if op.kind in ("conv2d", "depthwise_conv2d", "pool"):
        if input_index != 0:
            return None
        a, b, i_c = _conv_family_constants(op)
        mind = (paper_closed_form(a, b, i_c) if use_paper_form
                else _min_diff_piecewise(a, b, i_c))
        mind = min(0.0, mind)
        os_bytes = out.nbytes + int(math.floor(mind)) * ts
        return int(max(0, min(out.nbytes, os_bytes)))
    if op.kind == "reshape":
        return 0
    return None
