"""Bottom-up method for the safe buffer overlap (paper §III-B).

The paper instruments compiled binaries with a modified Valgrind; the
container equivalent is a *memory-event simulator*: we replay the TFLite
reference loop nest of each op kind in Python, emitting every load from the
input buffer and every store to the output buffer as (step, offset) events,
then post-process the raw event stream into ``O_s`` exactly as the paper's
tooling does. The op implementation here is treated as a black box by the
post-processing — it only sees events — so this path also validates the
event→O_s reduction itself.

Python loops: use small shapes (tests sweep these against the algorithmic
and analytic methods).
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core.graph import Op, op_pads
from repro_torch.core.overlap.algorithmic import _hwc

Event = Tuple[int, int, bool]  # (step, element offset, is_read)


def _conv_geometry(op: Op):
    ih, iw, idep = _hwc(op.inputs[0].shape)
    oh, ow, od = _hwc(op.output.shape)
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    kh, kw = op.params["kernel"]
    # band-aware (op_pads): row-banded ops replay their band-local loop nest
    ph, pw = op_pads(op)
    return (ih, iw, idep), (oh, ow, od), (sh, sw), (dh, dw), (kh, kw), (ph, pw)


def trace_events(op: Op, input_index: int = 0) -> Iterator[Event]:
    """Replay the reference loop nest, yielding load/store events."""
    if op.kind == "conv2d":
        (ih, iw, idep), (oh, ow, od), (sh, sw), (dh, dw), (kh, kw), (ph, pw) = \
            _conv_geometry(op)
        step = 0
        for oy in range(oh):
            for ox in range(ow):
                for oc in range(od):
                    for fy in range(kh):
                        iy = oy * sh - ph + fy * dh
                        if not 0 <= iy < ih:
                            continue
                        for fx in range(kw):
                            ix = ox * sw - pw + fx * dw
                            if not 0 <= ix < iw:
                                continue
                            for ic in range(idep):
                                yield step, (iy * iw + ix) * idep + ic, True
                    yield step, (oy * ow + ox) * od + oc, False
                    step += 1
    elif op.kind == "depthwise_conv2d":
        (ih, iw, idep), (oh, ow, od), (sh, sw), (dh, dw), (kh, kw), (ph, pw) = \
            _conv_geometry(op)
        kc = op.params.get("multiplier", 1)
        step = 0
        for oy in range(oh):
            for ox in range(ow):
                for ic in range(idep):
                    for m in range(kc):
                        for fy in range(kh):
                            iy = oy * sh - ph + fy * dh
                            if not 0 <= iy < ih:
                                continue
                            for fx in range(kw):
                                ix = ox * sw - pw + fx * dw
                                if not 0 <= ix < iw:
                                    continue
                                yield step, (iy * iw + ix) * idep + ic, True
                        yield step, (oy * ow + ox) * od + (ic * kc + m), False
                        step += 1
    elif op.kind == "pool":
        (ih, iw, idep), (oh, ow, od), (sh, sw), (dh, dw), (kh, kw), (ph, pw) = \
            _conv_geometry(op)
        step = 0
        for oy in range(oh):
            for ox in range(ow):
                for c in range(idep):
                    for fy in range(kh):
                        iy = oy * sh - ph + fy
                        if not 0 <= iy < ih:
                            continue
                        for fx in range(kw):
                            ix = ox * sw - pw + fx
                            if not 0 <= ix < iw:
                                continue
                            yield step, (iy * iw + ix) * idep + c, True
                    yield step, (oy * ow + ox) * od + c, False
                    step += 1
    elif op.kind in ("elementwise", "softmax"):
        n = op.output.elems
        in_e = op.inputs[input_index].elems
        if op.kind == "softmax":  # max + sum passes before any write
            for i in range(in_e):
                yield 0, i, True
        for i in range(n):
            yield i, i % in_e, True
            yield i, i, False
    elif op.kind in ("fully_connected", "matmul"):
        od = op.output.shape[-1]
        idim = op.inputs[0].shape[-1]
        batches = op.output.elems // od
        step = 0
        for b in range(batches):
            for oc in range(od):
                if input_index == 0:
                    for k in range(idim):
                        yield step, b * idim + k, True
                else:  # RHS (idim, od) row-major
                    for k in range(idim):
                        yield step, k * od + oc, True
                yield step, b * od + oc, False
                step += 1
    elif op.kind == "mean":
        in_e = op.inputs[0].elems
        for i in range(in_e):
            yield 0, i, True
        for i in range(op.output.elems):
            yield i, i, False
    else:
        raise NotImplementedError(f"trace for {op.kind}")


def events_to_overlap(events: List[Event], out_elems: int, ts_in: int,
                      ts_out: int) -> int:
    """Reduce a raw event stream to ``O_s`` (bytes) — black-box w.r.t. the op."""
    if not events:
        return 0
    n_steps = max(s for s, _, _ in events) + 1
    INF = np.iinfo(np.int64).max // 4
    min_r = np.full(n_steps, INF, dtype=np.int64)
    max_w = np.full(n_steps, -1, dtype=np.int64)
    for s, off, is_read in events:
        if is_read:
            min_r[s] = min(min_r[s], off * ts_in)
        else:
            max_w[s] = max(max_w[s], off * ts_out)
    min_r = np.minimum.accumulate(min_r[::-1])[::-1]   # min of this & future
    max_w = np.maximum.accumulate(max_w)               # max of this & past
    valid = max_w >= 0
    mind = int(min((min_r[valid] - max_w[valid]).min(), 0)) if valid.any() else 0
    ob = out_elems * ts_out
    return int(max(0, min(ob, ob + mind)))


def safe_overlap_trace(op: Op, input_index: int = 0) -> int:
    ts_in = op.inputs[input_index].dtype_bytes
    ts_out = op.output.dtype_bytes
    events = list(trace_events(op, input_index))
    # only keep reads of the requested input (the generator already does so)
    return events_to_overlap(events, op.output.elems, ts_in, ts_out)
