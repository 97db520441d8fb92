"""Plan-routed serving runtime: batch-aware compiled plans behind a queue.

:class:`PlanServer` closes the loop between the compile pipeline's batched
plans (``compile(graph, batch=b)``) and a request-serving front end. At
construction it compiles one plan *variant per batch size* and keeps the
variants whose arena peak fits the configured budget: the device has one
fixed arena, and the largest batch the arena admits is a *planning*
question, not a runtime guess. Queued requests are batched up to a deadline
and routed to the largest admitted variant; the server reports plan-cache
hit rates, per-batch arena peaks and request-level timing spans. With a
:mod:`repro_torch.trace` recorder on, each flush is also the span
``repro/plan_server/flush`` (``batch``, ``requests``).

Each flush runs its variant's flat arena program through the hand-written
kernels (:class:`~repro_torch.core.exec.cuda_backend.CudaExecutor`,
``layout="flat"``): on the card by default, so the device arena of a flush
is exactly the variant's ``peak_bytes``, the number the budget admitted;
``device="cpu"`` runs the same program through the kernels' plain
versions. Every variant runs at the server's one calibration (weights and
quantisation of the batch-1 graph, mapped onto the variant's split, fused
and batched ops by name and ``split_src``), so a request's output does not
depend on the batch it rode in.

:class:`FastExec`, a vectorised batched functional executor sharing the
per-op semantics of :mod:`repro_torch.core.exec.ops`, is the host-side
numeric reference every served request is held against: the int8 tier
accumulates in float64 (every partial sum here is an integer far below
2**53, so the BLAS accumulation is *exactly* the reference int32
accumulation) and requantises through the identical float32 formula.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import trace
from repro_torch.core import exec as X
from repro_torch.core.exec.ops import (QuantSpec, acc_multiplier, dequantise,
                                       op_quant, pads, quantise, requantise,
                                       rescale_q)
from repro_torch.core.graph import Graph, Op
from repro_torch.kernels.arena_ops import apply_op


# ---------------------------------------------------------------------------
# FastExec: vectorised batched functional execution
# ---------------------------------------------------------------------------


def _conv_batched(op: Op, x: np.ndarray, filt: np.ndarray, q) -> np.ndarray:
    """conv2d / depthwise_conv2d over a batched (B, H, W, C) input: one
    accumulation per filter tap, taps in the reference's (fy, fx) order, each
    tap a BLAS matmul over the channel axis — the same per-tap shapes
    :func:`repro_torch.core.exec.ops.conv_row` runs, just all rows at once."""
    B, ih, iw, ic = x.shape
    oh, ow = op.output.shape[-3], op.output.shape[-2]
    kh, kw = op.params["kernel"]
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    ph, pw = pads(op)
    kc = op.params.get("multiplier", 1)
    oc = op.output.shape[-1] if op.kind == "conv2d" else ic * kc
    if q is not None:
        # float64 keeps every int32 partial sum exact (|acc| << 2**53), so
        # the BLAS path reproduces the reference int32 accumulation bit for
        # bit before the shared float32 requantisation
        xf = x.astype(np.float64) - q.ins[0].zero_point
        wf = filt.astype(np.float64)
    else:
        xf = x.astype(np.float32)
        wf = filt
    pb = max(0, (oh - 1) * sh - ph + (kh - 1) * dh - (ih - 1))
    pr = max(0, (ow - 1) * sw - pw + (kw - 1) * dw - (iw - 1))
    xp = np.pad(xf, ((0, 0), (ph, pb), (pw, pr), (0, 0)))
    acc = np.zeros((B, oh, ow, oc), xf.dtype)
    for fy in range(kh):
        for fx in range(kw):
            sl = xp[:, fy * dh:fy * dh + (oh - 1) * sh + 1:sh,
                    fx * dw:fx * dw + (ow - 1) * sw + 1:sw, :]
            w = wf[fy, fx]
            if op.kind == "conv2d":
                acc += sl @ w
            else:
                acc += (sl[..., :, None] * w).reshape(B, oh, ow, oc)
    if q is not None:
        return requantise(acc, acc_multiplier(op, q), q.out.zero_point)
    return acc


def _pool_batched(op: Op, x: np.ndarray, q) -> np.ndarray:
    B, ih, iw, c = x.shape
    oh, ow = op.output.shape[-3], op.output.shape[-2]
    kh, kw = op.params["kernel"]
    sh, sw = op.params.get("stride", (1, 1))
    ph, pw = pads(op)
    mode = op.params.get("mode", "avg")
    xf = x.astype(np.float64 if q is not None else np.float32)
    pb = max(0, (oh - 1) * sh - ph + kh - ih)
    pr = max(0, (ow - 1) * sw - pw + kw - iw)
    padval = -np.inf if mode == "max" else 0.0
    xp = np.pad(xf, ((0, 0), (ph, pb), (pw, pr), (0, 0)),
                constant_values=padval)
    ones = np.pad(np.ones((B, ih, iw, 1), np.float32),
                  ((0, 0), (ph, pb), (pw, pr), (0, 0)))
    if mode == "max":
        acc = np.full((B, oh, ow, c), -np.inf, xf.dtype)
    else:
        acc = np.zeros((B, oh, ow, c), xf.dtype)
    cnt = np.zeros((B, oh, ow, 1), np.float32)
    for fy in range(kh):
        for fx in range(kw):
            sl = xp[:, fy:fy + (oh - 1) * sh + 1:sh,
                    fx:fx + (ow - 1) * sw + 1:sw, :]
            if mode == "max":
                acc = np.maximum(acc, sl)
            else:
                acc += sl
                cnt += ones[:, fy:fy + (oh - 1) * sh + 1:sh,
                            fx:fx + (ow - 1) * sw + 1:sw, :]
    if q is not None:
        x_zp, mult = q.ins[0].zero_point, acc_multiplier(op, q)
        if mode == "avg":
            val = acc.astype(np.float32) / np.maximum(cnt, 1.0) - x_zp
        else:
            val = acc - x_zp
        return requantise(val, mult, q.out.zero_point)
    if mode == "avg":
        acc = acc / np.maximum(cnt, 1.0)
    return acc.astype(np.float32)


class FastExec:
    """Vectorised batched functional executor of one graph. Values carry an
    explicit leading batch axis (B >= 1); weights / calibration are the
    deterministic per-seed synthesis every arena backend shares, so outputs
    are directly comparable to the numpy/cuda backends."""

    def __init__(self, graph: Graph, seed: int = 0, weights=None, quant=None):
        self.graph = graph
        reason = X.executability(graph)
        if reason is not None:
            raise ValueError(f"FastExec cannot execute {graph.name!r}: "
                             f"{reason}")
        self.weights = weights if weights is not None \
            else X.synth_weights(graph, seed)
        if quant is None and X.needs_quant(graph):
            quant = X.calibrate(graph, seed, self.weights)
        self.quant = quant

    def _filter(self, op: Op, q):
        if q is not None and id(op) in self.quant.weights_q:
            return self.quant.weights_q[id(op)]["filter"]
        return self.weights[id(op)].get("filter")

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Execute on batched inputs ``{name: (B,) + shape}`` (the per-image
        shape is auto-lifted to B=1). Float values fed to int8 input tensors
        are quantised at the calibrated params. Returns batched outputs."""
        g = self.graph
        vals: Dict[Any, np.ndarray] = {}
        B = 1
        for t in g.tensors:
            if t.kind != "input":
                continue
            v = np.asarray(inputs[t.name])
            if v.ndim == len(t.shape):
                v = v[None]
            if t.dtype_bytes == 1 and v.dtype != np.int8:
                v = quantise(v.astype(np.float32),
                             self.quant.tensors[t.name])
            vals[t.storage()] = v
            B = v.shape[0]
        for op in g.ops:
            vals[op.output.storage()] = self._eval(op, vals, B)
        return {t.name: vals[t.storage()]
                for t in g.tensors if t.kind == "output"}

    def _eval(self, op: Op, vals, B: int) -> np.ndarray:
        xs = [vals[t.storage()] for t in op.inputs
              if t.storage().kind != "weight"]
        if op.kind == "reshape":
            return xs[0].reshape((B,) + tuple(op.output.shape))
        q = op_quant(op, self.quant)
        k = op.kind
        if k in ("conv2d", "depthwise_conv2d"):
            return _conv_batched(op, xs[0], self._filter(op, q), q)
        if k == "pool":
            return _pool_batched(op, xs[0], q)
        if k == "elementwise":
            fn = X.ELEMENTWISE[op.params.get("fn", "relu")]
            if q is not None:
                xs = [dequantise(x, qp) for x, qp in zip(xs, q.ins)]
            xs = list(xs)
            if len(xs) == 2 and xs[1].shape != xs[0].shape:
                pad = (1,) * (xs[0].ndim - xs[1].ndim)
                xs[1] = np.broadcast_to(
                    xs[1].reshape((B,) + pad + xs[1].shape[1:]), xs[0].shape)
            y = fn(*xs).astype(np.float32)
            return quantise(y, q.out) if q is not None else y
        if k == "softmax":
            x = dequantise(xs[0], q.ins[0]) if q is not None else xs[0]
            e = np.exp(x - x.max(axis=-1, keepdims=True))
            y = (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
            return quantise(y, q.out) if q is not None else y
        if k == "fully_connected":
            filt = self._filter(op, q)
            x = xs[0].reshape(-1, op.inputs[0].shape[-1])
            oshape = (B,) + tuple(op.output.shape)
            if q is not None:
                acc = (x.astype(np.float64) - q.ins[0].zero_point) \
                    @ filt.astype(np.float64)
                return requantise(acc, acc_multiplier(op, q),
                                  q.out.zero_point).reshape(oshape)
            return (x @ filt).reshape(oshape).astype(np.float32)
        if k == "matmul":
            a = xs[0].reshape((B, -1) + (op.inputs[0].shape[-1],))
            b = xs[1].reshape((B,) + tuple(op.inputs[1].shape))
            oshape = (B,) + tuple(op.output.shape)
            if q is not None:
                acc = (a.astype(np.float64) - q.ins[0].zero_point) \
                    @ (b.astype(np.float64) - q.ins[1].zero_point)
                return requantise(acc, acc_multiplier(op, q),
                                  q.out.zero_point).reshape(oshape)
            return (a @ b).reshape(oshape).astype(np.float32)
        if k == "concat":
            axis = op.params.get("axis", -1)
            if axis >= 0:
                axis += 1  # leading batch axis
            if q is not None:
                xs = [rescale_q(x, qp, q.out) for x, qp in zip(xs, q.ins)]
            return np.concatenate(list(xs), axis=axis)
        if k == "pad":
            pad = [(0, 0)] + [tuple(p) for p in op.params["paddings"]]
            if q is not None:
                padded = np.pad(xs[0], pad,
                                constant_values=q.ins[0].zero_point)
                return rescale_q(padded, q.ins[0], q.out)
            return np.pad(xs[0], pad)
        if k == "mean":
            x = xs[0]
            axes = tuple(a + 1 for a in
                         op.params.get("axes", range(x.ndim - 2)))
            oshape = (B,) + tuple(op.output.shape)
            if q is not None:
                cnt = 1
                for ax in axes:
                    cnt *= x.shape[ax]
                acc = x.astype(np.float64).sum(axis=axes)
                val = acc.astype(np.float32) / np.float32(cnt) \
                    - q.ins[0].zero_point
                return requantise(val, acc_multiplier(op, q),
                                  q.out.zero_point).reshape(oshape)
            return x.mean(axis=axes).reshape(oshape).astype(np.float32)
        raise NotImplementedError(f"FastExec: {k}")




# ---------------------------------------------------------------------------
# Variants at the server's calibration
# ---------------------------------------------------------------------------

#: Op kinds that carry a filter (:func:`repro_torch.core.exec.ops.weights_for`)
_WEIGHTED = ("conv2d", "depthwise_conv2d", "fully_connected")


def variant_params(graph: Graph, weights, quant: Optional[QuantSpec],
                   vgraph: Graph) -> Tuple[Dict[int, Dict[str, np.ndarray]],
                                           Optional[QuantSpec]]:
    """The weights and quantisation of ``graph`` carried onto ``vgraph``, a
    compiled variant of it (batched, split into row bands, fused), keyed by
    ``id(op)`` of ``vgraph``'s ops.

    An op takes the weights of the op of ``graph`` named by its
    ``split_src`` (a band) or by its own name; a tensor takes the params of
    the tensor of the same name, or else those of its producer's source
    op's output (a band, or a fused chain's scratch). A variant calibrated
    on its own batched inputs would quantise at other params, so its
    outputs would depend on the batch a request rode in."""
    by_name = {op.name: op for op in graph.ops}
    src_of: Dict[int, Op] = {}
    v_weights: Dict[int, Dict[str, np.ndarray]] = {}
    for op in vgraph.ops:
        src = by_name.get(op.params.get("split_src", op.name))
        if src is not None and src.kind == op.kind:
            src_of[id(op)] = src
            v_weights[id(op)] = weights[id(src)]
        elif op.kind in _WEIGHTED:
            raise ValueError(f"variant op {op.name!r} of {vgraph.name!r} has "
                             f"no source op in {graph.name!r}")
        else:
            v_weights[id(op)] = {}
    if quant is None:
        return v_weights, None
    producer = {op.output.storage(): op for op in vgraph.ops}
    tensors = {}
    for t in vgraph.data_tensors():
        name = t.name
        if name not in quant.tensors:
            op = producer.get(t)
            src = src_of.get(id(op)) if op is not None else None
            if src is None:
                raise ValueError(f"variant tensor {name!r} of "
                                 f"{vgraph.name!r} has no source tensor in "
                                 f"{graph.name!r}")
            name = src.output.storage().name
        tensors[t.name] = quant.tensors[name]
    return v_weights, QuantSpec(
        tensors,
        {i: quant.weight_scale[id(s)] for i, s in src_of.items()
         if id(s) in quant.weight_scale},
        {i: quant.weights_q[id(s)] for i, s in src_of.items()
         if id(s) in quant.weights_q})


# ---------------------------------------------------------------------------
# PlanServer: deadline batching over compiled batch variants
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeRequest:
    """One queued inference request plus its timing spans (seconds on the
    server's monotonic clock): submit -> batch assembly -> execute."""
    rid: int
    inputs: Dict[str, np.ndarray]         # per-image inputs, keyed by name
    t_submit: float
    t_batch: float = 0.0                  # popped from queue (assembly start)
    t_exec0: float = 0.0
    t_done: float = 0.0
    batch: int = 0                        # variant the request rode in
    output: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass(frozen=True)
class Flush:
    """One flush: the variant it ran, the requests it served, its arena's
    bytes on the device, the specs of its program (one kernel launch each)
    and the seconds of upload, kernels and download."""
    batch: int
    requests: int
    arena_bytes: int
    specs: int
    execute_s: float


class PlanServer:
    """Route queued requests onto the largest compiled batch variant that
    fits the arena budget.

    One ``compile(graph, batch=b)`` per ``b`` in ``batches``; variants whose
    arena ``peak_bytes`` exceed ``arena_budget`` are dropped (the device
    could not hold their arena). Requests queue until either enough are
    waiting to fill the largest admitted variant or the oldest request's
    ``max_delay_s`` deadline expires; each flush runs the largest variant
    that the queue can fill (padding up to the smallest variant only when
    forced to drain a short tail).

    ``device``: None (the card; raises without one), ``"cuda"``/``"cuda:N"``
    or ``"cpu"`` (the kernels' plain versions). Each flush runs its
    variant's flat arena program there.
    """

    def __init__(self, graph: Graph, *, arena_budget: Optional[int] = None,
                 batches: Sequence[int] = (1, 2, 4, 8),
                 max_delay_s: float = 0.002, seed: int = 0, device=None,
                 **compile_kwargs):
        from repro_torch.core.exec.cuda_backend import CudaExecutor
        from repro_torch.core.pipeline import (cache_info,
                                               compile as compile_graph)
        self._runner = CudaExecutor(device=device, layout="flat")
        self.device = self._runner.device
        self.graph = graph
        self.arena_budget = arena_budget
        self.max_delay_s = max_delay_s
        before = cache_info()
        self.variants = {}
        self.rejected: Dict[int, int] = {}    # b -> peak that broke budget
        for b in sorted(set(int(b) for b in batches)):
            cp = compile_graph(graph, batch=b, **compile_kwargs)
            if arena_budget is None or cp.peak_bytes <= arena_budget:
                self.variants[b] = cp
            else:
                self.rejected[b] = cp.peak_bytes
        if not self.variants:
            raise ValueError(
                f"arena budget {arena_budget} admits no batch variant of "
                f"{graph.name!r} (smallest peak: "
                f"{min(self.rejected.values())} bytes)")
        after = cache_info()
        self._cache_delta = {k: after[k] - before[k]
                             for k in ("hits", "misses",
                                       "disk_hits", "disk_misses")}
        self._exec = FastExec(graph, seed=seed)
        #: b -> (weights, QuantSpec or None) of the variant, kept so the
        #: executor's identity-keyed caches upload each filter once
        self.params = {b: variant_params(graph, self._exec.weights,
                                         self._exec.quant, cp.graph)
                       for b, cp in self.variants.items()}
        self._inputs = [t for t in graph.tensors if t.kind == "input"]
        self._outputs = [t for t in graph.tensors if t.kind == "output"]
        self.queue: deque = deque()
        self.done: List[ServeRequest] = []
        self.flushes: List[Flush] = []
        self.batches_run: Dict[int, int] = {b: 0 for b in self.variants}
        self._next_rid = 0
        self._t0: Optional[float] = None
        self._t_last: float = 0.0

    # -- queue ---------------------------------------------------------
    def submit(self, inputs: Dict[str, np.ndarray]) -> int:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        req = ServeRequest(self._next_rid, inputs, now)
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def _pick_batch(self, force: bool) -> Optional[int]:
        if not self.queue:
            return None
        bs = sorted(self.variants)
        if len(self.queue) >= bs[-1]:
            return bs[-1]
        age = time.perf_counter() - self.queue[0].t_submit
        if not force and age < self.max_delay_s:
            return None                  # deadline not hit: keep batching
        fit = [b for b in bs if b <= len(self.queue)]
        return fit[-1] if fit else bs[0]  # pad up to the smallest variant

    # -- execution -----------------------------------------------------
    def _stack(self, reqs: List[ServeRequest], b: int) -> Dict[str, np.ndarray]:
        """The batch's input tensors, ``(b,) + shape`` each: float values
        fed to an int8 input quantised at the server's params (the arena
        holds raw int8), a tail shorter than ``b`` padded by repeating its
        last request."""
        quant = self._exec.quant
        out = {}
        for t in self._inputs:
            v = np.stack([np.asarray(reqs[min(i, len(reqs) - 1)]
                                     .inputs[t.name]) for i in range(b)])
            if t.dtype_bytes == 1 and v.dtype != np.int8:
                v = quantise(v.astype(np.float32), quant.tensors[t.name])
            out[t.name] = v
        return out

    def step(self, force: bool = False) -> int:
        """Flush at most one batch; returns the number of requests served."""
        b = self._pick_batch(force)
        if b is None:
            return 0
        with trace.span("repro/plan_server/flush", batch=b,
                        requests=min(b, len(self.queue))):
            return self._flush(b)

    def _flush(self, b: int) -> int:
        now = time.perf_counter()
        reqs = [self.queue.popleft()
                for _ in range(min(b, len(self.queue)))]
        for r in reqs:
            r.t_batch, r.batch = now, b
        stacked = self._stack(reqs, b)
        cp = self.variants[b]
        weights, quant = self.params[b]
        t_exec0 = time.perf_counter()
        specs, ws, descs, arena = self._runner.program(
            cp, stacked, weights, quant=quant)
        for spec, w, d in zip(specs, ws, descs):
            apply_op(arena, spec, w, d)
        outs = self._runner.outputs(cp, arena)
        t_done = time.perf_counter()
        for t in self._outputs:
            # a batch-1 variant's outputs carry no batch axis
            outs[t.name] = outs[t.name].reshape((b,) + tuple(t.shape))
        for i, r in enumerate(reqs):
            r.t_exec0, r.t_done = t_exec0, t_done
            r.output = {k: v[i] for k, v in outs.items()}
        self.done.extend(reqs)
        self.flushes.append(Flush(b, len(reqs),
                                  arena.numel() * arena.element_size(),
                                  len(specs), t_done - t_exec0))
        self.batches_run[b] += 1
        self._t_last = t_done
        return len(reqs)

    def drain(self) -> int:
        """Serve everything queued (forcing deadline flushes); returns the
        number of requests served."""
        n = 0
        while self.queue:
            n += self.step(force=True)
        return n

    # -- reporting -----------------------------------------------------
    def spans(self) -> List[Dict[str, Any]]:
        """Request-level timing spans (seconds relative to the first
        submit): queue wait, batch assembly, execute."""
        t0 = self._t0 or 0.0
        return [{"rid": r.rid, "batch": r.batch,
                 "t_submit": r.t_submit - t0,
                 "queue_wait_s": r.t_batch - r.t_submit,
                 "assemble_s": r.t_exec0 - r.t_batch,
                 "execute_s": r.t_done - r.t_exec0}
                for r in self.done]

    def stats(self) -> Dict[str, Any]:
        n = len(self.done)
        waits = [r.t_batch - r.t_submit for r in self.done]
        total = self._cache_delta["hits"] + self._cache_delta["misses"]
        wall = (self._t_last - self._t0) if (self._t0 and n) else 0.0
        return {
            "model": self.graph.name,
            "arena_budget": self.arena_budget,
            "batches": sorted(self.variants),
            "rejected_batches": dict(self.rejected),
            "per_batch_peak_bytes": {b: cp.peak_bytes
                                     for b, cp in self.variants.items()},
            "batches_run": dict(self.batches_run),
            "requests_served": n,
            "queued": len(self.queue),
            "plan_cache": {**self._cache_delta,
                           "hit_rate": round(
                               self._cache_delta["hits"] / total, 3)
                           if total else None},
            "mean_queue_wait_ms": round(1e3 * sum(waits) / n, 3) if n else 0,
            "throughput_inf_s": round(n / wall, 1) if wall > 0 else None,
        }


def throughput_demo(graph: Graph, *, n_requests: int = 256,
                    arena_budget: Optional[int] = None,
                    batches: Sequence[int] = (1, 2, 4, 8),
                    seed: int = 0, device=None,
                    **compile_kwargs) -> Dict[str, Any]:
    """Closed-loop serving demo: submit ``n_requests`` synthetic requests,
    drain the server, return its stats (throughput in inferences/sec,
    per-batch arena peaks, cache hit rate). Flushes run on ``device`` (the
    card by default)."""
    server = PlanServer(graph, arena_budget=arena_budget, batches=batches,
                        seed=seed, device=device, **compile_kwargs)
    rng = np.random.default_rng(seed + 1)
    names = [t.name for t in graph.tensors if t.kind == "input"]
    shapes = {t.name: tuple(t.shape)
              for t in graph.tensors if t.kind == "input"}
    for _ in range(n_requests):
        server.submit({nm: rng.standard_normal(shapes[nm]).astype(np.float32)
                       for nm in names})
        server.step()            # serve opportunistically while loading
    server.drain()
    return server.stats()
