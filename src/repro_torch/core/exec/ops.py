"""Shared per-op row/tensor semantics for every arena executor backend.

This is the single place the repo defines *what an op computes* and *in which
element order* — the row-ascending reference semantics the paper's safe
overlap ``O_s`` is derived against (§III.A: reads of an output row's inputs
happen no later, and its write no earlier, than the reference element order).
Backends reuse these definitions rather than re-deriving them:

- the ``numpy`` backend (:mod:`repro_torch.core.exec.numpy_backend`) calls
  :func:`conv_row` / :func:`pool_row` / :func:`eval_op` directly;
- the ``pallas`` backend (:mod:`repro_torch.core.exec.pallas_backend`) mirrors the
  same loop nests in its kernels (:mod:`repro_torch.kernels.arena_ops`) and is
  cross-checked against the numpy backend by the pipeline's verify pass.

Every kernel is **dtype-parameterised**: with ``q=None`` it runs the f32
reference semantics; with an :class:`OpQuant` context it runs the quantised
tier — int8 storage, int32 accumulation, per-tensor scale/zero-point
requantisation (TFLite-micro affine convention: asymmetric int8 activations,
symmetric int8 weights). The requantisation arithmetic is float32 end to end
(:func:`requantise`), formula-for-formula identical to the jnp mirrors in
:mod:`repro_torch.kernels.arena_ops`, so the two backends agree to <= 1 LSB.

Weight synthesis lives here too, so all backends execute the same network:
weights are deterministic per (graph, seed) and keyed by op identity.
Quantisation parameters come from :func:`calibrate` — a float reference run
records per-tensor ranges, exactly the post-training calibration step of the
paper's 8-bit TFLite models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph, Op, Tensor, band_range, op_pads

#: Op kinds every arena executor implements. An op kind outside this set
#: cannot be executed (and therefore not numerically verified or lowered).
SUPPORTED_KINDS = frozenset({
    "conv2d", "depthwise_conv2d", "pool", "elementwise", "softmax",
    "fully_connected", "matmul", "concat", "pad", "mean", "reshape",
})

#: Arena dtype widths the executor backends implement, mapped to the numpy
#: dtype a byte-arena view uses. (f16 plans are plannable but not executable.)
SUPPORTED_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype(np.int8),
    4: np.dtype(np.float32),
}

#: Elementwise function table shared by all backends (numpy ufunc semantics;
#: the pallas backend maps these 1:1 onto jnp equivalents).
ELEMENTWISE = {
    "relu": lambda a: np.maximum(a, 0.0),
    "relu6": lambda a: np.clip(a, 0.0, 6.0),
    "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "identity": lambda a: a,
    "add": lambda a, b: a + b,
    "mul": lambda a, b: a * b,
    "sub": lambda a, b: a - b,
}


def arena_dtype(dtype_bytes: int) -> np.dtype:
    """Numpy dtype a byte-arena view uses for a tensor of this width."""
    return SUPPORTED_DTYPES[dtype_bytes]


def weights_for(op: Op, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Deterministic random weights per op (same for every backend),
    fan-in-scaled (He style) so activation magnitudes stay O(1) through
    arbitrarily deep graphs — unscaled gaussians blow up to ~1e16 after ~30
    conv layers, which destroys f32 precision and makes post-training
    calibration (and therefore the int8 tier) degenerate."""
    w: Dict[str, np.ndarray] = {}
    if op.kind == "conv2d":
        kh, kw = op.params["kernel"]
        ic = op.inputs[0].shape[-1]
        oc = op.output.shape[-1]
        w["filter"] = (rng.standard_normal((kh, kw, ic, oc))
                       / np.sqrt(kh * kw * ic)).astype(np.float32)
    elif op.kind == "depthwise_conv2d":
        kh, kw = op.params["kernel"]
        ic = op.inputs[0].shape[-1]
        kc = op.params.get("multiplier", 1)
        w["filter"] = (rng.standard_normal((kh, kw, ic, kc))
                       / np.sqrt(kh * kw)).astype(np.float32)
    elif op.kind == "fully_connected":
        idim = op.inputs[0].shape[-1]
        od = op.output.shape[-1]
        w["filter"] = (rng.standard_normal((idim, od))
                       / np.sqrt(idim)).astype(np.float32)
    return w


def synth_weights(graph: Graph, seed: int = 0) -> Dict[int, Dict[str, np.ndarray]]:
    """All weights of a graph, keyed by ``id(op)``. The rng is consumed in
    op order, so every backend handed the same (graph, seed) pair executes
    the identical network.

    Split row bands (ops carrying ``split_src``) share ONE draw per source
    op: every band of a split conv convolves the same filter — and since a
    band's filter has the source op's shape, the split graph's rng stream
    stays position-for-position aligned with its unsplit reference, so the
    two graphs execute the identical network (the property the split-vs-
    unsplit verification tier rests on)."""
    rng = np.random.default_rng(seed)
    out: Dict[int, Dict[str, np.ndarray]] = {}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for op in graph.ops:
        src = op.params.get("split_src")
        if src is not None and src in groups:
            out[id(op)] = groups[src]
            continue
        w = weights_for(op, rng)
        out[id(op)] = w
        if src is not None:
            groups[src] = w
    return out


def tensor_shape(t: Tensor) -> Tuple[int, ...]:
    """Runtime array shape of a tensor's value: the per-image shape with the
    batch axis prepended when the tensor is batched. Backends execute batched
    tensors image by image (the per-image kernels above never see the batch
    axis), so this is the only place the value shape and the plan shape
    diverge."""
    return ((t.batch,) + tuple(t.shape)) if t.batch > 1 else tuple(t.shape)


def random_inputs(graph: Graph, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random model inputs (float32), keyed by tensor name.
    These are the *real-valued* inputs; int8 graphs quantise them through
    :func:`quant_inputs` after calibration. Batched inputs draw
    ``(batch,) + shape`` from the same rng stream, so image 0 of a batched
    input is bit-identical to the batch-1 input at the same seed."""
    rng = np.random.default_rng(seed + 1)
    return {
        t.name: rng.standard_normal(tensor_shape(t)).astype(np.float32)
        for t in graph.tensors if t.kind == "input"
    }


# ---------------------------------------------------------------------------
# Quantisation (the paper's 8-bit TFLite-micro tier)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QParams:
    """Per-tensor affine quantisation: ``real = (q - zero_point) * scale``."""
    scale: float
    zero_point: int


@dataclasses.dataclass
class QuantSpec:
    """Quantisation of one (graph, seed, weights) triple: per-tensor
    activation params plus symmetric int8 weights per weighted op. Built by
    :func:`calibrate`; shared by every backend so they execute the identical
    quantised network."""
    tensors: Dict[str, QParams]                  # storage tensor name -> params
    weight_scale: Dict[int, float]               # id(op) -> weight scale
    weights_q: Dict[int, Dict[str, np.ndarray]]  # id(op) -> int8 weights


@dataclasses.dataclass(frozen=True)
class OpQuant:
    """Per-op quantised execution context: params of each arena input, of the
    output, and the (symmetric) weight scale for weighted kinds."""
    ins: Tuple[QParams, ...]
    out: QParams
    wscale: float = 0.0


def needs_quant(graph: Graph) -> bool:
    """True when any data tensor (arena or fused-chain scratch) is int8 —
    execution then requires a :class:`QuantSpec`."""
    return any(t.dtype_bytes == 1 for t in graph.data_tensors())


def quantise(x: np.ndarray, qp: QParams) -> np.ndarray:
    """f32 -> int8 at the tensor's affine params (round half-to-even, the
    convention both numpy and jnp share)."""
    q = np.round(x.astype(np.float32) / np.float32(qp.scale)) + qp.zero_point
    return np.clip(q, -128, 127).astype(np.int8)


def dequantise(q: np.ndarray, qp: QParams) -> np.ndarray:
    """int8 -> f32 at the tensor's affine params."""
    return (q.astype(np.float32) - np.float32(qp.zero_point)) \
        * np.float32(qp.scale)


def requantise(acc: np.ndarray, mult: float, zp: int) -> np.ndarray:
    """int32 accumulator (or f32 partial) -> int8 output: scale by the f32
    multiplier, round, re-centre on the output zero point, saturate. The jnp
    kernels implement this formula operation-for-operation, so backend
    outputs agree to the last rounding ulp."""
    q = np.round(acc.astype(np.float32) * np.float32(mult)) + zp
    return np.clip(q, -128, 127).astype(np.int8)


def rescale_q(x: np.ndarray, src: QParams, dst: QParams) -> np.ndarray:
    """int8 -> int8 between two affine params (concat/pad input alignment)."""
    mult = f32_div(src.scale, dst.scale)
    return requantise(x.astype(np.int32) - src.zero_point, mult,
                      dst.zero_point)


def f32_div(a: float, b: float) -> float:
    """a / b evaluated in float32 — the shared multiplier precision, so both
    backends bake the bit-identical constant into their requantisation."""
    return float(np.float32(np.float32(a) / np.float32(b)))


def acc_multiplier(op: Op, q: OpQuant) -> float:
    """The requantisation multiplier of an int32-accumulating op, evaluated
    in float32: ``s_x * s_w / s_y`` for conv/depthwise/fully_connected,
    ``s_a * s_b / s_y`` for matmul, ``s_x / s_y`` for pool/mean."""
    if op.kind in ("conv2d", "depthwise_conv2d", "fully_connected"):
        num = np.float32(np.float32(q.ins[0].scale) * np.float32(q.wscale))
    elif op.kind == "matmul":
        num = np.float32(np.float32(q.ins[0].scale) * np.float32(q.ins[1].scale))
    else:  # pool / mean: storage passthrough scale
        num = np.float32(q.ins[0].scale)
    return float(np.float32(num / np.float32(q.out.scale)))


def calibrate(graph: Graph, seed: int = 0,
              weights: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
              ) -> QuantSpec:
    """Post-training calibration: run the float32 reference once, record each
    arena tensor's observed range (forced to include 0, the TFLite
    convention), and derive asymmetric int8 activation params plus symmetric
    int8 weights (zero_point 0, -128 reserved).

    Band pieces of one split op (``split_src`` provenance) pool their ranges
    into one group, so every band quantises at the params the *unsplit*
    tensor would calibrate to — the bands jointly observe exactly the
    reference tensor's values, and the shared params make a split graph's
    int8 execution elementwise-identical to its unsplit reference (the
    concat realigning the bands becomes a lossless identity rescale)."""
    from repro_torch.core.exec.numpy_backend import ReferenceExec  # lazy: no cycle
    if weights is None:
        weights = synth_weights(graph, seed)
    ex = ReferenceExec(graph, random_inputs(graph, seed), seed, weights)
    ex.run()
    group_of: Dict[Tensor, str] = {}
    for op in graph.ops:
        src = op.params.get("split_src")
        if src is not None:
            group_of[op.output.storage()] = src
    ranges: Dict[str, Tuple[float, float]] = {}
    # data_tensors, not arena_tensors: fused-chain scratch tensors never
    # occupy the arena but still need activation params (the fused kernel
    # requantises every stage exactly like the unfused execution)
    for t in graph.data_tensors():
        v = ex.vals.get(t)
        lo = float(min(0.0, v.min())) if v is not None and v.size else -1.0
        hi = float(max(0.0, v.max())) if v is not None and v.size else 1.0
        key = group_of.get(t, t.name)
        if key in ranges:
            lo, hi = min(lo, ranges[key][0]), max(hi, ranges[key][1])
        ranges[key] = (lo, hi)
    tensors: Dict[str, QParams] = {}
    for t in graph.data_tensors():
        lo, hi = ranges[group_of.get(t, t.name)]
        scale = (hi - lo) / 255.0 or 1.0
        zp = int(np.clip(round(-128.0 - lo / scale), -128, 127))
        tensors[t.name] = QParams(scale, zp)
    wscale: Dict[int, float] = {}
    wq: Dict[int, Dict[str, np.ndarray]] = {}
    for op in graph.ops:
        w = weights.get(id(op), {})
        if "filter" in w and op.output.storage().dtype_bytes == 1:
            s = (float(np.abs(w["filter"]).max()) / 127.0) or 1.0
            wscale[id(op)] = s
            wq[id(op)] = {"filter": np.clip(
                np.round(w["filter"] / np.float32(s)), -127, 127
            ).astype(np.int8)}
    return QuantSpec(tensors, wscale, wq)


def params_from_reference(ref_graph, ref_weights, ref_quant, graph: Graph
                          ) -> Tuple[Dict[int, Dict[str, np.ndarray]],
                                     Optional[QuantSpec]]:
    """Carry another package's weights and quantisation onto ``graph``.

    ``ref_graph`` is the same network built by another package (the JAX
    reference, say): its ops carry the same names in the same order.
    ``ref_weights`` is keyed by ``id(ref_op)`` and ``ref_quant`` (or None)
    has ``tensors`` (name -> object with ``scale``/``zero_point``),
    ``weight_scale`` and ``weights_q`` keyed by ``id(ref_op)``, as
    :class:`QuantSpec` has. They are read by duck typing, so this module
    imports nothing of the other package. Returns this package's
    ``(weights, QuantSpec or None)``, re-keyed by ``id(op)`` of ``graph``'s
    ops, as numpy arrays."""
    ref_ops = list(ref_graph.ops)
    if [op.name for op in ref_ops] != [op.name for op in graph.ops]:
        raise ValueError("graphs differ: op names do not match in order")
    pairs = list(zip(ref_ops, graph.ops))
    weights = {id(op): {k: np.array(v) for k, v in
                        ref_weights.get(id(rop), {}).items()}
               for rop, op in pairs}
    if ref_quant is None:
        return weights, None
    tensors = {name: QParams(float(qp.scale), int(qp.zero_point))
               for name, qp in ref_quant.tensors.items()}
    wscale = {id(op): float(ref_quant.weight_scale[id(rop)])
              for rop, op in pairs if id(rop) in ref_quant.weight_scale}
    wq = {id(op): {k: np.array(v, np.int8) for k, v in
                   ref_quant.weights_q[id(rop)].items()}
          for rop, op in pairs if id(rop) in ref_quant.weights_q}
    return weights, QuantSpec(tensors, wscale, wq)


def quant_inputs(graph: Graph, spec: QuantSpec,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """The deterministic model inputs of :func:`random_inputs`, with int8
    input tensors quantised at their calibrated params."""
    floats = random_inputs(graph, seed)
    return {
        t.name: (quantise(floats[t.name], spec.tensors[t.name])
                 if t.dtype_bytes == 1 else floats[t.name])
        for t in graph.tensors if t.kind == "input"
    }


def op_quant(op: Op, spec: Optional[QuantSpec]) -> Optional[OpQuant]:
    """Quantised execution context for one op, or ``None`` when the op runs
    the f32 tier (f32 output, or no spec at all)."""
    if spec is None or op.output.storage().dtype_bytes != 1:
        return None
    ins = tuple(spec.tensors[t.storage().name] for t in op.inputs
                if t.storage().kind != "weight")
    return OpQuant(ins, spec.tensors[op.output.storage().name],
                   spec.weight_scale.get(id(op), 0.0))


def pads(op: Op) -> Tuple[int, int]:
    """Leading (ph, pw) pad of a conv/pool op (TF SAME convention). Split
    row bands substitute their explicit per-band pads — see
    :func:`repro_torch.core.graph.op_pads` — which is all the row kernels below
    need to run a band as an ordinary conv over its band shapes."""
    return op_pads(op)


# ---------------------------------------------------------------------------
# Row kernels (conv/pool walk output rows in ascending index order)
# ---------------------------------------------------------------------------


def conv_row(op: Op, x: np.ndarray, filt: np.ndarray, oy: int,
             q: Optional[OpQuant] = None) -> np.ndarray:
    """One output row of conv2d/depthwise (x is HWC). f32 path with
    ``q=None``; int8 path accumulates ``(x - x_zp) * w`` in int32 and
    requantises with the float32 multiplier."""
    ih, iw, ic = x.shape
    oh, ow = op.output.shape[-3], op.output.shape[-2]
    kh, kw = op.params["kernel"]
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    ph, pw = pads(op)
    kc = op.params.get("multiplier", 1)
    oc = op.output.shape[-1] if op.kind == "conv2d" else ic * kc
    if q is not None:
        acc = np.zeros((ow, oc), np.int32)
        x_zp = q.ins[0].zero_point
    else:
        acc = np.zeros((ow, oc), np.float32)
    for fy in range(kh):
        iy = oy * sh - ph + fy * dh
        if not 0 <= iy < ih:
            continue
        row = x[iy]                                           # (iw, ic)
        if q is not None:
            row = row.astype(np.int32) - x_zp
        for fx in range(kw):
            ixs = np.arange(ow) * sw - pw + fx * dw
            valid = (ixs >= 0) & (ixs < iw)
            src = row[np.clip(ixs, 0, iw - 1), :]             # (ow, ic)
            src = np.where(valid[:, None], src, 0 if q is not None else 0.0)
            w = filt[fy, fx]
            if op.kind == "conv2d":
                acc += src @ (w.astype(np.int32) if q is not None else w)
            else:
                w = w.astype(np.int32) if q is not None else w
                acc += (src[:, :, None] * w[None, :, :]).reshape(ow, ic * kc)
    if q is not None:
        return requantise(acc, acc_multiplier(op, q), q.out.zero_point)
    return acc


def pool_row(op: Op, x: np.ndarray, oy: int,
             q: Optional[OpQuant] = None) -> np.ndarray:
    ih, iw, c = x.shape
    ow = op.output.shape[-2]
    kh, kw = op.params["kernel"]
    sh, sw = op.params.get("stride", (1, 1))
    ph, pw = pads(op)
    mode = op.params.get("mode", "avg")
    if q is not None:
        acc = np.full((ow, c), -2147483647 if mode == "max" else 0, np.int32)
    else:
        acc = np.full((ow, c), -np.inf if mode == "max" else 0.0, np.float32)
    cnt = np.zeros((ow, 1), np.float32)
    for fy in range(kh):
        iy = oy * sh - ph + fy
        if not 0 <= iy < ih:
            continue
        for fx in range(kw):
            ixs = np.arange(ow) * sw - pw + fx
            valid = (ixs >= 0) & (ixs < iw)
            src = x[iy, np.clip(ixs, 0, iw - 1), :]
            if q is not None:
                src = src.astype(np.int32)
            if mode == "max":
                acc = np.where(valid[:, None], np.maximum(acc, src), acc)
            else:
                acc += np.where(valid[:, None], src,
                                0 if q is not None else 0.0)
                cnt += valid[:, None].astype(np.float32)
    if q is not None:
        x_zp, mult = q.ins[0].zero_point, acc_multiplier(op, q)
        if mode == "avg":
            val = acc.astype(np.float32) / np.maximum(cnt, 1.0) - x_zp
        else:
            val = acc - x_zp
        return requantise(val, mult, q.out.zero_point)
    if mode == "avg":
        acc = acc / np.maximum(cnt, 1.0)
    return acc


# ---------------------------------------------------------------------------
# Whole-tensor kernels (the non-row op kinds), dtype-parameterised
# ---------------------------------------------------------------------------


def eval_op(op: Op, xs: Sequence[np.ndarray],
            filt: Optional[np.ndarray] = None,
            q: Optional[OpQuant] = None) -> np.ndarray:
    """Evaluate a non-row op on already-loaded arena inputs ``xs`` (weight
    inputs excluded, op order preserved). ``filt`` is the synthesized weight
    where the kind takes one (int8 when ``q`` is set). Returns the output
    tensor value in the op's storage dtype."""
    k = op.kind
    if k == "elementwise":
        fn = ELEMENTWISE[op.params.get("fn", "relu")]
        if q is not None:
            xs = [dequantise(x, qp) for x, qp in zip(xs, q.ins)]
        xs = list(xs)
        if len(xs) == 2 and xs[1].size != xs[0].size:
            xs[1] = np.broadcast_to(xs[1], xs[0].shape)
        if q is not None:
            return quantise(fn(*xs).astype(np.float32), q.out)
        return fn(*xs).astype(np.float32)
    if k == "softmax":
        x = dequantise(xs[0], q.ins[0]) if q is not None else xs[0]
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        y = (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
        return quantise(y, q.out) if q is not None else y
    if k == "fully_connected":
        x = xs[0].reshape(-1, op.inputs[0].shape[-1])
        if q is not None:
            acc = (x.astype(np.int32) - q.ins[0].zero_point) \
                @ filt.astype(np.int32)
            return requantise(acc, acc_multiplier(op, q),
                              q.out.zero_point).reshape(op.output.shape)
        return (x @ filt).reshape(op.output.shape).astype(np.float32)
    if k == "matmul":
        a = xs[0].reshape(-1, op.inputs[0].shape[-1])
        b = xs[1].reshape(op.inputs[1].shape)
        if q is not None:
            acc = (a.astype(np.int32) - q.ins[0].zero_point) \
                @ (b.astype(np.int32) - q.ins[1].zero_point)
            return requantise(acc, acc_multiplier(op, q),
                              q.out.zero_point).reshape(op.output.shape)
        return (a @ b).reshape(op.output.shape).astype(np.float32)
    if k == "concat":
        axis = op.params.get("axis", -1)
        if q is not None:
            xs = [rescale_q(x, qp, q.out) for x, qp in zip(xs, q.ins)]
        return np.concatenate(list(xs), axis=axis)
    if k == "pad":
        if q is not None:
            padded = np.pad(xs[0], op.params["paddings"],
                            constant_values=q.ins[0].zero_point)
            return rescale_q(padded, q.ins[0], q.out)
        return np.pad(xs[0], op.params["paddings"])
    if k == "mean":
        x = xs[0]
        axes = tuple(op.params.get("axes", range(x.ndim - 1)))
        if q is not None:
            cnt = 1
            for ax in axes:
                cnt *= x.shape[ax]
            acc = x.astype(np.int32).sum(axis=axes)
            val = acc.astype(np.float32) / np.float32(cnt) \
                - q.ins[0].zero_point
            return requantise(val, acc_multiplier(op, q),
                              q.out.zero_point).reshape(op.output.shape)
        return x.mean(axis=axes).reshape(op.output.shape).astype(np.float32)
    raise NotImplementedError(f"arena executor: {k}")


# ---------------------------------------------------------------------------
# Lowering gates
# ---------------------------------------------------------------------------


def has_strided_views(graph: Graph) -> bool:
    """Non-trivial aliases (concat-removal views) whose element offsets a
    flat-arena executor cannot represent."""
    return any(t.alias_of is not None and t.elems != t.storage().elems
               for t in graph.tensors)


def executability(graph: Graph) -> Optional[str]:
    """None when every arena backend can execute ``graph``; else a
    human-readable ``"; "``-joined list of *all* refusal reasons (so a mixed
    int8 + split-band graph reports both problems at once, not just the first
    the walk happens to meet)."""
    reasons: List[str] = []

    def add(r: str) -> None:
        if r not in reasons:
            reasons.append(r)

    for op in graph.ops:
        if op.kind not in SUPPORTED_KINDS:
            add(f"unsupported op kind {op.kind!r}")
        rr = band_range(op)
        if rr is not None:
            # a band op executes as an ordinary conv over its band shapes
            # *iff* it carries the explicit band-local pads; legacy split
            # graphs (pre-band_pad) would execute with silently wrong
            # geometry, so they stay refused
            if op.kind not in ("conv2d", "depthwise_conv2d", "pool"):
                add(f"split row bands on non-row-streaming op {op.name} "
                    f"({op.kind!r})")
            elif "band_pad" not in op.params:
                add(f"split row bands without explicit band pads "
                    f"(op {op.name}: legacy split graph)")
            elif rr[1] - rr[0] != op.output.shape[-3]:
                add(f"split row bands: op {op.name} row_range {rr} "
                    f"disagrees with its {op.output.shape[-3]} output rows")
        if op.kind == "elementwise" and \
                op.params.get("fn", "relu") not in ELEMENTWISE:
            add(f"unknown elementwise fn {op.params.get('fn')!r}")
        for t in op.inputs:
            if t.storage().kind == "weight":
                add(f"op {op.name} reads a non-arena (weight) tensor")
        if op.kind != "reshape":
            widths = {t.storage().dtype_bytes for t in op.inputs
                      if t.storage().kind != "weight"}
            widths.add(op.output.storage().dtype_bytes)
            if len(widths) > 1:
                add(f"op {op.name} mixes arena dtypes "
                    f"{sorted(widths)} (no cast ops)")
    for t in graph.data_tensors():
        if t.dtype_bytes not in SUPPORTED_DTYPES:
            add(f"unsupported arena dtype ({t.dtype_bytes}-byte tensor "
                f"{t.name})")
            break
    if has_strided_views(graph):
        add("aggregated views (strided offsets)")
    return "; ".join(reasons) if reasons else None


def executable(graph: Graph) -> bool:
    return executability(graph) is None
