"""CUDA arena executor: lower a plan to the flat byte program and run it in
ONE uint8 device tensor through hand-written sm_90a kernels.

The counterpart of the reference's Pallas backend. Its flat program is the
one this backend runs: the arena is a 1-D uint8 tensor of exactly
``plan.peak_bytes`` (no tiling constraint on this card, so no row-blocked
padding), operands sit at the planner's byte offsets, and each lowered
:class:`~repro_torch.kernels.arena_ops.OpSpec` runs in place through its
kernel wrapper in :mod:`repro_torch.kernels.arena_ops`. A fused band chain
lowers to one spec and one launch whose chain-internal tensors live in the
kernel's scratch, never in the arena.

The row-blocked and streaming programs of the reference are not ported yet
(``layout="blocks"`` and ``mode="streaming"`` raise).

Device: the executor runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version; with no card and no explicit CPU request it raises. Nothing on the
CUDA route falls back to a plain version.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exec import ops as X
from repro_torch.core.exec import unwrap_plan
from repro_torch.core.graph import Op
from repro_torch.core.planner import Plan, fused_slots
from repro_torch.kernels import arena_ops as K


def _fused_chains(order: Sequence[Op]) -> Dict[str, List[Op]]:
    """Chain-name -> members (in order) for a fused graph's execution order,
    with the contiguity check the weight order relies on: a chain's members
    must be consecutive in the order so the fused spec (emitted at the first
    member's position) consumes consecutive stage weights."""
    chains: Dict[str, List[Op]] = {}
    pos: Dict[str, int] = {}
    for i, op in enumerate(order):
        cname = op.params.get("fuse_chain")
        if cname is None:
            continue
        if cname in pos and pos[cname] != i - 1:
            raise ValueError(
                f"fused chain {cname!r} is not contiguous in execution order")
        pos[cname] = i
        chains.setdefault(cname, []).append(op)
    return chains


def _canon_meta(op: Op) -> Tuple:
    """Kind-specific static parameters for the kernel (see arena_ops)."""
    k = op.kind
    if k in ("conv2d", "depthwise_conv2d"):
        kh, kw = op.params["kernel"]
        sh, sw = op.params.get("stride", (1, 1))
        dh, dw = op.params.get("dilation", (1, 1))
        ph, pw = X.pads(op)
        return (kh, kw, sh, sw, dh, dw, ph, pw,
                op.params.get("multiplier", 1))
    if k == "pool":
        kh, kw = op.params["kernel"]
        sh, sw = op.params.get("stride", (1, 1))
        ph, pw = X.pads(op)
        return (kh, kw, sh, sw, ph, pw, op.params.get("mode", "avg"))
    if k == "elementwise":
        return (op.params.get("fn", "relu"),)
    if k == "concat":
        return (op.params.get("axis", -1),)
    if k == "pad":
        return (tuple(tuple(p) for p in op.params["paddings"]),)
    if k == "mean":
        x = op.inputs[0]
        return (tuple(op.params.get("axes", range(len(x.shape) - 1))),)
    return ()


def _canon_qmeta(op: Op, q: Optional[X.OpQuant]) -> Tuple:
    """Hashable quantisation statics per kind: zero points and the float32
    requantisation multipliers of :func:`~repro_torch.core.exec.ops.
    acc_multiplier` / :func:`~repro_torch.core.exec.ops.rescale_q`, so every
    backend bakes the bit-identical constants."""
    if q is None:
        return ()
    k = op.kind
    if k in ("conv2d", "depthwise_conv2d", "fully_connected", "pool", "mean"):
        return (q.ins[0].zero_point, X.acc_multiplier(op, q),
                q.out.zero_point)
    if k == "matmul":
        return (q.ins[0].zero_point, q.ins[1].zero_point,
                X.acc_multiplier(op, q), q.out.zero_point)
    if k in ("elementwise", "softmax"):
        in_q = tuple((qp.scale, qp.zero_point) for qp in q.ins)
        out_q = (q.out.scale, q.out.zero_point)
        return (in_q[0], out_q) if k == "softmax" else (in_q, out_q)
    if k == "concat":
        in_q = tuple((qp.zero_point, X.f32_div(qp.scale, q.out.scale))
                     for qp in q.ins)
        return (in_q, (q.out.zero_point,))
    if k == "pad":
        return ((q.ins[0].zero_point,
                 X.f32_div(q.ins[0].scale, q.out.scale)),
                (q.out.zero_point,))
    return ()


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the cuda backend runs on the card and no CUDA device is "
                "visible; pass device='cpu' to run the kernels' plain "
                "PyTorch versions instead")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "visible")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the cuda backend runs on 'cuda' or 'cpu', not "
                         f"{dev}")
    return dev


#: Bounds of the per-executor caches (FIFO).
_CACHE_PLANS = 32
_CACHE_DESCS = 512


class CudaExecutor:
    """The ``cuda`` :class:`~repro_torch.core.exec.ArenaExecutor` backend.

    ``device``: None (the card; raises without one), ``"cuda"``/``"cuda:N"``
    or ``"cpu"`` (every kernel's plain PyTorch version). ``layout`` and
    ``mode`` name the reference's other programs, which are not ported
    yet."""

    name = "cuda"

    def __init__(self, device=None, layout: str = "flat",
                 mode: Optional[str] = None):
        if layout == "blocks":
            raise NotImplementedError(
                "layout='blocks' (the row-blocked program) is ROADMAP queue "
                "1, item 1: the blocked addressing of the next slice")
        if layout != "flat":
            raise ValueError(f"unknown cuda layout {layout!r} (expected "
                             "'flat')")
        if mode == "streaming":
            raise NotImplementedError(
                "mode='streaming' is ROADMAP queue 1, item 3: the streaming "
                "kernels come after the blocked addressing")
        if mode is not None:
            raise ValueError(f"unknown cuda mode {mode!r}")
        self.device = _resolve_device(device)
        #: (plan identity, quant identity) -> (plan, quant, spec tuple);
        #: values pin the keyed objects so the id() keys stay valid
        self._lowered: "collections.OrderedDict" = collections.OrderedDict()
        #: synth_weights/calibrate results per (plan identity, seed)
        self._autoparams: "collections.OrderedDict" = collections.OrderedDict()
        #: device weights per (plan, weights, quant) identity: one entry per
        #: spec (None, a filter, or a fused chain's packed blob)
        self._weights: "collections.OrderedDict" = collections.OrderedDict()
        #: device descriptor per spec (content-keyed)
        self._descs: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_hits = 0
        self._cache_misses = 0

    def lowering_cache_info(self) -> Dict[str, int]:
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "size": len(self._lowered), "descriptors": len(self._descs)}

    # -- lowering -----------------------------------------------------------

    @staticmethod
    def _flat_off(plan: Plan, t, b: int) -> int:
        """Byte offset of image ``b`` of a flat-arena operand (batch-1
        operands are shared across images)."""
        s = t.storage()
        off = plan._layout(t).byte_offset
        return off + b * s.image_nbytes if s.batch > 1 else off

    def lower(self, plan: Plan,
              quant: Optional[X.QuantSpec] = None) -> Tuple[K.OpSpec, ...]:
        """Plan -> flat-program OpSpec sequence with byte offsets per
        operand. ``quant`` must be supplied for plans with int8 ops. A fused
        band chain lowers to ONE spec at its first member's position.
        Batched ops expand to one spec per image (image-minor, ascending —
        the order the batched O_s is derived against)."""
        chains = _fused_chains(plan.order)
        emitted: set = set()
        specs: List[K.OpSpec] = []
        for op in plan.order:
            if op.kind == "reshape":
                continue
            cname = op.params.get("fuse_chain")
            if cname is not None:
                if cname not in emitted:
                    emitted.add(cname)
                    specs.append(self._fused_flat_spec(
                        plan, chains[cname], quant))
                continue
            if any(t.storage().kind == "weight" for t in op.inputs):
                raise ValueError(f"{op.name}: non-arena input cannot be "
                                 "lowered")
            lays = [plan._layout(t) for t in op.inputs]
            out = plan._layout(op.output)
            q = X.op_quant(op, quant)
            for b in range(op.output.storage().batch):
                specs.append(K.OpSpec(
                    kind=op.kind,
                    in_off=tuple(self._flat_off(plan, t, b)
                                 for t in op.inputs),
                    in_shape=tuple(l.shape for l in lays),
                    out_off=self._flat_off(plan, op.output, b),
                    out_shape=out.shape,
                    dtype="i8" if out.dtype_bytes == 1 else "f32",
                    meta=_canon_meta(op),
                    qmeta=_canon_qmeta(op, q)))
        return tuple(specs)

    def _fused_flat_spec(self, plan: Plan, members: List[Op],
                         quant: Optional[X.QuantSpec]) -> K.OpSpec:
        """One flat-program spec for a fused band chain: stage offsets are
        byte offsets — arena placements for external operands, packed
        scratch slots (:func:`~repro_torch.core.planner.fused_slots` over
        the batched ``nbytes``) for chain-internal ones. Batched chains
        expand their stages op-major (member-major, image-minor), the order
        the planner's liveness model and the batched O_s assume."""
        cat = members[-1]
        B = cat.output.storage().batch
        internal = {op.output.storage() for op in members[:-1]}
        align = max(s.dtype_bytes for s in internal)
        slots, total = fused_slots(members, lambda s: s.nbytes, align=align)
        stages: List[K.OpSpec] = []
        for op in members:
            q = X.op_quant(op, quant)
            for b in range(B):
                in_off, in_scr = [], []
                for t in op.inputs:
                    s = t.storage()
                    if s in internal:
                        in_off.append(slots[s] + b * s.image_nbytes)
                        in_scr.append(1)
                    else:
                        in_off.append(self._flat_off(plan, t, b))
                        in_scr.append(0)
                s_out = op.output.storage()
                if s_out in internal:
                    out_off = slots[s_out] + b * s_out.image_nbytes
                    out_scr = 1
                else:
                    out_off = self._flat_off(plan, op.output, b)
                    out_scr = 0
                stages.append(K.OpSpec(
                    kind=op.kind,
                    in_off=tuple(in_off),
                    in_shape=tuple(tuple(t.shape) for t in op.inputs),
                    out_off=out_off,
                    out_shape=tuple(op.output.shape),
                    dtype="i8" if op.output.storage().dtype_bytes == 1
                    else "f32",
                    meta=_canon_meta(op),
                    qmeta=_canon_qmeta(op, q),
                    in_scratch=tuple(in_scr),
                    out_scratch=out_scr))
        ext = self._chain_ext_inputs(members, internal)
        out_lay = plan._layout(cat.output)
        return K.OpSpec(
            kind="fused",
            in_off=tuple(self._flat_off(plan, t, 0) for t in ext),
            in_shape=tuple(tuple(t.shape) for t in ext),
            out_off=self._flat_off(plan, cat.output, 0),
            out_shape=out_lay.shape,
            dtype="i8" if out_lay.dtype_bytes == 1 else "f32",
            meta=(cat.params["fuse_chain"],),
            stages=tuple(stages),
            scratch_rows=total)          # bytes in the flat program

    @staticmethod
    def _chain_ext_inputs(members: List[Op], internal) -> List:
        """The chain's external data inputs, deduped in first-read order."""
        ext, seen = [], set()
        for op in members:
            for t in op.inputs:
                s = t.storage()
                if s.kind == "weight" or s in internal or s in seen:
                    continue
                seen.add(s)
                ext.append(t)
        return ext

    # -- execution ----------------------------------------------------------

    def _specs(self, plan: Plan, quant) -> Tuple[K.OpSpec, ...]:
        key = (id(plan), id(quant) if quant is not None else None)
        cached = self._lowered.get(key)
        if cached is not None and cached[0] is plan and cached[1] is quant:
            self._cache_hits += 1
            return cached[2]
        self._cache_misses += 1
        specs = self.lower(plan, quant)
        self._lowered[key] = (plan, quant, specs)
        while len(self._lowered) > _CACHE_PLANS:
            self._lowered.popitem(last=False)
        return specs

    def _device_weights(self, plan: Plan, specs, weights, quant) -> List:
        """Per spec: None, the op's filter, or a fused chain's packed blob,
        on the executor's device. The order mirrors the per-image spec and
        stage expansion: a batched op repeats its filter per image, a
        batched chain's weighted members repeat theirs consecutively."""
        key = (id(plan), id(weights), id(quant) if quant is not None else None)
        cached = self._weights.get(key)
        if cached is not None and cached[0] is plan and cached[1] is weights \
                and cached[2] is quant:
            return cached[3]
        uploaded: Dict[int, torch.Tensor] = {}

        def w_of(op) -> torch.Tensor:
            t = uploaded.get(id(op))
            if t is None:
                if quant is not None and id(op) in quant.weights_q:
                    arr = np.asarray(quant.weights_q[id(op)]["filter"],
                                     np.int8)
                else:
                    arr = np.asarray(weights[id(op)]["filter"], np.float32)
                t = uploaded[id(op)] = torch.from_numpy(
                    np.ascontiguousarray(arr)).to(self.device)
            return t

        chains = _fused_chains(plan.order)
        emitted: set = set()
        per_spec: List = []
        for op in plan.order:
            if op.kind == "reshape":
                continue
            cname = op.params.get("fuse_chain")
            if cname is not None:
                if cname in emitted:
                    continue
                emitted.add(cname)
                stage_ws = [w_of(m) for m in chains[cname]
                            if m.kind in K.WEIGHTED_KINDS
                            for _ in range(m.output.storage().batch)]
                per_spec.append(K.pack_weights(specs[len(per_spec)],
                                               stage_ws))
                continue
            for _ in range(op.output.storage().batch):
                per_spec.append(w_of(op) if op.kind in K.WEIGHTED_KINDS
                                else None)
        if len(per_spec) != len(specs):
            raise AssertionError(f"weights for {len(per_spec)} specs, "
                                 f"lowered {len(specs)}")
        self._weights[key] = (plan, weights, quant, per_spec)
        while len(self._weights) > _CACHE_PLANS:
            self._weights.popitem(last=False)
        return per_spec

    def _descriptor(self, spec: K.OpSpec) -> torch.Tensor:
        d = self._descs.get(spec)
        if d is None:
            d = self._descs[spec] = K.descriptor(spec, self.device)
            while len(self._descs) > _CACHE_DESCS:
                self._descs.popitem(last=False)
        return d

    def program(self, plan_or_compiled, inputs=None, weights=None, *,
                seed: int = 0, quant=None):
        """The lowered program of one execution, ready to run: ``(specs,
        per-spec device weights, descriptors, seeded arena)``. The arena is
        a fresh uint8 tensor of exactly ``plan.peak_bytes`` on the
        executor's device with every model input at its planned offset;
        descriptors are None on the CPU. Inputs, weights and quantisation
        default to the deterministic per-seed synthesis every backend
        shares."""
        plan, graph = unwrap_plan(plan_or_compiled)
        reason = X.executability(graph)
        if reason is not None:
            raise ValueError(
                f"cuda backend cannot lower {graph.name!r}: {reason}")
        if weights is None and quant is None:
            cached = self._autoparams.get((id(plan), seed))
            if cached is not None and cached[0] is plan:
                weights, quant = cached[1], cached[2]
            else:
                weights = X.synth_weights(graph, seed)
                if X.needs_quant(graph):
                    quant = X.calibrate(graph, seed, weights)
                self._autoparams[(id(plan), seed)] = (plan, weights, quant)
                while len(self._autoparams) > _CACHE_PLANS:
                    self._autoparams.popitem(last=False)
        if weights is None:
            weights = X.synth_weights(graph, seed)
        if quant is None and X.needs_quant(graph):
            quant = X.calibrate(graph, seed, weights)
        if inputs is None:
            inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
                      else X.random_inputs(graph, seed))

        specs = self._specs(plan, quant)
        ws = self._device_weights(plan, specs, weights, quant)
        descs = ([self._descriptor(s) for s in specs]
                 if self.device.type == "cuda" else [None] * len(specs))
        host = np.zeros(plan.peak_bytes, np.uint8)
        for t in graph.tensors:
            if t.kind == "input":
                s, off = t.storage(), plan.offsets[t.storage()]
                v = np.asarray(inputs[t.name],
                               X.arena_dtype(s.dtype_bytes)).reshape(-1)
                host[off:off + s.nbytes] = v.view(np.uint8)
        return specs, ws, descs, torch.from_numpy(host).to(self.device)

    def execute(self, plan_or_compiled, inputs=None, weights=None, *,
                seed: int = 0, quant=None) -> Dict[str, np.ndarray]:
        plan, graph = unwrap_plan(plan_or_compiled)
        specs, ws, descs, arena = self.program(
            plan, inputs, weights, seed=seed, quant=quant)
        for spec, w, d in zip(specs, ws, descs):
            K.apply_op(arena, spec, w, d)
        out_arena = arena.cpu().numpy()
        outs: Dict[str, np.ndarray] = {}
        for t in graph.tensors:
            if t.kind == "output":
                s, off = t.storage(), plan.offsets[t.storage()]
                outs[t.name] = out_arena[off:off + s.nbytes].view(
                    X.arena_dtype(s.dtype_bytes)).reshape(X.tensor_shape(t))
        return outs
