"""CUDA arena executor: lower a plan to one of the reference's in-place
arena programs and run it in ONE device tensor through hand-written sm_90a
kernels.

The counterpart of the reference's Pallas backend, with its three
programs:

- **flat** (``layout="flat"``, the default): the arena is a 1-D uint8
  tensor of exactly ``plan.peak_bytes``, operands at the planner's byte
  offsets. On this card nothing asks for tiles, so the flat arena is the
  planner's peak and nothing more.
- **row-blocked** (``layout="blocks"``): the plan is legalised by
  :func:`~repro_torch.core.planner.legalise_for_blocks` onto the
  reference's TPU tiles, and the arena is one typed ``(total_rows,
  arena_rowlen)`` tensor (int8 or f32) with every operand in whole arena
  rows, packed, spanning or one image row per arena row; the reference's
  own main path (``PallasExecutor(layout="auto")``). Its outputs are
  bit-equal to the flat program's: the kernels are the same, only their
  addressing differs. ``layout="auto"`` runs it where the plan legalises
  and the flat program elsewhere (mixed dtypes, aggregated views), as the
  reference does; ``"blocks"`` raises there.
- **streaming** (``mode="streaming"``): the row-blocked arena and plan,
  but each op copies only its live window
  (:meth:`~repro_torch.core.planner.BlockPlan.window_schedule`) into a
  staging buffer (shared memory where it fits, else a global workspace),
  runs there and copies its output back (:meth:`CudaExecutor.lower_stream`
  grafts the windows onto the blocked specs). Its final arena is bit-equal
  to the row-blocked program's. It requires a row-blocked plan, and as in
  the reference it refuses a plan whose largest resident window exceeds
  the budget (``vmem_budget``, else ``REPRO_DMO_VMEM_BUDGET``, else
  :data:`DEFAULT_VMEM_BUDGET`), so both packages admit the same graphs.

Each lowered :class:`~repro_torch.kernels.arena_ops.OpSpec` runs in place
through its kernel wrapper in :mod:`repro_torch.kernels.arena_ops`. A
fused band chain lowers to one spec and one launch whose chain-internal
tensors live in the kernel's scratch, never in the arena. The reference's
compiled-mode gate (the whole arena in VMEM) has no counterpart here,
since the arena lives in device memory.

Device: the executor runs on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version; with no card and no explicit CPU request it raises. Nothing on the
CUDA route falls back to a plain version.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exec import ops as X
from repro_torch.core.exec import unwrap_plan
from repro_torch.core.graph import Op
from repro_torch.core.planner import (BlockPlan, Plan, chain_addr_of,
                                      chain_image_rows_of, fused_slots,
                                      legalise_for_blocks, tile_rows)
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


def _addr_triple(lay) -> Tuple[int, int, int]:
    """A layout's packed-addressing spec triple
    ``(cols_per_row, row_span, image_rowlen)``."""
    return (lay.cols_per_row, lay.row_span, lay.image_rowlen)


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


#: Bounds of the per-executor caches (FIFO).
_CACHE_PLANS = 32
_CACHE_DESCS = 512


#: The arena programs ``layout`` selects (the reference's meaning).
LAYOUTS = ("flat", "blocks", "auto")

#: Budget of the streaming gate when neither the constructor nor the
#: REPRO_DMO_VMEM_BUDGET env var names one (bytes; the reference's value,
#: so both packages admit the same graphs).
DEFAULT_VMEM_BUDGET = 16 * 1024 * 1024


class CudaExecutor:
    """The ``cuda`` :class:`~repro_torch.core.exec.ArenaExecutor` backend.

    ``device``: None (the card; raises without one), ``"cuda"``/``"cuda:N"``
    or ``"cpu"`` (every kernel's plain PyTorch version). ``layout``:
    ``"flat"`` (the default without a mode; the arena is exactly the
    planner's peak), ``"blocks"`` (the row-blocked program; raises on a
    plan that cannot legalise) or ``"auto"`` (blocked where the plan
    legalises, else flat). ``mode="streaming"`` runs the streaming program
    over the row-blocked layouts (``layout`` defaults to ``"auto"`` there,
    and a plan that cannot legalise raises, as in the reference);
    ``vmem_budget`` (bytes) is its gate."""

    name = "cuda"

    def __init__(self, device=None, layout: Optional[str] = None,
                 mode: Optional[str] = None,
                 vmem_budget: Optional[int] = None):
        if mode is not None and mode != "streaming":
            raise ValueError(f"unknown cuda mode {mode!r} (expected None or "
                             "'streaming')")
        if layout is None:
            layout = "auto" if mode == "streaming" else "flat"
        if layout not in LAYOUTS:
            raise ValueError(f"unknown cuda layout {layout!r} (expected one "
                             f"of {LAYOUTS})")
        if mode == "streaming" and layout == "flat":
            raise ValueError(
                "streaming mode requires row-blocked layouts: the flat byte "
                "arena has no arena rows to stream windows of")
        self.device = K.resolve_device(device)
        self.layout = layout
        self.mode = mode
        self.vmem_budget = vmem_budget
        #: (plan identity, route, quant identity) -> (plan, quant, bplan,
        #: spec tuple); values pin the keyed objects so the id() keys stay
        #: valid
        self._lowered: "collections.OrderedDict" = collections.OrderedDict()
        #: plan identity -> (plan, its BlockPlan or None for flat)
        self._legal: "collections.OrderedDict" = collections.OrderedDict()
        #: synth_weights/calibrate results per (plan identity, seed)
        self._autoparams: "collections.OrderedDict" = collections.OrderedDict()
        #: device weights per (plan, weights, quant) identity: one entry per
        #: spec (None, a filter, or a fused chain's packed blob); both
        #: programs take the same weights in the same order
        self._weights: "collections.OrderedDict" = collections.OrderedDict()
        #: device descriptor per spec (content-keyed)
        self._descs: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_hits = 0
        self._cache_misses = 0

    def lowering_cache_info(self) -> Dict[str, int]:
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "size": len(self._lowered), "descriptors": len(self._descs)}

    def _resolve_budget(self) -> int:
        """The streaming gate's budget in bytes: the constructor's, else
        the REPRO_DMO_VMEM_BUDGET env var, else the default."""
        if self.vmem_budget is not None:
            return int(self.vmem_budget)
        env = os.environ.get("REPRO_DMO_VMEM_BUDGET", "").strip()
        return int(env) if env else DEFAULT_VMEM_BUDGET

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

    def lower_blocks(self, bplan: BlockPlan,
                     quant: Optional[X.QuantSpec] = None
                     ) -> Tuple[K.OpSpec, ...]:
        """BlockPlan -> row-blocked OpSpec sequence: arena *row* offsets and
        ``(rows, used)`` block shapes from the legalised
        :class:`~repro_torch.core.planner.BlockLayout` records, and on a
        packed plan each operand's addressing triple. A fused band chain
        lowers to ONE spec at its first member's position. Batched ops
        expand image-minor, each per-image spec addressing image ``b``'s
        padded sub-block."""
        dtype = "i8" if bplan.dtype_bytes == 1 else "f32"
        packed = bplan.packing == "packed"
        sub = bplan.tiling[0]
        chains = _fused_chains(bplan.order)
        emitted: set = set()
        specs: List[K.OpSpec] = []
        for op in bplan.order:
            if op.kind == "reshape":
                continue
            cname = op.params.get("fuse_chain")
            if cname is not None:
                if cname not in emitted:
                    emitted.add(cname)
                    specs.append(self._fused_block_spec(
                        bplan, chains[cname], quant))
                continue
            if any(t.storage().kind == "weight" for t in op.inputs):
                raise ValueError(f"{op.name}: non-arena input cannot be "
                                 "lowered")
            lays = [bplan.layout_of(t) for t in op.inputs]
            out = bplan.layout_of(op.output)
            q = X.op_quant(op, quant)
            # legacy plans emit the reference's pre-packing specs exactly
            extra = dict(
                in_addr=tuple(_addr_triple(l) for l in lays),
                out_addr=_addr_triple(out),
                out_tile=tile_rows(out.cols_per_row, out.row_span, sub),
            ) if packed else {}
            for b in range(out.batch):
                specs.append(K.OpSpec(
                    kind=op.kind,
                    in_off=tuple(
                        l.image_row_offset(b if l.batch > 1 else 0)
                        for l in lays),
                    in_shape=tuple(tuple(t.shape) for t in op.inputs),
                    out_off=out.image_row_offset(b),
                    out_shape=tuple(op.output.shape),
                    dtype=dtype,
                    meta=_canon_meta(op),
                    qmeta=_canon_qmeta(op, q),
                    rowlen=bplan.arena_rowlen,
                    in_rows=tuple((l.image_rows, l.rowlen) for l in lays),
                    out_rows=(out.image_rows, out.rowlen),
                    **extra))
        return tuple(specs)

    def _fused_block_spec(self, bplan: BlockPlan, members: List[Op],
                          quant: Optional[X.QuantSpec],
                          window=None) -> K.OpSpec:
        """One row-blocked spec for a fused band chain. Chain-internal
        tensors live in scratch slots of whole rows
        (:func:`~repro_torch.core.planner.fused_slots` over the batched
        rows, total rounded to the sublane tile) addressed like the arena,
        by :func:`~repro_torch.core.planner.chain_addr_of`'s geometry;
        external operands keep their arena blocks. Stages expand op-major
        (member-major, image-minor), the order the planner's liveness model
        assumes. Given the chain's
        :class:`~repro_torch.core.planner.OpWindow`, the streaming variant:
        every operand, external inputs and the terminal output included,
        gets an ``include_io`` scratch slot, so the stages run entirely in
        the scratch; the inputs are copied in up front (``in_slots``) and
        the output copied back once (``out_slot``)."""
        dtype = "i8" if bplan.dtype_bytes == 1 else "f32"
        L = bplan.arena_rowlen
        sub = bplan.tiling[0]
        cat = members[-1]
        B = cat.output.storage().batch
        internal = {op.output.storage() for op in members[:-1]}
        packed = bplan.packing == "packed"
        streaming = window is not None
        irows_of = chain_image_rows_of(bplan)
        addr_of = chain_addr_of(bplan)

        def rows_of(s) -> int:
            """Batched slot rows of one chain operand."""
            return irows_of(s) * (s.batch if s.batch > 1 else 1)

        def triple_of(s) -> Tuple[int, int, int]:
            lay = bplan.layouts.get(s)
            if lay is not None:
                return _addr_triple(lay)
            c, k = addr_of(s)
            return (c, k, int(s.shape[-2]) * int(s.shape[-1]))

        def used_of(s) -> int:
            lay = bplan.layouts.get(s)
            if lay is not None:
                return lay.rowlen
            c, k, rl = triple_of(s)
            return L if k > 1 else c * rl

        slots, total = fused_slots(members, rows_of, round_to=sub,
                                   include_io=streaming)
        for s in internal:
            if used_of(s) > L:
                raise ValueError(f"scratch row of {s.name} wider than the "
                                 "arena row")

        def place(t, b: int):
            """(offset, (rows, used), scratch?) of one stage operand for
            image ``b``."""
            s = t.storage()
            if s in internal or streaming:
                bb = b if s.batch > 1 else 0
                return (slots[s] + bb * irows_of(s),
                        (irows_of(s), used_of(s)), 1)
            lay = bplan.layouts[s]
            return (lay.image_row_offset(b if lay.batch > 1 else 0),
                    (lay.image_rows, lay.rowlen), 0)

        stages: List[K.OpSpec] = []
        for op in members:
            q = X.op_quant(op, quant)
            extra = dict(
                in_addr=tuple(triple_of(t.storage()) for t in op.inputs),
                out_addr=triple_of(op.output.storage()),
            ) if packed else {}
            for b in range(B):
                placed = [place(t, b) for t in op.inputs]
                o_off, o_rows, o_scr = place(op.output, b)
                stages.append(K.OpSpec(
                    kind=op.kind,
                    in_off=tuple(p[0] for p in placed),
                    in_shape=tuple(tuple(t.shape) for t in op.inputs),
                    out_off=o_off,
                    out_shape=tuple(op.output.shape),
                    dtype=dtype,
                    meta=_canon_meta(op),
                    qmeta=_canon_qmeta(op, q),
                    rowlen=L,
                    in_rows=tuple(p[1] for p in placed),
                    out_rows=o_rows,
                    in_scratch=tuple(p[2] for p in placed),
                    out_scratch=o_scr,
                    **extra))
        ext = self._chain_ext_inputs(members, internal)
        out_lay = bplan.layout_of(cat.output)
        # top-level I/O covers the whole batched block of each external
        # operand (per-image sub-blocks are contiguous), so the streaming
        # copies stay one per tensor
        spec = K.OpSpec(
            kind="fused",
            in_off=tuple(bplan.layout_of(t).row_offset for t in ext),
            in_shape=tuple(tuple(t.shape) for t in ext),
            out_off=out_lay.row_offset,
            out_shape=tuple(cat.output.shape),
            dtype=dtype,
            meta=(cat.params["fuse_chain"],),
            rowlen=L,
            in_rows=tuple((bplan.layout_of(t).rows,
                           bplan.layout_of(t).rowlen) for t in ext),
            out_rows=(out_lay.rows, out_lay.rowlen),
            stages=tuple(stages),
            scratch_rows=total)
        if streaming:
            if window.win_rows != total:
                raise ValueError(f"fused window/slot mismatch: "
                                 f"{window.win_rows} vs {total}")
            spec = dataclasses.replace(
                spec, win_lo=window.lo, win_rows=window.win_rows,
                in_slots=tuple(slots[t.storage()] for t in ext),
                out_slot=slots[cat.output.storage()])
        return spec

    def lower_stream(self, bplan: BlockPlan,
                     quant: Optional[X.QuantSpec] = None
                     ) -> Tuple[K.OpSpec, ...]:
        """BlockPlan -> streaming OpSpec sequence: the row-blocked specs
        with each op's live-window statics grafted on from the planner's
        :class:`~repro_torch.core.planner.WindowSchedule` (one window per
        spec: both skip reshapes and emit one entry per fused chain and per
        image), so ``win_rows > 0`` selects the streaming kernels. Fused
        chains are lowered again in their streaming form."""
        specs = self.lower_blocks(bplan, quant)
        ws = bplan.window_schedule()
        chains = _fused_chains(bplan.order)
        if len(specs) != len(ws.windows):
            raise ValueError(f"spec/window mismatch: {len(specs)} vs "
                             f"{len(ws.windows)}")
        out: List[K.OpSpec] = []
        for s, w in zip(specs, ws.windows):
            if s.kind == "fused":
                out.append(self._fused_block_spec(
                    bplan, chains[w.op_name], quant, window=w))
            else:
                out.append(dataclasses.replace(
                    s, win_lo=w.lo, win_rows=w.win_rows,
                    win_starts=w.starts))
        return tuple(out)

    # -- execution ----------------------------------------------------------

    def legalised(self, plan: Plan) -> Optional[BlockPlan]:
        """The row-blocked legalisation this executor runs, or None for the
        flat program: ``"flat"`` never legalises, ``"blocks"`` (and the
        streaming mode) raise on a plan that cannot be row-blocked (mixed
        dtype, aggregated views), ``"auto"`` runs such a plan flat (the
        reference's ``_legalised``)."""
        if self.layout == "flat":
            return None
        if isinstance(plan, BlockPlan):
            return plan
        cached = self._legal.get(id(plan))
        if cached is not None and cached[0] is plan:
            return cached[1]
        try:
            bplan = legalise_for_blocks(plan)
        except ValueError:
            if self.layout == "blocks" or self.mode == "streaming":
                raise
            bplan = None
        self._legal[id(plan)] = (plan, bplan)
        while len(self._legal) > _CACHE_PLANS:
            self._legal.popitem(last=False)
        return bplan

    def _specs(self, plan: Plan, quant
               ) -> Tuple[Optional[BlockPlan], Tuple[K.OpSpec, ...]]:
        """(the BlockPlan or None, the lowered specs), cached per plan,
        route and quantisation."""
        bplan = self.legalised(plan)
        route = ("flat" if bplan is None else
                 "stream" if self.mode == "streaming" else "blocks")
        key = (id(plan), route, id(quant) if quant is not None else None)
        cached = self._lowered.get(key)
        if cached is not None and cached[0] is plan and cached[1] is quant:
            self._cache_hits += 1
            return cached[2], cached[3]
        self._cache_misses += 1
        if route == "stream":
            specs = self.lower_stream(bplan, quant)
        elif route == "blocks":
            specs = self.lower_blocks(bplan, quant)
        else:
            specs = self.lower(plan, quant)
        self._lowered[key] = (plan, quant, bplan, specs)
        while len(self._lowered) > _CACHE_PLANS:
            self._lowered.popitem(last=False)
        return bplan, specs

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
                                               stage_ws, device=self.device))
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
        a fresh tensor on the executor's device with every model input in
        place: flat, uint8 of exactly ``plan.peak_bytes``; row-blocked and
        streaming, a typed ``(total_rows, arena_rowlen)`` tensor. A
        streaming plan over the budget raises ValueError here. Descriptors
        are None on the CPU. Inputs, weights and quantisation default to
        the deterministic per-seed synthesis every backend shares."""
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

        bplan, specs = self._specs(plan, quant)
        if self.mode == "streaming":
            budget = self._resolve_budget()
            sched = bplan.window_schedule()
            if sched.max_resident_bytes > budget:
                raise ValueError(
                    f"streaming window of {graph.name!r} does not fit "
                    f"VMEM: peak resident {sched.max_resident_bytes} bytes "
                    f"({sched.max_window_rows} live rows) exceeds the "
                    f"{budget}-byte budget")
        ws = self._device_weights(plan, specs, weights, quant)
        descs = ([self._descriptor(s) for s in specs]
                 if self.device.type == "cuda" else [None] * len(specs))
        if bplan is not None:
            host = self._seed_block_arena(bplan, graph, inputs)
        else:
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
        return self.outputs(plan, arena)

    def outputs(self, plan_or_compiled,
                arena: torch.Tensor) -> Dict[str, np.ndarray]:
        """The model outputs held in a run program's arena, copied to the
        host (which waits for the device), keyed by tensor name."""
        plan, graph = unwrap_plan(plan_or_compiled)
        out_arena = arena.cpu().numpy()
        bplan = self.legalised(plan)
        if bplan is not None:
            return self._gather_block_outputs(bplan, graph, out_arena)
        outs: Dict[str, np.ndarray] = {}
        for t in graph.tensors:
            if t.kind == "output":
                s, off = t.storage(), plan.offsets[t.storage()]
                outs[t.name] = out_arena[off:off + s.nbytes].view(
                    X.arena_dtype(s.dtype_bytes)).reshape(X.tensor_shape(t))
        return outs

    @staticmethod
    def _seed_block_arena(bplan: BlockPlan, graph, inputs) -> np.ndarray:
        """A zeroed (total_rows, rowlen) typed arena with every model input
        scattered into its block layout (row-major over the used row
        prefix; a spanning image row column-padded over its k arena rows).
        Batched inputs scatter image by image into their sub-blocks."""
        dt = X.arena_dtype(bplan.dtype_bytes)
        L = bplan.arena_rowlen
        arena = np.zeros((bplan.total_rows, L), dt)
        for t in graph.tensors:
            if t.kind != "input":
                continue
            lay = bplan.layout_of(t)
            ir = lay.image_rows
            imgs = np.asarray(inputs[t.name], dt).reshape(lay.batch, -1)
            k = lay.row_span
            for b in range(lay.batch):
                off = lay.row_offset + b * ir
                flat = imgs[b]
                if k > 1:
                    rl, h = lay.image_rowlen, ir // k
                    block = np.zeros((h, k * L), dt)
                    block[:, :rl] = flat.reshape(h, rl)
                    arena[off:off + ir, :] = block.reshape(ir, L)
                    continue
                block = np.zeros(ir * lay.rowlen, dt)
                block[:flat.size] = flat
                arena[off:off + ir, :lay.rowlen] = \
                    block.reshape(ir, lay.rowlen)
        return arena

    @staticmethod
    def _gather_block_outputs(bplan: BlockPlan, graph,
                              out_arena: np.ndarray) -> Dict[str, np.ndarray]:
        outs: Dict[str, np.ndarray] = {}
        L = bplan.arena_rowlen
        for t in graph.tensors:
            if t.kind != "output":
                continue
            lay = bplan.layout_of(t)
            k = lay.row_span
            ir = lay.image_rows
            imgs = []
            for b in range(lay.batch):
                off = lay.row_offset + b * ir
                if k > 1:
                    rl, h = lay.image_rowlen, ir // k
                    flat = out_arena[off:off + ir, :].reshape(h, k * L)[:, :rl]
                else:
                    flat = out_arena[off:off + ir, :lay.rowlen]
                imgs.append(flat.reshape(-1)[:t.image_elems])
            outs[t.name] = np.stack(imgs).reshape(X.tensor_shape(t))
        return outs
