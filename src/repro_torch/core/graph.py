"""Tensor-operation graph IR for diagonal memory optimisation.

This is the framework's analogue of a TFLite flatbuffer: a list of tensor
operations over shaped tensors, enough to (a) compute per-op safe buffer
overlaps ``O_s`` and (b) plan a flat tensor arena.

Only *intermediate* tensors participate in arena planning; weight/constant
tensors live in flash/HBM and are excluded, exactly as in the paper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Tensor:
    """A tensor value flowing through the graph.

    ``kind`` is one of ``input`` (model input), ``intermediate``, ``output``
    (model output), ``weight`` (excluded from the arena) or ``scratch``
    (chain-internal value of a fused band chain: materialised only inside
    the fused kernel's VMEM scratch, never placed in the arena — see
    :mod:`repro_torch.core.pipeline` FusePass).
    """

    name: str
    shape: Tuple[int, ...]
    dtype_bytes: int = 4
    kind: str = "intermediate"
    #: Alias-of: reshape/squeeze outputs share storage with their input.
    alias_of: Optional["Tensor"] = None
    #: Leading batch axis. ``shape`` stays the per-image shape (so op params
    #: like concat axes and band row ranges keep their meaning); a batched
    #: tensor stores ``batch`` images back to back, image ``b`` at byte
    #: offset ``b * image_nbytes`` of its storage. Weight tensors are never
    #: batched (``batch == 1`` always).
    batch: int = 1

    @property
    def image_elems(self) -> int:
        """Elements of ONE image (``prod(shape)``, batch excluded)."""
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def image_nbytes(self) -> int:
        return self.image_elems * self.dtype_bytes

    @property
    def elems(self) -> int:
        return self.batch * self.image_elems

    @property
    def nbytes(self) -> int:
        return self.elems * self.dtype_bytes

    def storage(self) -> "Tensor":
        """Resolve alias chains to the tensor that owns the storage."""
        t = self
        while t.alias_of is not None:
            t = t.alias_of
        return t

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Tensor({self.name}, {self.shape}, {self.dtype_bytes}B, {self.kind})"


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

#: Op kinds with reference-implementation access-pattern models.
OP_KINDS = (
    "conv2d",          # params: stride (sh, sw), padding 'same'|'valid', dilation
    "depthwise_conv2d",  # params: stride, padding, channel multiplier
    "pool",            # params: pool kernel, stride, padding, avg|max
    "elementwise",     # unary or binary same-shape (relu, add, mul, ...)
    "softmax",
    "fully_connected",  # matmul against weights
    "matmul",          # generic matmul between two intermediates
    "concat",          # params: axis
    "pad",             # params: paddings per dim
    "mean",            # global spatial reduction
    "reshape",         # aliasing no-op
    "embedding_lookup",  # gather rows from a weight table
    "custom",          # anything else: O_s = 0 (fully conservative)
)


@dataclasses.dataclass(eq=False)
class Op:
    kind: str
    inputs: List[Tensor]
    outputs: List[Tensor]
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""

    def __post_init__(self) -> None:
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown op kind {self.kind!r}")
        if not self.name:
            self.name = self.kind

    @property
    def output(self) -> Tensor:
        return self.outputs[0]

    def intermediate_inputs(self) -> List[Tensor]:
        return [t for t in self.inputs if t.kind != "weight"]

    def __repr__(self) -> str:  # pragma: no cover
        return f"Op({self.name}:{self.kind})"


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class Graph:
    """An ordered tensor-op graph (execution order = list order).

    Use :mod:`repro_torch.core.serialise` to re-order connected graphs; for the
    sequential models the construction order is the execution order.
    """

    def __init__(self, name: str = "graph"):
        self.name = name
        self.ops: List[Op] = []
        self._tensors: Dict[str, Tensor] = {}
        #: Batch size every non-weight tensor carries (see
        #: :func:`with_batch`). Builders construct batch-1 graphs.
        self.batch: int = 1

    # -- construction -------------------------------------------------------
    def tensor(
        self,
        name: str,
        shape: Sequence[int],
        dtype_bytes: int = 4,
        kind: str = "intermediate",
        alias_of: Optional[Tensor] = None,
    ) -> Tensor:
        if name in self._tensors:
            raise ValueError(f"duplicate tensor name {name!r}")
        # graph rewrites (remove_concats / split / fuse) rebuild tensors
        # through here: they inherit the graph's batch so a batched graph's
        # transforms stay batched (weights are always shared across images)
        batch = self.batch if kind != "weight" else 1
        t = Tensor(name, tuple(int(s) for s in shape), dtype_bytes, kind,
                   alias_of, batch=batch)
        self._tensors[name] = t
        return t

    def add(self, op: Op) -> Tensor:
        self.ops.append(op)
        return op.outputs[0]

    def op(
        self,
        kind: str,
        inputs: Sequence[Tensor],
        out_shape: Sequence[int],
        params: Optional[Dict[str, Any]] = None,
        name: str = "",
        dtype_bytes: Optional[int] = None,
        out_kind: str = "intermediate",
    ) -> Tensor:
        """Convenience: create the output tensor and append the op."""
        inputs = list(inputs)
        db = dtype_bytes if dtype_bytes is not None else inputs[0].dtype_bytes
        oname = name or f"{kind}_{len(self.ops)}"
        alias = inputs[0].storage() if kind == "reshape" else None
        out = self.tensor(f"{oname}_out", out_shape, db, out_kind, alias_of=alias)
        self.add(Op(kind, inputs, [out], dict(params or {}), oname))
        return out

    # -- queries ------------------------------------------------------------
    @property
    def tensors(self) -> List[Tensor]:
        return list(self._tensors.values())

    def arena_tensors(self) -> List[Tensor]:
        """Tensors that occupy the arena: everything except weights and
        fused-chain scratch, with aliases resolved to their storage owner."""
        seen: List[Tensor] = []
        for t in self._tensors.values():
            s = t.storage()
            if s.kind not in ("weight", "scratch") and s not in seen:
                seen.append(s)
        return seen

    def data_tensors(self) -> List[Tensor]:
        """All value-carrying storage tensors — arena tensors *plus* fused-
        chain scratch (everything except weights). Calibration iterates
        these: scratch tensors still need activation ranges even though
        they never occupy the arena."""
        seen: List[Tensor] = []
        for t in self._tensors.values():
            s = t.storage()
            if s.kind != "weight" and s not in seen:
                seen.append(s)
        return seen

    def scopes(self, order: Optional[Sequence[Op]] = None) -> Dict[Tensor, Tuple[int, int]]:
        """Liveness scope [first_def_or_use, last_use] per storage tensor.

        Model inputs are live from step 0; model outputs are live to the end.
        Indices refer to positions in ``order`` (default: self.ops).
        """
        order = list(order if order is not None else self.ops)
        n = len(order)
        first: Dict[Tensor, int] = {}
        last: Dict[Tensor, int] = {}
        for i, op in enumerate(order):
            for t in op.inputs:
                s = t.storage()
                if s.kind in ("weight", "scratch"):
                    continue
                first.setdefault(s, 0 if s.kind == "input" else i)
                last[s] = i
            for t in op.outputs:
                s = t.storage()
                if s.kind == "scratch":
                    continue
                first.setdefault(s, i)
                last.setdefault(s, i)
                if s.kind == "output":
                    last[s] = n - 1
        # model inputs never consumed / outputs never produced still get scopes
        for t in self.arena_tensors():
            first.setdefault(t, 0)
            last.setdefault(t, n - 1 if t.kind == "output" else first[t])
        return {t: (first[t], last[t]) for t in first}

    def producers(self) -> Dict[Tensor, Op]:
        prod: Dict[Tensor, Op] = {}
        for op in self.ops:
            for t in op.outputs:
                prod[t.storage()] = op
        return prod

    def validate(self) -> None:
        """Basic well-formedness: every non-input intermediate is produced
        before it is consumed (in list order)."""
        produced = {t.storage() for op in self.ops for t in op.outputs}
        available = {
            t.storage()
            for t in self._tensors.values()
            if t.kind in ("input", "weight")
        }
        for op in self.ops:
            for t in op.inputs:
                s = t.storage()
                if s not in available and s not in produced:
                    raise ValueError(f"{op}: input {s.name} never produced")
        # order check
        avail = {
            t.storage()
            for t in self._tensors.values()
            if t.kind in ("input", "weight")
        }
        for op in self.ops:
            for t in op.inputs:
                if t.storage() not in avail:
                    raise ValueError(
                        f"{op}: input {t.name} consumed before production"
                    )
            for t in op.outputs:
                avail.add(t.storage())

    def peak_bytes_lower_bound(self) -> int:
        """max over ops of (sum of live tensor sizes) — the no-overlap floor."""
        scopes = self.scopes()
        peak = 0
        for i in range(len(self.ops)):
            live = sum(t.nbytes for t, (a, b) in scopes.items() if a <= i <= b)
            peak = max(peak, live)
        return peak

    def __repr__(self) -> str:  # pragma: no cover
        return f"Graph({self.name}, {len(self.ops)} ops, {len(self._tensors)} tensors)"


def with_batch(graph: Graph, batch: int) -> Graph:
    """A deep copy of ``graph`` with every non-weight tensor carrying a
    leading ``batch`` axis (weights are shared across the batch and stay
    batch-1). Per-image shapes, op params and execution order are untouched
    — the batch axis is an attribute, not a literal shape dim, so band row
    ranges, concat axes and overlap geometry keep their per-image meaning.
    ``batch == 1`` returns the input graph unchanged (no copy), keeping
    batch-1 compiles bit-identical to the pre-batch pipeline."""
    b = int(batch)
    if b < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if b == 1 and graph.batch == 1:
        return graph
    g = Graph(graph.name)
    g.batch = b
    mapped: Dict[int, Tensor] = {}

    def conv(t: Optional[Tensor]) -> Optional[Tensor]:
        if t is None:
            return None
        nt = mapped.get(id(t))
        if nt is None:
            nt = Tensor(t.name, t.shape, t.dtype_bytes, t.kind,
                        conv(t.alias_of),
                        batch=1 if t.kind == "weight" else b)
            mapped[id(t)] = nt
        return nt

    for t in graph._tensors.values():
        g._tensors[t.name] = conv(t)
    for op in graph.ops:
        g.ops.append(Op(op.kind, [conv(t) for t in op.inputs],
                        [conv(t) for t in op.outputs],
                        dict(op.params), op.name))
    return g


# ---------------------------------------------------------------------------
# Conv helpers shared by builders and overlap calculators
# ---------------------------------------------------------------------------


def conv_out_dim(in_dim: int, k: int, stride: int, padding: str, dilation: int = 1) -> int:
    eff_k = (k - 1) * dilation + 1
    if padding == "same":
        return -(-in_dim // stride)  # ceil
    if padding == "valid":
        return (in_dim - eff_k) // stride + 1
    raise ValueError(padding)


def pad_amount(in_dim: int, out_dim: int, k: int, stride: int, dilation: int = 1) -> int:
    """Leading pad, eq. (5)/(6) of the paper (TF SAME convention)."""
    total = max(0, (out_dim - 1) * stride + (k - 1) * dilation + 1 - in_dim)
    return total // 2


def band_range(op: Op) -> Optional[Tuple[int, int]]:
    """The nominal output-row range ``[r0, r1)`` a row-banded conv-family op
    computes (operation splitting, §II.A), or ``None`` for unbanded ops."""
    rr = op.params.get("row_range")
    return (int(rr[0]), int(rr[1])) if rr is not None else None


def op_pads(op: Op) -> Tuple[int, int]:
    """Leading ``(ph, pw)`` pads of a conv-family op — the one geometry
    source every O_s calculator, executor backend and legaliser shares.

    Row-banded ops (those carrying ``row_range``) use their explicit
    ``band_pad``: output-local row ``o`` reads input-local rows
    ``o*sh - ph + fy*dh``, exactly the plain-conv loop nest, so a band is an
    ordinary conv over its band shapes once this pad is substituted. ``ph``
    may be *negative* for a producer band (its output rows start deep inside
    the full input it reads). Unbanded ops derive pads from the ``padding``
    mode as before."""
    bp = op.params.get("band_pad")
    if bp is not None:
        return int(bp[0]), int(bp[1])
    ih, iw = op.inputs[0].shape[-3], op.inputs[0].shape[-2]
    oh, ow = op.output.shape[-3], op.output.shape[-2]
    kh, kw = op.params["kernel"]
    sh, sw = op.params.get("stride", (1, 1))
    dh, dw = op.params.get("dilation", (1, 1))
    if op.params.get("padding", "same") == "same":
        return pad_amount(ih, oh, kh, sh, dh), pad_amount(iw, ow, kw, sw, dw)
    return 0, 0
