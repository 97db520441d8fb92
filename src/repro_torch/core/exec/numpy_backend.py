"""NumPy arena executor backend (the TFMin analogue, reference semantics).

Two executors over the shared op semantics of :mod:`repro_torch.core.exec.ops`:

- :class:`ReferenceExec` — private buffer per tensor (ground truth);
- :class:`ArenaExec`     — all intermediates live inside ONE flat *byte*
  arena at the offsets chosen by a :class:`~repro_torch.core.planner.Plan`, each op
  processing its output *row by row in ascending index order* (reads of a row
  happen no later, and writes no earlier, than the reference element order —
  so a plan safe for the element order is safe here). Tensors are typed
  views into the byte arena — int8 ops read/write i8 views at byte offsets,
  f32 ops f32 views — so mixed-dtype plans execute in the one buffer.

Both executors are dtype-aware: ops whose output storage is int8 run the
quantised tier (int32 accumulation + per-tensor scale/zero-point
requantisation) when a :class:`~repro_torch.core.exec.ops.QuantSpec` is supplied;
f32 ops always run the float32 reference semantics.

:class:`NumpyExecutor` wraps the pair behind the
:class:`~repro_torch.core.exec.ArenaExecutor` protocol; :func:`verify_plan` runs
an arena backend against the private-buffer reference and asserts equality
(bit-exact for numpy, tolerance for backends whose accumulation order XLA
may reassociate — fp32 atol for float graphs, <= 1 LSB for int8). If the
plan overlapped any buffer unsafely, the arena execution clobbers a live
value and the comparison fails — the open-source-tool verification described
in the paper's §I.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.exec import ops as X
from repro_torch.core.graph import Graph, Op, Tensor
from repro_torch.core.planner import Plan


class _Exec:
    """Shared op evaluation; subclasses define tensor load/store."""

    def __init__(self, graph: Graph, seed: int = 0,
                 weights: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
                 quant: Optional[X.QuantSpec] = None):
        self.graph = graph
        self.weights = weights if weights is not None else X.synth_weights(
            graph, seed)
        #: Quantisation spec; None runs every op on the f32 tier (which is
        #: exactly what calibration needs on an int8-annotated graph).
        self.quant = quant

    def load(self, t: Tensor) -> np.ndarray:
        raise NotImplementedError

    def store(self, t: Tensor, v: np.ndarray) -> None:
        raise NotImplementedError

    def load_image(self, t: Tensor, b: int) -> np.ndarray:
        """Per-image value: image ``b`` of a batched tensor, or the whole
        value of a batch-1 tensor (weights and operands shared across the
        batch)."""
        v = self.load(t)
        return v[b] if t.storage().batch > 1 else v

    def store_image(self, t: Tensor, v: np.ndarray, b: int) -> None:
        raise NotImplementedError

    def store_rows(self, op: Op, rows, b: int = 0) -> None:
        """Default: materialise and store whole image (reference executor)."""
        out = np.stack([r for r in rows], axis=0)
        self.store_image(op.output, out.reshape(op.output.shape), b)

    def run(self, order: Optional[List[Op]] = None) -> None:
        for op in (order or self.graph.ops):
            self.execute(op)

    def _filter(self, op: Op, q) -> Optional[np.ndarray]:
        """The op's weight tensor on the active tier (int8 when quantised)."""
        if q is not None and id(op) in self.quant.weights_q:
            return self.quant.weights_q[id(op)]["filter"]
        return self.weights[id(op)].get("filter")

    def execute(self, op: Op) -> None:
        if op.kind == "reshape":
            return  # aliasing no-op
        # batched ops execute image by image in ASCENDING order — the order
        # the batched O_s (planner.batched_os_bytes) is derived against:
        # image b's writes land before image b+1's reads
        for b in range(op.output.storage().batch):
            self.execute_image(op, b)

    def execute_image(self, op: Op, b: int) -> None:
        q = X.op_quant(op, self.quant)
        if op.kind in ("conv2d", "depthwise_conv2d"):
            x = self.load_image(op.inputs[0], b).reshape(op.inputs[0].shape)
            x3 = x.reshape(x.shape[-3:])
            filt = self._filter(op, q)
            oh = op.output.shape[-3]
            self.store_rows(op, (X.conv_row(op, x3, filt, oy, q)
                                 for oy in range(oh)), b)
        elif op.kind == "pool":
            x3 = self.load_image(op.inputs[0], b).reshape(
                op.inputs[0].shape[-3:])
            oh = op.output.shape[-3]
            self.store_rows(op, (X.pool_row(op, x3, oy, q)
                                 for oy in range(oh)), b)
        else:
            xs = [self.load_image(t, b).reshape(t.shape) for t in op.inputs
                  if t.storage().kind != "weight"]
            self.store_image(op.output, X.eval_op(op, xs,
                                                  self._filter(op, q), q), b)


class ReferenceExec(_Exec):
    def __init__(self, graph: Graph, inputs: Dict[str, np.ndarray],
                 seed: int = 0, weights=None, quant=None):
        super().__init__(graph, seed, weights, quant)
        self.vals: Dict[Tensor, np.ndarray] = {}
        for t in graph.tensors:
            if t.kind == "input":
                v = np.asarray(inputs[t.name])
                # int8 inputs stay int8 (quantised execution); everything
                # else is the f32 tier (including calibration runs, which
                # feed float inputs to an int8-annotated graph)
                self.vals[t.storage()] = v if v.dtype == np.int8 \
                    else v.astype(np.float32)

    def load(self, t: Tensor) -> np.ndarray:
        return self.vals[t.storage()]

    def store(self, t: Tensor, v: np.ndarray) -> None:
        self.vals[t.storage()] = v.reshape(X.tensor_shape(t))

    def store_image(self, t: Tensor, v: np.ndarray, b: int) -> None:
        s = t.storage()
        if s.batch == 1:
            self.store(t, v)
            return
        buf = self.vals.get(s)
        if buf is None:
            buf = self.vals[s] = np.zeros((s.batch,) + tuple(t.shape),
                                          v.dtype)
        buf[b] = v.reshape(t.shape)


class ArenaExec(_Exec):
    """Executes inside a single flat byte arena at planned offsets.

    Conv/pool outputs are written row-by-row (ascending), loads re-read the
    arena for every row — faithfully modelling the MCU execution order that
    DMO's O_s guarantees safe. Each tensor is a dtype view
    (:func:`~repro_torch.core.exec.ops.arena_dtype`) into the byte buffer at its
    planned byte offset, which the planner keeps ``dtype_bytes``-aligned.
    """

    def __init__(self, graph: Graph, plan: Plan,
                 inputs: Dict[str, np.ndarray], seed: int = 0, weights=None,
                 quant=None):
        super().__init__(graph, seed, weights, quant)
        if quant is None and X.needs_quant(graph):
            # without a QuantSpec every op would run the f32 tier and its
            # store would silently truncate floats into the int8 views —
            # fail loudly instead (NumpyExecutor.execute auto-calibrates)
            raise ValueError(
                f"{graph.name!r} has int8 arena tensors: arena execution "
                "requires a QuantSpec (see repro_torch.core.exec.ops.calibrate)")
        self.plan = plan
        self.arena = np.zeros(plan.peak_bytes, np.uint8)
        #: Fused-chain scratch tensors have no arena placement: the numpy
        #: reference keeps them in private side buffers (the VMEM-scratch
        #: analogue), so fused graphs execute with identical op semantics.
        self.scratch: Dict[Tensor, np.ndarray] = {}
        for t in graph.tensors:
            if t.kind == "input":
                self.store(t, np.asarray(inputs[t.name]))

    def _view(self, t: Tensor) -> np.ndarray:
        """Typed view of the tensor's storage bytes inside the arena (or of
        its private side buffer for fused-chain scratch tensors)."""
        s = t.storage()
        if s.kind == "scratch":
            buf = self.scratch.get(s)
            if buf is None:
                buf = self.scratch[s] = np.zeros(
                    s.elems, X.arena_dtype(s.dtype_bytes))
            return buf
        off = self.plan.offsets[s]
        assert off % s.dtype_bytes == 0, \
            f"{s.name}: byte offset {off} not {s.dtype_bytes}-byte aligned"
        return self.arena[off:off + s.nbytes].view(X.arena_dtype(s.dtype_bytes))

    def load(self, t: Tensor) -> np.ndarray:
        return self._view(t).copy().reshape(X.tensor_shape(t))

    def store(self, t: Tensor, v: np.ndarray) -> None:
        view = self._view(t)
        view[:] = np.asarray(v, dtype=view.dtype).reshape(-1)

    def store_image(self, t: Tensor, v: np.ndarray, b: int) -> None:
        s = t.storage()
        view = self._view(t)
        if s.batch > 1:
            n = s.image_elems
            view = view[b * n:(b + 1) * n]
        view[:] = np.asarray(v, dtype=view.dtype).reshape(-1)

    def store_rows(self, op: Op, rows, b: int = 0) -> None:
        out = op.output
        view = self._view(out)
        row_elems = out.image_elems // out.shape[-3]
        base = b * out.storage().image_elems
        for i, r in enumerate(rows):
            # NOTE: each row's inputs were loaded lazily by conv_row via the
            # generator *before* this store — but rows are produced one at a
            # time, so reads for row i+1 happen after the row-i store, exactly
            # the diagonal order.
            view[base + i * row_elems:base + (i + 1) * row_elems] = \
                r.reshape(-1)

    def execute_image(self, op: Op, b: int) -> None:
        # conv/pool must re-load input per row to see the live arena
        if op.kind in ("conv2d", "depthwise_conv2d", "pool"):
            q = X.op_quant(op, self.quant)
            x_t = op.inputs[0]
            filt = self._filter(op, q)
            oh = op.output.shape[-3]

            def rows():
                for oy in range(oh):
                    x3 = self.load_image(x_t, b).reshape(x_t.shape[-3:])
                    if op.kind == "pool":
                        yield X.pool_row(op, x3, oy, q)
                    else:
                        yield X.conv_row(op, x3, filt, oy, q)

            self.store_rows(op, rows(), b)
        else:
            super().execute_image(op, b)


# ---------------------------------------------------------------------------
# Module-level API (legacy names; repro_torch.core.arena re-exports these)
# ---------------------------------------------------------------------------


def run_reference(graph: Graph, inputs: Dict[str, np.ndarray],
                  order: Optional[List[Op]] = None, seed: int = 0,
                  weights=None, quant=None) -> Dict[str, np.ndarray]:
    ex = ReferenceExec(graph, inputs, seed, weights, quant)
    ex.run(order)
    return {t.name: ex.vals[t.storage()]
            for t in graph.tensors if t.kind == "output"}


def run_in_arena(graph: Graph, plan: Plan, inputs: Dict[str, np.ndarray],
                 seed: int = 0, weights=None,
                 quant=None) -> Dict[str, np.ndarray]:
    ex = ArenaExec(graph, plan, inputs, seed, weights, quant)
    ex.run(plan.order)
    return {t.name: ex.load(t) for t in graph.tensors if t.kind == "output"}


class NumpyExecutor:
    """The ``numpy`` :class:`~repro_torch.core.exec.ArenaExecutor` backend."""

    name = "numpy"

    def execute(self, plan_or_compiled, inputs=None, weights=None, *,
                seed: int = 0, quant=None) -> Dict[str, np.ndarray]:
        from repro_torch.core.exec import unwrap_plan
        plan, graph = unwrap_plan(plan_or_compiled)
        reason = X.executability(graph)
        if reason is not None:
            # same gate as the pallas backend: strided views / unsupported-
            # dtype graphs / legacy (pad-less) split bands would execute
            # with silently wrong semantics rather than fail — refuse
            # loudly instead. Split row bands carrying explicit band pads
            # pass the gate and run as ordinary convs over band shapes.
            raise ValueError(
                f"numpy backend cannot execute {graph.name!r}: {reason}")
        if weights is None:
            weights = X.synth_weights(graph, seed)
        if quant is None and X.needs_quant(graph):
            quant = X.calibrate(graph, seed, weights)
        if inputs is None:
            inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
                      else X.random_inputs(graph, seed))
        return run_in_arena(graph, plan, inputs, seed, weights, quant)


def verify_plan(graph: Graph, plan: Plan, seed: int = 0,
                backend: str = "numpy") -> None:
    """Assert the planned arena execution matches private buffers: bit-exact
    for the numpy backend; tolerance for backends (pallas) whose dot
    accumulations XLA may reassociate (fp32 atol, or <= 1 LSB on int8
    outputs). Any unsafe overlap in the plan clobbers a live value and
    raises ``AssertionError``."""
    from repro_torch.core.exec import compare_outputs, get_backend
    weights = X.synth_weights(graph, seed)
    quant = X.calibrate(graph, seed, weights) if X.needs_quant(graph) else None
    inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
              else X.random_inputs(graph, seed))
    ref = run_reference(graph, inputs, plan.order, seed, weights, quant)
    got = get_backend(backend).execute(plan, inputs, weights, seed=seed,
                                       quant=quant)
    compare_outputs(ref, got, exact=(backend == "numpy"),
                    label=f"{backend} arena vs reference")
