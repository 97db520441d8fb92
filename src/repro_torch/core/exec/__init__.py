"""Executor backends: run a planned arena on a real runtime.

A :class:`~repro_torch.core.planner.Plan` (or a
:class:`~repro_torch.core.pipeline.CompiledPlan`) describes ONE flat arena —
offsets plus the safe diagonal overlaps ``O_s`` — and the paper's claim is
that it is *executable*: ops walk output rows in ascending order inside the
shared buffer and never clobber a live value. This package turns that claim
into a pluggable runtime layer:

- ``numpy`` — :mod:`.numpy_backend`: the row-by-row NumPy interpreter
  (bit-exact ground truth, used by ``verify_plan``);
- ``cuda``  — :mod:`.cuda_backend`: lowers the plan to the flat byte
  program (one uint8 arena of exactly the plan's peak bytes) and runs it
  through hand-written sm_90a kernels
  (:mod:`repro_torch.kernels.arena_ops`). It runs on the card by default;
  ``get_backend("cuda", device="cpu")`` runs each kernel's plain PyTorch
  version instead, which is what the CPU tests do.

Every backend implements the :class:`ArenaExecutor` protocol::

    outputs = get_backend("cuda").execute(plan_or_compiled, inputs, weights)

``inputs``/``weights`` default to the deterministic synthesis of
:mod:`repro_torch.core.exec.ops`, so two backends handed the same (plan, seed)
execute the identical network and can be diffed output-for-output
(:func:`cross_check`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Protocol, Tuple

import numpy as np

from repro_torch.core.exec import ops
from repro_torch.core.exec.ops import (ELEMENTWISE, SUPPORTED_DTYPES,
                                 SUPPORTED_KINDS, OpQuant, QParams, QuantSpec,
                                 arena_dtype, calibrate, executability,
                                 executable, needs_quant, op_quant,
                                 quant_inputs, random_inputs, synth_weights)
from repro_torch.core.graph import Graph
from repro_torch.core.planner import Plan


class ArenaExecutor(Protocol):
    """An executor backend: runs a planned graph inside its flat arena."""

    #: registry name ("numpy", "cuda", ...)
    name: str

    def execute(self, plan_or_compiled, inputs=None, weights=None, *,
                seed: int = 0, quant=None) -> Dict[str, np.ndarray]:
        """Execute ``plan_or_compiled`` (a Plan or CompiledPlan) and return
        the model outputs keyed by tensor name. ``inputs`` / ``weights``
        default to the deterministic per-seed synthesis shared by all
        backends; ``quant`` is the :class:`~repro_torch.core.exec.ops.QuantSpec`
        for int8 graphs (auto-calibrated when omitted)."""
        ...


def unwrap_plan(plan_or_compiled) -> Tuple[Plan, Graph]:
    """Accept a Plan or a CompiledPlan; return (plan, executed graph)."""
    if isinstance(plan_or_compiled, Plan):
        return plan_or_compiled, plan_or_compiled.graph
    plan = getattr(plan_or_compiled, "plan", None)
    if isinstance(plan, Plan):
        return plan, plan.graph
    raise TypeError(f"expected Plan or CompiledPlan, got "
                    f"{type(plan_or_compiled).__name__}")


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[..., ArenaExecutor]] = {}
_INSTANCES: Dict[str, ArenaExecutor] = {}


def register_backend(name: str, factory: Callable[..., ArenaExecutor]) -> None:
    _FACTORIES[name] = factory
    _INSTANCES.pop(name, None)  # re-registration must not serve a stale one


def available_backends() -> Tuple[str, ...]:
    return tuple(_FACTORIES)


def get_backend(name: str, **kwargs: Any) -> ArenaExecutor:
    """Backend instance by name. Default-configured instances are cached;
    passing kwargs constructs a fresh one."""
    if name not in _FACTORIES:
        raise ValueError(
            f"unknown executor backend {name!r}; available: "
            f"{available_backends()}")
    if kwargs:
        return _FACTORIES[name](**kwargs)
    if name not in _INSTANCES:
        _INSTANCES[name] = _FACTORIES[name]()
    return _INSTANCES[name]


def _numpy_factory(**kw) -> ArenaExecutor:
    from repro_torch.core.exec.numpy_backend import NumpyExecutor
    return NumpyExecutor(**kw)


def _cuda_factory(**kw) -> ArenaExecutor:
    # imported lazily: the core planning path must not pay the torch import
    from repro_torch.core.exec.cuda_backend import CudaExecutor
    return CudaExecutor(**kw)


register_backend("numpy", _numpy_factory)
register_backend("cuda", _cuda_factory)


# ---------------------------------------------------------------------------
# Cross-backend verification
# ---------------------------------------------------------------------------

#: fp32 tolerance for backends whose accumulation order differs from the
#: numpy loop order (the CUDA kernels' per-thread sums, the plain versions'
#: matrix products). The single source of truth — the verify
#: pass, verify_plan and cross_check all compare through it.
FP32_RTOL = 1e-4
FP32_ATOL = 1e-4
#: Integer (int8) outputs tolerate one least-significant quantisation step:
#: transcendental ulp differences (exp in softmax/sigmoid) can flip a round.
INT8_ATOL = 1


def compare_outputs(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray],
                    exact: bool, label: str) -> None:
    """Assert two output dicts match: bit-exact, or at the shared tolerance
    for the output's dtype (fp32 atol/rtol for float outputs, <= 1 LSB for
    quantised int8 outputs). Raises ``AssertionError`` on any mismatch."""
    assert ref.keys() == got.keys(), f"{label}: output sets differ"
    for k in ref:
        if exact:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"output {k} ({label})")
        elif np.issubdtype(np.asarray(ref[k]).dtype, np.integer):
            np.testing.assert_allclose(
                np.asarray(got[k]).astype(np.int32),
                np.asarray(ref[k]).astype(np.int32),
                rtol=0, atol=INT8_ATOL, err_msg=f"output {k} ({label})")
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=FP32_RTOL,
                                       atol=FP32_ATOL,
                                       err_msg=f"output {k} ({label})")


def cross_check(plan_or_compiled, seed: int = 0,
                backends: Tuple = ("numpy", "cuda")) -> None:
    """Execute the plan on both backends with identical inputs/weights (and,
    for int8 graphs, one shared calibration) and assert the arena outputs
    agree — fp32 tolerance where a backend sums the dot products in another
    order than the numpy semantics' loop order, <= 1 LSB on
    quantised outputs. Raises ``AssertionError`` on any mismatch. Entries of
    ``backends`` are registry names or pre-configured executor instances
    (e.g. ``get_backend("cuda", device="cpu")``), so differently configured
    executors of one backend can be diffed too."""
    plan, graph = unwrap_plan(plan_or_compiled)
    reason = executability(graph)
    if reason is not None:
        raise ValueError(f"graph is not executable by arena backends: {reason}")
    weights = synth_weights(graph, seed)
    quant = calibrate(graph, seed, weights) if needs_quant(graph) else None
    inputs = (quant_inputs(graph, quant, seed) if quant is not None
              else random_inputs(graph, seed))
    resolve = lambda b: b if hasattr(b, "execute") else get_backend(b)
    label = lambda b: b if isinstance(b, str) else getattr(b, "name", str(b))
    a = resolve(backends[0]).execute(plan, inputs, weights, seed=seed,
                                     quant=quant)
    b = resolve(backends[1]).execute(plan, inputs, weights, seed=seed,
                                     quant=quant)
    compare_outputs(a, b, exact=False,
                    label=f"{label(backends[1])} vs {label(backends[0])}")


__all__ = [
    "ArenaExecutor", "ELEMENTWISE", "FP32_ATOL", "FP32_RTOL", "INT8_ATOL",
    "arena_dtype",
    "OpQuant", "QParams", "QuantSpec", "SUPPORTED_DTYPES", "SUPPORTED_KINDS",
    "available_backends", "calibrate", "compare_outputs", "cross_check",
    "executability", "executable", "get_backend", "needs_quant", "op_quant",
    "ops", "quant_inputs", "random_inputs", "register_backend",
    "synth_weights", "unwrap_plan",
]
