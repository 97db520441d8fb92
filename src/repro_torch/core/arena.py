"""Legacy arena-execution API — thin wrapper over the ``numpy`` executor
backend.

The executors themselves moved into the pluggable backend layer:

- op semantics (row loops, weight synthesis): :mod:`repro_torch.core.exec.ops`
- numpy backend (this module's old contents): :mod:`repro_torch.core.exec.numpy_backend`
- pallas backend (flat donated arena, Pallas kernels):
  :mod:`repro_torch.core.exec.pallas_backend`

:func:`run_reference` / :func:`run_in_arena` / :func:`verify_plan` keep their
historical signatures and bit-exact semantics; new code should go through
:func:`repro_torch.core.exec.get_backend` (or ``CompiledPlan.execute``) instead.
"""
from __future__ import annotations

from repro_torch.core.exec.numpy_backend import (ArenaExec, ReferenceExec,
                                           run_in_arena, run_reference,
                                           verify_plan)

__all__ = [
    "ArenaExec", "ReferenceExec", "run_in_arena", "run_reference",
    "verify_plan",
]
