"""repro_torch.serve subpackage.

- :mod:`.plan_server` — the plan-routed CNN serving runtime: batch-aware
  compiled arena plans behind a deadline-batching request queue
  (:class:`~repro_torch.serve.plan_server.PlanServer`), each flush one
  variant's arena program on the card.
"""
from repro_torch.serve.plan_server import (FastExec, PlanServer, ServeRequest,
                                           throughput_demo)

__all__ = ["FastExec", "PlanServer", "ServeRequest", "throughput_demo"]
