"""repro_torch.serve subpackage.

- :mod:`.engine` / :mod:`.continuous` — KV-cache decoding engines (the
  transformer-family serving path), each decode step updating the cache in
  place; long prefill attention and RWKV prefill run the flash and WKV
  kernels on the card;
- :mod:`.plan_server` — the plan-routed CNN serving runtime: batch-aware
  compiled arena plans behind a deadline-batching request queue
  (:class:`~repro_torch.serve.plan_server.PlanServer`), each flush one
  variant's arena program on the card.
"""
from repro_torch.serve.continuous import (ContinuousConfig, ContinuousEngine,
                                          Request)
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.plan_server import (FastExec, PlanServer, ServeRequest,
                                           throughput_demo)

__all__ = ["ContinuousConfig", "ContinuousEngine", "Engine", "FastExec",
           "PlanServer", "Request", "ServeConfig", "ServeRequest",
           "throughput_demo"]
