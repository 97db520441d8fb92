"""Continuous-batching serving engine (vLLM-style slot scheduling).

The counterpart of the reference's ``src/repro/serve/continuous.py``. A
fixed pool of ``slots`` shares one KV ring cache updated in place;
requests with different prompt lengths run in the same decode step via
per-slot position vectors (ragged decode). When a request finishes (EOS /
max tokens) its slot is recycled for the next queued request with no batch
barrier: admission copies the new request's prefilled cache into the
slot's storage in place, the dead value overwritten without reallocation.

Prefill runs per request; decode is one step for the whole pool. Works for
every decoder family (the cache dict is family-agnostic); prompts are
token ids. Runs on ``device`` (None: the card; ``"cpu"``).

Each :class:`Request` carries its stamps on ``time.perf_counter()``, as
``PlanServer``'s requests do: ``t_submit``, ``t_admit`` (popped for its
prefill), ``t_first`` (its first token read back at the end of its
admission) and ``t_done`` (retired). With a :mod:`repro_torch.trace`
recorder on, a step records ``repro/engine/step`` holding each admission
(``repro/engine/admit``: the prefill, ``repro/engine/slot_copy`` and the
first token's ``repro/engine/readback``), then the decode, the pool's
``repro/engine/readback`` and ``repro/engine/retire``; each admission adds
its wait as ``repro/engine/queued``, and the counters ``engine.admitted``,
``engine.prompt_tokens``, ``engine.decode_steps``, ``engine.slot_steps``
(the whole pool each decode) and ``engine.live_slot_steps`` (the slots
holding a request).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.serve.engine import ServeConfig, make_decode, make_prefill


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                  # prompt (prompt_len,)
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class ContinuousConfig:
    slots: int = 4
    cache_len: int = 256
    window: int = 0


class ContinuousEngine:
    def __init__(self, cfg: ArchConfig, params, ccfg: ContinuousConfig,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.ccfg = cfg, ccfg
        self.params = T.tree_map(lambda t: t.to(self.device), params)
        self.cache = T.init_cache(cfg, ccfg.slots, ccfg.cache_len,
                                  self.device)
        self.pos = np.zeros(ccfg.slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * ccfg.slots
        self.queue: List[Request] = []
        self.last_tok = np.zeros(ccfg.slots, np.int32)
        scfg = ServeConfig(cache_len=ccfg.cache_len, window=ccfg.window)
        self._decode = make_decode(cfg, scfg, self.device)
        self._prefill = make_prefill(cfg, scfg, self.device)

    # -- scheduling ----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.ccfg.slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            req.t_admit = time.perf_counter()
            n = len(req.tokens)
            trace.add_span("repro/engine/queued", req.t_submit, req.t_admit,
                           rid=req.rid)
            trace.count("engine.admitted")
            trace.count("engine.prompt_tokens", n)
            with trace.span("repro/engine/admit", rid=req.rid, tokens=n):
                logits, cache1 = self._prefill(self.params, req.tokens[None])
                # copy the request's prefilled cache into slot s, in place
                with trace.span("repro/engine/slot_copy", rid=req.rid), \
                        torch.inference_mode():
                    for name, pool in self.cache.items():
                        pool[:, s].copy_(cache1[name][:, 0])
                self.slot_req[s] = req
                self.pos[s] = n
                with trace.span("repro/engine/readback", rid=req.rid):
                    self.last_tok[s] = int(torch.argmax(logits[0, -1]))
                req.t_first = time.perf_counter()
                req.out.append(int(self.last_tok[s]))

    def _retire(self) -> None:
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if (len(req.out) >= req.max_new_tokens
                    or (req.eos_id is not None and req.out
                        and req.out[-1] == req.eos_id)):
                req.done = True
                req.t_done = time.perf_counter()
                self.slot_req[s] = None     # slot storage recycled in place
                self.pos[s] = 0

    # -- one engine step ------------------------------------------------
    def step(self) -> int:
        """Admit, decode one token for every active slot, retire. Returns
        the number of active requests after the step."""
        live = sum(r is not None for r in self.slot_req)
        with trace.span("repro/engine/step", slots=live):
            self._retire()
            self._admit()
            active = [s for s, r in enumerate(self.slot_req) if r is not None]
            if not active:
                return 0
            trace.count("engine.decode_steps")
            trace.count("engine.slot_steps", self.ccfg.slots)
            trace.count("engine.live_slot_steps", len(active))
            logits, self.cache = self._decode(
                self.params, self.cache, self.last_tok[:, None],
                torch.as_tensor(self.pos, device=self.device))
            with trace.span("repro/engine/readback"):
                nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32) \
                    .cpu().numpy()
            for s in active:
                self.pos[s] += 1
                self.last_tok[s] = nxt[s]
                self.slot_req[s].out.append(int(nxt[s]))
            with trace.span("repro/engine/retire"):
                self._retire()
            return sum(r is not None for r in self.slot_req)

    def run(self, max_steps: int = 1000) -> None:
        for _ in range(max_steps):
            active = self.step()
            if active == 0 and not self.queue:
                break
