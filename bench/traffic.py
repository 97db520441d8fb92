"""The one generator of traffic: a cell's parameters in, requests out.

Every seed gets the same sizes in the same order: the pool is made of
blocks, each holding every point of the length grid and of the output
grid once, in an order drawn from the cell's own ``order_seed``; the run's
seed draws the token ids. So two seeds differ in content, not in the work
they ask for nor in how a closed loop's arrivals fall together, which sets
a latency tail."""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass
class Req:
    """One request of the pool and what the closed loop saw of it."""
    idx: int
    tokens: np.ndarray
    max_new: int
    submit_t: float = 0.0
    prefill_t: float = -1.0
    first_t: float = -1.0
    done_t: float = -1.0
    out: List[int] = dataclasses.field(default_factory=list)
    #: the engine's own request object
    handle: Any = None


def grid(spec: dict, n: int) -> List[int]:
    """``n`` points at the middle quantiles of ``spec``: ``log_uniform``
    or ``uniform`` between ``min`` and ``max``."""
    lo, hi = spec["min"], spec["max"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["kind"] == "log_uniform":
        return [int(round(lo * (hi / lo) ** q)) for q in qs]
    if spec["kind"] == "uniform":
        return [int(round(lo + (hi - lo) * q)) for q in qs]
    raise ValueError(f"traffic: unknown kind {spec['kind']!r}")


def pool(params: dict, seed: int, vocab: int, n: int) -> List[Req]:
    """``n`` requests (whole blocks of ``params["block"]``), ids uniform
    over ``vocab`` from ``seed``."""
    order = np.random.default_rng(params["order_seed"])
    rng = np.random.default_rng(seed % (1 << 63))
    blk = params["block"]
    lens = grid(params["prompt_len"], blk)
    news = grid(params["max_new_tokens"], blk)
    out = []
    while len(out) < n:
        for ln, new in zip(order.permutation(lens), order.permutation(news)):
            toks = rng.integers(0, vocab, size=int(ln), dtype=np.int32)
            out.append(Req(len(out), toks, int(new)))
    return out
