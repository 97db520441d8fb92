"""Graphs and helpers the port's serving tests share (CPU and card); this
module imports nothing of the JAX package."""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def band_graph(h: int = 12, c: int = 4, db: int = 4, depth: int = 2,
               branch: bool = True) -> Graph:
    """``tests/test_batching.py``'s ``band_graph``, built by the port."""
    g = Graph(f"bg_{h}_{c}_{db}_{depth}_{int(branch)}")
    x = g.tensor("x", (h, h, c), db, "input")
    cur = g.op("conv2d", [x], (h, h, c),
               dict(kernel=(3, 3), stride=(1, 1), padding="same"))
    for _ in range(depth):
        nxt = g.op("depthwise_conv2d", [cur], (h, h, c),
                   dict(kernel=(3, 3), stride=(1, 1), padding="same"))
        if branch:
            nxt = g.op("elementwise", [nxt, cur], (h, h, c), dict(fn="add"))
        cur = nxt
    p = g.op("pool", [cur], (h // 2, h // 2, c),
             dict(kernel=(2, 2), stride=(2, 2), padding="valid",
                  mode="max"))
    m = g.op("mean", [p], (c,), dict(axes=(0, 1)))
    g.op("fully_connected", [m], (8,), out_kind="output")
    g.validate()
    return g


def alone(fx, im):
    """``fx`` (a FastExec) on one request, batch axis dropped."""
    return {k: v[0] for k, v in fx.run({n: np.asarray(a)[None]
                                        for n, a in im.items()}).items()}
