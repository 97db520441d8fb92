"""Steps of the port's ``train/steps.py::make_train_step``, one object
from set-up to the window.

Set-up draws the weights on the card from the seed, builds the AdamW
state beside them (``optim/adamw.py::init``) and the step (remat,
``default_microbatches``), and drives the step through its first
``checked_steps`` steps on batches of token ids drawn on the card from
the seed: the losses, each leaf's first gradient as the optimizer got it
(its first moment after one step over 1 - b1) and each leaf's change after
the checked steps are kept. The window then runs the same step on fresh
batches until ``--seconds`` have passed, each step ended by reading its
loss. Traced, ``adamw.update`` and the WKV kernels' entries run between
CUDA events, and ``profile_steps`` more steps run under
``torch.profiler``.

Then the port's state is dropped and the plain reference
(``reference/<family>.py``) trains float32 weights drawn again from the
seed on the same first batches; the three numbers compared are the worst
relative gaps of the losses, of the leaves' first-gradient norms and of
their change norms."""
from __future__ import annotations

import importlib
import statistics
import time

from bench import harness


def batches(r: harness.Run, vocab: int):
    """Fresh (B, S) token ids each step, drawn on the run's device from a
    generator seeded by the run's seed: the same seed gives the same
    batches to the port and to the reference."""
    import torch
    wl = r.workload
    g = torch.Generator(device=r.device)
    g.manual_seed((r.seed * 7919 + 1) % (1 << 63))
    while True:
        ids = torch.randint(0, vocab, (wl["batch"], wl["seq_len"] + 1),
                            generator=g, device=r.device)
        yield {"inputs": ids[:, :-1], "targets": ids[:, 1:]}


def run(r: harness.Run) -> None:
    import torch
    from repro_torch.kernels import wkv_chunk as W
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS

    wl, c, dev = r.workload, r.config, r.device
    ref = importlib.import_module(f"bench.reference.{c['family']}")
    pcfg = harness.port_config(c)
    dtype = getattr(torch, c["torch_dtype"])
    cuda = torch.device(dev).type == "cuda"
    opt_cfg = adamw.OptConfig(**wl["optimizer"])
    mbs = TS.default_microbatches(pcfg, wl["batch"], wl["seq_len"], 1)
    if mbs != wl["microbatches"]:
        raise RuntimeError(f"default_microbatches gives {mbs}, the cell "
                           f"states {wl['microbatches']}")
    state = {"params": ref.make_weights(c, r.seed, dev, dtype)}
    state["opt"] = adamw.init(state["params"], opt_cfg.moment_dtype)
    step = TS.make_train_step(pcfg, opt_cfg, remat=wl["remat"],
                              microbatches=mbs)
    data = batches(r, c["vocab_size"])
    tokens = wl["batch"] * wl["seq_len"]

    losses, first = [], None
    for i in range(wl["checked_steps"]):
        _, m = step(state, next(data))
        losses.append(float(m["loss"]))
        if i == 0:
            first = [float(torch.linalg.vector_norm(t)) / (1 - opt_cfg.b1)
                     for t in adamw.tree_leaves(state["opt"]["m"])]
    start = ref.make_weights(c, r.seed, dev, dtype)
    change = [float(torch.linalg.vector_norm(p - p0)) for p, p0 in
              zip(adamw.tree_leaves(state["params"]),
                  adamw.tree_leaves(start))]
    del start

    ev = harness.Events(dev)
    timed = {"on": False}

    def update(real):
        def fn(*a, **kw):
            if not timed["on"]:
                return real(*a, **kw)
            e0 = ev.start()
            out = real(*a, **kw)
            r.add("update", ev=(e0, ev.start()))
            return out
        return fn

    def kernel(name, bound):
        def make(real):
            def fn(rr, *a, **kw):
                if not timed["on"]:
                    return real(rr, *a, **kw)
                e0 = ev.start()
                out = real(rr, *a, **kw)
                b, s, h, d = rr.shape
                r.add(name, ev=(e0, ev.start()), bound_s=bound(b, s, h, d))
                return out
            return fn
        return make

    from bench.costs import wkv
    undo = []
    if r.trace:
        undo = [harness.wrap(adamw, "update", update),
                harness.wrap(W, "wkv_chunk_kernel",
                             kernel("wkv_forward", wkv.forward_bound_s)),
                harness.wrap(W, "wkv_backward_kernel",
                             kernel("wkv_backward", wkv.backward_bound_s))]
    try:
        harness.sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        timed["on"] = r.trace
        t_open = t = time.perf_counter()
        n, bad = 0, 0
        while t - t_open < r.seconds:
            _, m = step(state, next(data))
            loss = float(m["loss"])
            t = time.perf_counter()
            n += 1
            bad += not (loss == loss and abs(loss) < float("inf"))
        timed["on"] = False
        r.window_s = t - t_open
        r.setup_s = t_open - r.t_start
        if cuda:
            r.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        if r.trace:
            def more():
                from torch.profiler import record_function
                for _ in range(wl["profile_steps"]):
                    with record_function("bench/step"):
                        _, mm = step(state, next(data))
                    with record_function("bench/loss"):
                        float(mm["loss"])
            r.profile = harness.profile(more, dev)
    finally:
        for u in undo:
            u()
    r.attempted, r.failed = n, bad
    r.e2e = {"setup_s": r.setup_s, "train_tok_s": n * tokens / r.window_s,
             "peak_mem_gb": r.memory_peak_bytes / 1e9}
    r.extra["steps"] = n
    del state, m
    if cuda:
        torch.cuda.empty_cache()
    got = {"loss": losses, "grad": first, "change": change}
    t0 = time.perf_counter()
    want = reference(r, c, ref, dtype, tf32=False)
    r.extra["check_s"] = time.perf_counter() - t0
    for name, v in compare(got, want).items():
        r.checks[name] = (v, wl["check"][name])
    r.extra["leaves_kept"] = (len(kept(want)), len(want["grad"]))
    if r.extra.get("control"):
        r.extra["control_check"] = compare(
            reference(r, c, ref, dtype, tf32=True), want)
        r.extra["half_batch_check"] = compare(
            reference(r, c, ref, dtype, tf32=False,
                      rows=wl["batch"] // 2), want)


def reference(r: harness.Run, c: dict, ref, dtype, tf32: bool,
              rows=None) -> dict:
    """The reference's losses, first-gradient and change norms a leaf over
    the run's checked steps, from the seed's weights and batches
    (``tf32``: the control's precision; ``rows``: the batch cut to its
    first rows, a fault)."""
    import torch
    from bench.reference import plain_f32
    wl = r.workload
    w = ref.make_weights(c, r.seed, r.device, torch.float32)
    data = batches(r, c["vocab_size"])
    if rows:
        data = ({k: v[:rows] for k, v in b.items()} for b in data)
    with plain_f32(tf32):
        losses, first, change = ref.train(c, w, data, wl["optimizer"],
                                          wl["checked_steps"])
    del w
    return {"loss": losses, "grad": first, "change": change}


def leaf_gap(got, want, keep) -> float:
    """The worst gap |got - want| of the kept leaves' norms, each against
    the larger of its reference norm and the median reference norm."""
    med = statistics.median(want[i] for i in keep)
    return max(abs(got[i] - want[i]) / max(want[i], med) for i in keep)


def kept(want: dict) -> list:
    """The leaves whose reference first gradient is at least a thousandth
    of the median leaf's."""
    med = statistics.median(want["grad"])
    return [i for i, g in enumerate(want["grad"]) if g >= 1e-3 * med]


def compare(got: dict, want: dict) -> dict:
    """``loss_gap``: the worst relative gap of the checked steps' losses;
    ``grad_norm_gap`` and ``change_norm_gap`` by :func:`leaf_gap` over the
    leaves whose reference first gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    keep = kept(want)
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["loss"], want["loss"])),
            "grad_norm_gap": leaf_gap(got["grad"], want["grad"], keep),
            "change_norm_gap": leaf_gap(got["change"], want["change"],
                                        keep)}
