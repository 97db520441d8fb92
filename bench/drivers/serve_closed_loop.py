"""A closed loop of clients over the port's ``ContinuousEngine``.

Set-up draws the weights on the card from the seed, builds the engine
(its ring cache for every slot), serves one request of the longest and
one of the shortest prompt of the grid as a warm-up, then submits one
request a client; the window opens when the step that admits them returns,
with every slot busy. In the window a client submits its next request the
moment its last one retires, which the loop sees when ``step()`` returns:
that return is also when a request's first token shows. The window closes
at the first return past ``--seconds``.

Traced (``--trace 1``), the engine's prefill and decode calls are timed
on the host around a synchronise, each ``kernels.ops.flash_attention``
call between CUDA events, and the loop then runs on for the cell's
``profile_seconds`` under ``torch.profiler``.

Then the engine is dropped and the plain reference (``reference/<family>
.py``) reads a sample of the requests the window finished, drawn from the
seed with the longest prompt in it: each prompt with its served tokens, in
float32. The gap by which a served token's logit lies below the
reference's best at its position, its mean over the sample's served
tokens, is compared with the cell's limit."""
from __future__ import annotations

import importlib
import time
from contextlib import nullcontext

import numpy as np

from bench import harness, traffic


def run(r: harness.Run) -> None:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import continuous as C

    wl, c, dev = r.workload, r.config, r.device
    ref = importlib.import_module(f"bench.reference.{c['family']}")
    pcfg = harness.port_config(c)
    dtype = getattr(torch, c["torch_dtype"])
    weights = ref.make_weights(c, r.seed, dev, dtype)
    reqs = traffic.pool(wl, r.seed, c["vocab_size"], wl["pool"])
    grid = traffic.grid(wl["prompt_len"], wl["block"])
    rng = np.random.default_rng((r.seed + 1) % (1 << 63))
    warm = [traffic.Req(-1 - i, rng.integers(0, c["vocab_size"], size=n,
                                             dtype=np.int32),
                        wl["warmup_max_new"])
            for i, n in enumerate((max(grid), min(grid)))]
    eng = C.ContinuousEngine(
        pcfg, weights, C.ContinuousConfig(slots=wl["slots"],
                                          cache_len=wl["cache_len"]),
        device=dev)
    ev = harness.Events(dev)
    waiting = []          # submitted, not yet prefilled, in engine order
    state = {"open": None, "label": None}

    def submit(q: traffic.Req, t: float) -> None:
        q.submit_t = t
        waiting.append(q)
        q.handle = C.Request(rid=q.idx, tokens=q.tokens,
                             max_new_tokens=q.max_new)
        eng.submit(q.handle)

    def record_fn(name):
        from torch.profiler import record_function
        return record_function(name) if state["label"] else nullcontext()

    def prefill(real):
        def fn(params, inputs):
            q = waiting.pop(0)
            q.prefill_t = time.perf_counter()
            if not r.trace:
                return real(params, inputs)
            with record_fn("bench/prefill"):
                harness.sync(dev)
                t0 = time.perf_counter()
                out = real(params, inputs)
                harness.sync(dev)
            if state["open"] is not None:
                r.add("prefill", t=t0, s=time.perf_counter() - t0,
                      tokens=int(np.asarray(inputs).shape[-1]))
            return out
        return fn

    def decode(real):
        def fn(params, cache, tokens, pos):
            if not r.trace:
                return real(params, cache, tokens, pos)
            active = [int(eng.pos[s]) for s, q in enumerate(eng.slot_req)
                      if q is not None]
            with record_fn("bench/decode"):
                harness.sync(dev)
                t0 = time.perf_counter()
                out = real(params, cache, tokens, pos)
                harness.sync(dev)
            if state["open"] is not None:
                r.add("decode", t=t0, s=time.perf_counter() - t0,
                      positions=active)
            return out
        return fn

    def flash(real):
        def fn(q, k, v, *a, **kw):
            e0 = ev.start()
            out = real(q, k, v, *a, **kw)
            if state["open"] is not None:
                r.add("flash_attention", ev=(e0, ev.start()),
                      s_len=int(q.shape[0]), bh=int(q.shape[1]),
                      d=int(q.shape[2]), esize=q.element_size())
            return out
        return fn

    undo = [harness.wrap(eng, "_prefill", prefill),
            harness.wrap(eng, "_decode", decode)]
    if r.trace:
        undo.append(harness.wrap(ops, "flash_attention", flash))
    try:
        for q in warm:
            submit(q, time.perf_counter())
        eng.run()
        clients = reqs[:wl["clients"]]
        sent = list(clients)
        nxt = len(clients)
        now = time.perf_counter()
        for q in clients:
            submit(q, now)
        eng.step()
        harness.sync(dev)
        inflight = list(clients)
        t_open = time.perf_counter()
        for q in clients:
            q.first_t = t_open
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state["open"] = t_open
        done = []

        def loop(until: float) -> float:
            nonlocal nxt, inflight
            while True:
                with record_fn("bench/step"):
                    eng.step()
                t = time.perf_counter()
                with record_fn("bench/client"):
                    still = []
                    for q in inflight:
                        er = q.handle
                        if q.first_t < 0 and er.out:
                            q.first_t = t
                        if er.done:
                            q.done_t, q.out = t, list(er.out)
                            done.append(q)
                            src = reqs[nxt % len(reqs)]
                            nq = traffic.Req(nxt, src.tokens, src.max_new)
                            sent.append(nq)
                            nxt += 1
                            submit(nq, t)
                            still.append(nq)
                        else:
                            still.append(q)
                    inflight = still
                if t >= until:
                    return t

        t_close = loop(t_open + r.seconds)
        r.window_s = t_close - t_open
        r.setup_s = t_open - r.t_start
        if torch.device(dev).type == "cuda":
            r.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        state["open"] = None
        if r.trace:
            state["label"] = True
            r.profile = harness.profile(
                lambda: loop(time.perf_counter() + wl["profile_seconds"]),
                dev)
            state["label"] = None
    finally:
        for u in undo:
            u()
    finished = [q for q in done if t_open < q.done_t <= t_close]
    firsts = [q for q in sent if t_open < q.first_t <= t_close]
    r.attempted = len(finished)
    r.failed = sum(len(q.out) != q.max_new for q in finished)
    r.e2e = {"setup_s": r.setup_s, "peak_mem_gb": r.memory_peak_bytes / 1e9}
    if finished:
        r.e2e["req_s"] = len(finished) / r.window_s
    if firsts:
        r.e2e["ttft_p90_ms"] = 1e3 * harness.quantile(
            [q.first_t - q.submit_t for q in firsts], 0.9)
    r.extra["queue_wait_s"] = [q.prefill_t - q.submit_t for q in firsts]
    r.extra["flash_bound_s"] = _flash_bounds(r, c)
    del eng
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = check(r, c, ref, weights, finished, low=r.extra.get("control"))
    r.extra["check"], r.extra["check_s"] = res, time.perf_counter() - t0
    r.checks["mean_logit_gap"] = (res["served_mean"],
                                  wl["check"]["mean_logit_gap"])


def _flash_bounds(r: harness.Run, c: dict) -> list:
    """(seconds, bound seconds) of every flash call of the window, the
    bound from the model's heads (``costs/flash.py``)."""
    from bench.costs import flash
    ev = harness.Events(r.device)
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    harness.sync(r.device)
    out = []
    for rec in r.calls.get("flash_attention", []):
        b = rec["bh"] // h
        out.append((ev.seconds(*rec["ev"]),
                    flash.forward_bound_s(b, rec["s_len"], h, kv, rec["d"],
                                          rec["esize"])))
    return out


def sample(finished, seed: int, tokens: int) -> list:
    """The requests the reference reads: the longest prompt, then others
    drawn from ``seed`` until ``tokens`` served tokens."""
    if not finished:
        return []
    rng = np.random.default_rng((seed + 2) % (1 << 63))
    order = sorted(finished, key=lambda q: -len(q.tokens))
    picked = [order[0]]
    rest = list(rng.permutation(len(order) - 1) + 1)
    while rest and sum(len(q.out) for q in picked) < tokens:
        picked.append(order[rest.pop()])
    return picked


def check(r: harness.Run, c: dict, ref, weights, finished, low: bool
          ) -> dict:
    """The reference over the sample: the gap by which each served
    token's float32 logit lies below the best at its position, its mean
    over the sample's served tokens (``served_mean``, the number
    compared) and its widest (``served``); with ``low`` the same of the
    token that the reference computed in the control's precision puts
    first (``control_mean``, ``control``)."""
    import torch
    from bench.reference import plain_f32
    picked = sample(finished, r.seed, r.workload["check"]["sample_tokens"])
    out = {"served": float("inf"), "served_mean": float("inf"),
           "control": float("nan"), "control_mean": float("nan"),
           "requests": len(picked),
           "tokens": sum(len(q.out) for q in picked)}
    if not picked:
        return out
    served, ctrl = [], []
    with plain_f32():
        for q in picked:
            seq = np.concatenate([q.tokens, np.asarray(q.out[:-1],
                                                       np.int32)])
            toks = torch.as_tensor(seq, device=r.device).long()
            at = torch.arange(len(q.tokens) - 1, len(seq), device=r.device)
            lg = ref.logits_at(c, weights, toks, at)
            best = lg.max(-1).values
            got = torch.as_tensor(q.out, device=r.device).long()
            gap = best - lg.gather(1, got[:, None])[:, 0]
            served.append(float(gap.max()))
            detail = {"prompt": len(q.tokens), "tokens": len(q.out),
                      "served_max": served[-1],
                      "served_sum": float(gap.sum())}
            if low:
                lo = ref.logits_at(c, weights, toks, at, low=True)
                pick = lo.argmax(-1)
                cg = best - lg.gather(1, pick[:, None])[:, 0]
                ctrl.append(float(cg.max()))
                detail.update(control_max=ctrl[-1],
                              control_sum=float(cg.sum()))
            out.setdefault("per_request", []).append(detail)
    out["served"] = max(served)
    out["served_mean"] = sum(d["served_sum"] for d in out["per_request"]) \
        / out["tokens"]
    if ctrl:
        out["control"] = max(ctrl)
        out["control_mean"] = sum(d["control_sum"] for d in
                                  out["per_request"]) / out["tokens"]
    return out
