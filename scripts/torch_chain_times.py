#!/usr/bin/env python3
"""Where a fused chain's time goes on the card: for each chain of the
flagship (int8, f32, int8 at batch 2; flat, row-blocked and streaming),
``mobilenet_v1_1.0_224_8bit`` (flat) and ``mobilenet_v2_1.0_224``
(blocked and streaming), the device ms of one ``arena_fused_chain`` or
``arena_stream_fused`` call (CUDA events, ``chip_smoke.time_auto``) and,
from ``torch.profiler``'s device times over 20 calls, the kernel's own
time and the counters' memset's, per call. The difference between the
event time and those two is the gap between them on the stream (launch
latency). Each chain's schedule (levels, tiles a level, grid) comes with
it. Counts, not measurements: the chain's bound (``chip_smoke.bound_ms``).

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_chain_times.py

Prints one JSON line per chain and the card's name and power limit.
"""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import exec as X
    from repro_torch.core import zoo
    from repro_torch.core.pipeline import compile
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build
    build.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    table3 = zoo.TABLE3_MODELS
    programs = {"flat": {}, "blocks": {"layout": "blocks"},
                "streaming": {"mode": "streaming"}}
    for label, graph, batch, progs in (
            ("flagship", zoo.mobilenet_v1(0.25, 128, 1), 1, programs),
            ("flagship f32", zoo.mobilenet_v1(0.25, 128, 4), 1, programs),
            ("flagship batch 2", zoo.mobilenet_v1(0.25, 128, 1), 2,
             programs),
            ("mobilenet_v1_1.0_224_8bit",
             table3["mobilenet_v1_1.0_224_8bit"][0](), 1, ("flat",)),
            ("mobilenet_v2_1.0_224", table3["mobilenet_v2_1.0_224"][0](), 1,
             ("blocks", "streaming"))):
        cp = compile(graph, backend="numpy", batch=batch)
        for program in progs:
            ex = X.get_backend("cuda", **programs[program])
            specs, ws, descs, state = ex.program(cp)
            for spec, w, d in zip(specs, ws, descs):
                if spec.kind == "fused":
                    break
                K.apply_op(state, spec, w, d)
            a = state.clone()
            ms = cs.time_auto(torch, lambda: K.apply_op(a, spec, w, d))
            n = 20
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    K.apply_op(a, spec, w, d)
                torch.cuda.synchronize()
            dev = {}
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0))
                if t:
                    dev[ev.key] = t / 1e3 / n    # ms a call
            kernel = sum(v for k, v in dev.items() if "chain" in k
                         or "fused" in k)
            memset = sum(v for k, v in dev.items() if "emset" in k)
            s = K.chain_schedule(spec)
            print(json.dumps({
                "chain": f"{label} {program}", "kernel": K.kernel_of(spec),
                "ms": ms, "kernel_ms": kernel, "memset_ms": memset,
                "device_ms": dev, "bound_ms": cs.bound_ms(spec),
                "levels": [len(lv) for lv in s.levels],
                "tiles": [sum(s.items[j] for j in lv) for lv in s.levels],
                "grid": s.grid, "barriers": s.n_barriers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
