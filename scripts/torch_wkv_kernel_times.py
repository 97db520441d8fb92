#!/usr/bin/env python3
"""Time ``csrc/wkv_chunk.cu`` on the card: one call, and each of its three
kernels.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_wkv_kernel_times.py

On the rwkv6-1.6b-width inputs of ``chip_smoke.py`` (``WKV_FULL``: B 1,
S 4096, 32 heads of 64, q 64; logw = -exp(z / 2) from a seed) it holds
the kernel against ``wkv_plain`` at 3e-4 (y and state), times one call
with CUDA events (``chip_smoke.time_ms``, 20 calls after a warm-up), and
traces ten calls with ``torch.profiler`` for each kernel's device time a
call (phase A ``state_parts``, B ``state_scan``, C ``chunk_outputs``;
"not measured" where the trace holds no device time).

It prints one JSON line: the card's name and power limit, the call's ms,
the largest errors, the per-kernel ms and the ptxas resources. It exits 1
when the kernel disagrees with the plain version.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPS = 20
TOL = 3e-4


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv_chunk as TW
    build.load()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    b, s, h, d, q = cs.WKV_FULL
    rng = np.random.default_rng(23)

    def normal(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda()
    r, k, v, z = (normal(b, s, h, d) for _ in range(4))
    logw = -torch.exp(z * 0.5)
    u = normal(h, d) * 0.1

    def call():
        return TW.wkv_chunk_kernel(r, k, v, logw, u, q=q)

    y0, st0 = TW.wkv_plain(r, k, v, logw, u, q)
    y, st = call()
    torch.cuda.synchronize()
    errs, ok = {}, True
    for part, got, want in (("y", y, y0), ("state", st, st0)):
        errs[part] = float((got - want).abs().max().item())
        ok &= bool(torch.isfinite(got).all()) and bool(
            ((got - want).abs() <= TOL + TOL * want.abs()).all())
    ms = cs.time_ms(torch, call, REPS)

    per_kernel = {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for kern in ("state_parts", "state_scan", "chunk_outputs"):
            if kern in ev.key:
                total = getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
                per_kernel[kern] = (total / 1e3 / 10 if total
                                    else "not measured")
    print(json.dumps({"card": smi, "shape": cs.WKV_FULL, "ms": ms,
                      "max_abs_err": errs, "ok": ok,
                      "kernel_ms": per_kernel or "not measured",
                      "ptxas": build.ptxas_resources("wkv_chunk")}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
