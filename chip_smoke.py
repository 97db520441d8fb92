#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every kernel from ``src/repro_torch/kernels/csrc`` and prints the
   build time and the ``-Xptxas -v`` register and shared-memory report;
3. holds every kernel against its plain PyTorch version on the card: every
   spec of the lowered flat program of the flagship (int8 and f32) and of
   ``mobilenet_v1_1.0_224_8bit`` (whose fused chain takes the global
   scratch branch; the flagship's takes shared memory) runs once through
   the kernel and once through the plain version on copies of the arena as
   the program reaches that spec, and the whole arena is compared (int8
   bit-exact except softmax <= 1 LSB, f32 within 1e-4 + 1e-4 * |ref|);
4. runs the slice: ``compile(mobilenet_v1(0.25, 128, 1), backend="cuda")``
   (verified ``numeric+cuda``, winner ``fuse``, 49,805 B) and three requests
   through ``CompiledPlan.execute``, each matching the numpy backend and
   counting 29 launches, with the launch counts reset just before;
5. the same on the f32 flagship, the flagship at batch 2 and
   ``mobilenet_v1_1.0_224_8bit``;
6. times ``execute()`` and every kernel with CUDA events (per flagship
   forward: the sum over the kernel's launches), the plain versions, and
   one PyTorch call per kernel kind at the flagship's f32 shapes as the
   yardstick (``F.conv2d`` with TF32 off, ``torch.mean``, ``torch.matmul``,
   ``torch.softmax``; the port never calls them);
7. writes every number to ``build/chip_smoke.json`` and prints the
   ``kernels`` JSON line, the card line, and as its last line the device
   JSON.

Any failed check raises and the script exits non-zero. It exits 2, printing
no result, when no CUDA device is visible or when it does not sit at the
root of a checkout of the repository.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

FLAGSHIP_BYTES = 49_805
HBM_BYTES_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_S = 67e12              # f32 outside the tensor cores
F32_TOL = 1e-4

KERNELS = {
    # name -> (source, TPU kernel it replaces)
    "arena_conv": ("src/repro_torch/kernels/csrc/arena_conv.cu",
                   "src/repro/kernels/arena_ops.py:525"),
    "arena_mean": ("src/repro_torch/kernels/csrc/arena_mean.cu",
                   "src/repro/kernels/arena_ops.py:692"),
    "arena_fully_connected": (
        "src/repro_torch/kernels/csrc/arena_fully_connected.cu",
        "src/repro/kernels/arena_ops.py:638"),
    "arena_softmax": ("src/repro_torch/kernels/csrc/arena_softmax.cu",
                      "src/repro/kernels/arena_ops.py:628"),
    "arena_fused_chain": ("src/repro_torch/kernels/csrc/arena_fused_chain.cu",
                          "src/repro/kernels/arena_ops.py:736"),
}
KIND_KERNEL = {"conv2d": "arena_conv", "depthwise_conv2d": "arena_conv",
               "mean": "arena_mean", "fully_connected": "arena_fully_connected",
               "softmax": "arena_softmax", "fused": "arena_fused_chain"}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# per-spec helpers
# ---------------------------------------------------------------------------


def plain(K, arena, spec, w) -> None:
    """The spec's plain PyTorch version on the same (CUDA) arena."""
    if spec.kind in ("conv2d", "depthwise_conv2d"):
        K.conv_plain(arena, spec, w)
    elif spec.kind == "mean":
        K.mean_plain(arena, spec)
    elif spec.kind == "fully_connected":
        K.fully_connected_plain(arena, spec, w)
    elif spec.kind == "softmax":
        K.softmax_plain(arena, spec)
    elif spec.kind == "fused":
        K.fused_chain_plain(arena, spec, w)
    else:
        raise SmokeError(f"no plain version for {spec.kind}")


def out_range(spec):
    """Byte range of the arena a spec writes (a fused chain: its terminal
    concat's output)."""
    n = 1
    for s in spec.out_shape:
        n *= int(s)
    isz = 1 if spec.dtype == "i8" else 4
    return spec.out_off, spec.out_off + n * isz


def arena_diff(torch, got, ref, spec) -> float:
    """Max abs difference of two arenas after one spec; raises past the
    tolerance. Bytes outside the spec's output must be equal."""
    lo, hi = out_range(spec)
    outside = torch.ones(got.numel(), dtype=torch.bool, device=got.device)
    outside[lo:hi] = False
    check(torch.equal(got[outside], ref[outside]),
          f"{spec.kind}: bytes outside its output differ")
    if spec.dtype == "i8":
        g = got[lo:hi].view(torch.int8).to(torch.int32)
        r = ref[lo:hi].view(torch.int8).to(torch.int32)
        err = (g - r).abs().max().item() if hi > lo else 0
        limit = 1 if spec.kind == "softmax" else 0
        check(err <= limit, f"{spec.kind}: int8 max error {err} > {limit}")
        return float(err)
    g = got[lo:hi].view(torch.float32)
    r = ref[lo:hi].view(torch.float32)
    err = (g - r).abs()
    check(bool(torch.isfinite(g).all()), f"{spec.kind}: non-finite output")
    check(bool((err <= F32_TOL + F32_TOL * r.abs()).all()),
          f"{spec.kind}: f32 error {err.max().item()} over tolerance")
    return float(err.max().item())


def spec_cost(spec):
    """(bytes the op must move, operations, operation rate) at this spec:
    each input read once, each output written once, filters read once;
    multiply-adds count two operations (every tap of the window)."""
    isz = 1 if spec.dtype == "i8" else 4
    rate = INT8_OPS_S if spec.dtype == "i8" else F32_OPS_S

    def el(shape):
        n = 1
        for s in shape:
            n *= int(s)
        return n

    if spec.kind == "fused":
        ext = sum(el(s) for s in spec.in_shape) * isz
        out = el(spec.out_shape) * isz
        w_bytes, ops = 0, 0
        for st in spec.stages:
            if st.kind in ("conv2d", "depthwise_conv2d"):
                b, o, _ = spec_cost(st)
                ops += o
                kh, kw = st.meta[:2]
                ic, oc = st.in_shape[0][-1], st.out_shape[-1]
                w_bytes += kh * kw * (ic * oc if st.kind == "conv2d"
                                      else oc) * isz
        return ext + out + w_bytes, ops, rate
    inb = sum(el(s) for s in spec.in_shape) * isz
    outb = el(spec.out_shape) * isz
    if spec.kind in ("conv2d", "depthwise_conv2d"):
        kh, kw = spec.meta[:2]
        ic = spec.in_shape[0][-1]
        oc = spec.out_shape[-1]
        per = kh * kw * (ic if spec.kind == "conv2d" else 1)
        wb = kh * kw * (ic * oc if spec.kind == "conv2d" else oc) * isz
        return inb + outb + wb, 2 * el(spec.out_shape) * per, rate
    if spec.kind == "fully_connected":
        idim = spec.in_shape[0][-1]
        return inb + outb + idim * el(spec.out_shape) * isz, \
            2 * idim * el(spec.out_shape), rate
    return inb + outb, 4 * el(spec.in_shape[0]), rate


def bound_ms(spec) -> float:
    nbytes, ops, rate = spec_cost(spec)
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / rate)


def bound_by(specs) -> str:
    t_bytes = sum(spec_cost(s)[0] / HBM_BYTES_S for s in specs)
    t_ops = sum(spec_cost(s)[1] / spec_cost(s)[2] for s in specs)
    return "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls queued
    behind a sleep kernel, so host launch overhead does not show as device
    idle time between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def compare_program(torch, K, be, cp, label: str, errs, weights=None,
                    quant=None):
    """Phase 3 for one compiled plan: every spec, kernel vs plain, on copies
    of the arena as the program reaches it. Returns the specs."""
    specs, ws, descs, state = be.program(cp, None, weights, quant=quant)
    for spec, w, d in zip(specs, ws, descs):
        got = state.clone()
        K.apply_op(got, spec, w, d)
        ref = state.clone()
        plain(K, ref, spec, w)
        torch.cuda.synchronize()
        name = KIND_KERNEL[spec.kind]
        err = arena_diff(torch, got, ref, spec)
        errs[name] = max(errs.get(name, 0.0), err)
        state = ref
    fused = [s for s in specs if s.kind == "fused"]
    branches = [("shared" if K.fused_smem_plan(s)[0] else "global")
                for s in fused]
    log(f"[kernels vs plain] {label}: {len(specs)} specs match "
        f"(fused scratch: {', '.join(branches) or 'none'})")
    return specs, branches


def run_requests(torch, K, X, cp, graph, n_launch: int, label: str,
                 peak: int, seeds=(0, 1, 2)):
    """Phase 4/5: requests through CompiledPlan.execute on the card, each
    against the numpy backend and counted. Returns launches per kernel over
    all requests and the arena the program allocates."""
    weights = X.synth_weights(graph, 0)
    quant = X.calibrate(graph, 0, weights) if X.needs_quant(graph) else None
    totals = {k: 0 for k in K.LAUNCHES}
    be = X.get_backend("cuda")
    _, _, _, arena = be.program(cp, None, weights, quant=quant)
    check(arena.device.type == "cuda" and arena.numel() == peak,
          f"{label}: device arena {arena.numel()} B on {arena.device}, "
          f"expected {peak} B on the card")
    for seed in seeds:
        inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
                  else X.random_inputs(graph, seed))
        K.reset_launches()
        got = cp.execute(inputs, weights, quant=quant)
        counts = dict(K.LAUNCHES)
        ref = X.get_backend("numpy").execute(cp, inputs, weights, quant=quant)
        X.compare_outputs(ref, got, exact=False, label=f"{label} seed {seed}")
        for k, v in got.items():
            check(bool(np.isfinite(v.astype(np.float64)).all()),
                  f"{label}: non-finite output {k}")
        check(sum(counts.values()) == n_launch,
              f"{label}: {sum(counts.values())} launches, expected "
              f"{n_launch}: {counts}")
        for k in totals:
            totals[k] += counts[k]
    log(f"[slice] {label}: {len(seeds)} requests match numpy, "
        f"{n_launch} launches each, device arena {peak} B")
    return totals


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.core import zoo
    from repro_torch.core import exec as X
    from repro_torch.core.pipeline import compile
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}; torch: {kind}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    build.load()
    log(f"[build] {build.LAST_BUILD_S:.1f} s into {build.build_dir()}")
    log(build.ptxas_report())

    # 3. every kernel against its plain version
    be = X.get_backend("cuda")
    flag = zoo.mobilenet_v1(0.25, 128, 1)
    cp8 = compile(flag, backend="numpy")
    errs = {}
    specs8, br8 = compare_program(torch, K, be, cp8, "flagship int8", errs)
    cp32 = compile(zoo.mobilenet_v1(0.25, 128, 4), backend="numpy")
    compare_program(torch, K, be, cp32, "flagship f32", errs)
    big = zoo.TABLE3_MODELS["mobilenet_v1_1.0_224_8bit"][0]()
    cpb = compile(big, backend="numpy")
    _, brb = compare_program(torch, K, be, cpb, "mobilenet_v1_1.0_224_8bit",
                             errs)
    check("shared" in br8 + brb and "global" in br8 + brb,
          "both fused scratch branches must run")

    # 4. the slice on the flagship
    cp = compile(flag, backend="cuda")
    check(cp.verified == "numeric+cuda", f"verified={cp.verified}")
    check(cp.winner == "fuse", f"winner={cp.winner}")
    check(cp.peak_bytes == FLAGSHIP_BYTES, f"peak={cp.peak_bytes}")
    check(len(specs8) == 29, f"{len(specs8)} specs")
    log(f"[slice] compile(flagship, backend='cuda'): verified={cp.verified} "
        f"winner={cp.winner} peak={cp.peak_bytes} B "
        f"baseline={cp.baseline_bytes} B")
    K.reset_launches()
    main_launches = run_requests(torch, K, X, cp, cp.graph, 29, "flagship",
                                 FLAGSHIP_BYTES)
    for name in KERNELS:
        check(main_launches[name] > 0, f"{name} never launched on the path")

    # 5. more configurations
    for label, graph, batch, peak, n in (
            ("flagship f32", zoo.mobilenet_v1(0.25, 128, 4), 1, 199_220, 29),
            ("flagship batch 2", flag, 2, 98_957, None),
            ("mobilenet_v1_1.0_224_8bit", big, 1, 517_052, None)):
        c = compile(graph, backend="cuda", batch=batch)
        check(c.peak_bytes == peak, f"{label}: peak {c.peak_bytes} != {peak}")
        n_specs = len(be.program(c)[0])
        check(n is None or n_specs == n, f"{label}: {n_specs} specs")
        log(f"[slice] compile({label}): verified={c.verified} "
            f"winner={c.winner} peak={c.peak_bytes} B")
        run_requests(torch, K, X, c, c.graph, n_specs, label, peak,
                     seeds=(0,))

    # 6. times
    ex = X.get_backend("cuda")
    w0 = X.synth_weights(cp.graph, 0)
    q0 = X.calibrate(cp.graph, 0, w0)
    in0 = X.quant_inputs(cp.graph, q0, 0)
    for _ in range(3):
        cp.execute(in0, w0, quant=q0)
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp.execute(in0, w0, quant=q0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    exec_ms = statistics.median(walls)
    log(f"[time] flagship execute(): median {exec_ms:.3f} ms over 20 "
        f"(host clock, inputs up and outputs down included)")

    def kernel_times(c, w=None, q=None):
        specs, ws, descs, state = ex.program(c, None, w, quant=q)
        per = {}
        for spec, wt, d in zip(specs, ws, descs):
            name = KIND_KERNEL[spec.kind]
            a = state.clone()
            k_ms = time_ms(torch, lambda: K.apply_op(a, spec, wt, d), 20)
            b = state.clone()
            p_ms = time_ms(torch, lambda: plain(K, b, spec, wt), 2)
            plain(K, state, spec, wt)
            row = per.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                        "bound_ms": 0.0, "specs": []})
            row["ms"] += k_ms
            row["plain_ms"] += p_ms
            row["bound_ms"] += bound_ms(spec)
            row["specs"].append(spec)
        return per, specs

    per8, _ = kernel_times(cp, w0, q0)
    per32, specs32 = kernel_times(cp32)

    # library yardsticks at the flagship's f32 shapes (never called by the
    # port): one PyTorch call per op, summed per kernel
    lib = {"arena_conv": 0.0, "arena_mean": 0.0,
           "arena_fully_connected": 0.0, "arena_softmax": 0.0}
    for spec in specs32:
        if spec.kind in ("conv2d", "depthwise_conv2d"):
            ih, iw, ic = spec.in_shape[0][-3:]
            oc = spec.out_shape[-1]
            kh, kw, sh, sw, dh, dw, ph, pw, m = spec.meta
            groups = ic if spec.kind == "depthwise_conv2d" else 1
            x = torch.randn(1, ic, ih, iw, device="cuda")
            wt = torch.randn(oc, ic // groups, kh, kw, device="cuda")
            oh, ow = spec.out_shape[-3:-1]
            # pad so the output has the op's size (SAME pads may be uneven)
            padh = max(0, (oh - 1) * sh + (kh - 1) * dh + 1 - ih)
            padw = max(0, (ow - 1) * sw + (kw - 1) * dw + 1 - iw)
            xp = F.pad(x, (pw, padw - pw, ph, padh - ph)) \
                if ph >= 0 else x
            lib["arena_conv"] += time_ms(torch, lambda: F.conv2d(
                xp, wt, stride=(sh, sw), dilation=(dh, dw), groups=groups),
                20)
        elif spec.kind == "mean":
            x = torch.randn(*spec.in_shape[0], device="cuda")
            axes = tuple(a % x.dim() for a in spec.meta[0])
            lib["arena_mean"] += time_ms(torch, lambda: x.mean(dim=axes), 20)
        elif spec.kind == "fully_connected":
            idim = spec.in_shape[0][-1]
            x = torch.randn(1, idim, device="cuda")
            wt = torch.randn(idim, spec.out_shape[-1], device="cuda")
            lib["arena_fully_connected"] += time_ms(
                torch, lambda: torch.matmul(x, wt), 20)
        elif spec.kind == "softmax":
            x = torch.randn(*spec.in_shape[0], device="cuda")
            lib["arena_softmax"] += time_ms(
                torch, lambda: torch.softmax(x, dim=-1), 20)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r8 = per8[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": errs.get(name, 0.0),
            "ms": r8["ms"], "plain_ms": r8["plain_ms"],
            "bound_ms": r8["bound_ms"], "bound_by": bound_by(r8["specs"]),
            # no single PyTorch call computes these int8 functions (int32
            # accumulation + requantisation); the f32 yardsticks are in the
            # f32 line above
            "library_ms": None})
    f32_rows = {name: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"],
                       "library_ms": lib.get(name)}
                for name, r in per32.items()}
    log("[time] per flagship forward, int8 (ms): " + json.dumps(
        {r["name"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
         for r in rows}))
    log("[time] per flagship forward, f32 (ms; library = one PyTorch call "
        "per op): " + json.dumps(f32_rows))
    out = ROOT / "build"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kind": kind, "execute_ms": exec_ms,
         "walls_ms": walls, "int8": rows, "f32": f32_rows,
         "build_s": build.LAST_BUILD_S,
         "wall_s": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
