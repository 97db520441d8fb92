#!/usr/bin/env python3
"""Time variants of the WKV backward (``csrc/wkv_chunk_bwd.cu``) against
the repo's build in one call.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_wkv_bwd_variants.py [name ...]

Each variant (``VARIANTS``) is a copy of the source with ``#pragma
unroll N`` put before some of C''s loops (the loops by their text, each
found at least once) or with texts replaced (each found exactly once)
to leave work out: one of C''s five steps (``no_step_*``: 1 the factors,
2 att, 3 dv and datt, 4 d^r and d^k, 5 dlogw and du; ``no_steps``: all
five, leaving the loads, the scan and the barriers), one half of a
step's warps (``idle_*``) or one part of d^r and d^k (``no_pairs``,
``no_state_products``, ``no_below``). A left-out part's cost is the
repo build's C' less the variant's: the time the card spends on it that
nothing else hides. The copies are built into ``build/wkv_bwd_variants/``
(one ``nvcc`` per variant, all started together). On the
rwkv6-1.6b-width inputs of ``chip_smoke.py`` (``WKV_FULL``, seeded) it
holds each variant's five gradients against the repo build's (the
largest absolute difference: 0.0 for an unrolled loop, which sums in the
same order; the others leave work out and are wrong), then times the
repo build and every variant in turns, twice (repo, variants, repo,
variants reversed), each call with CUDA events (``chip_smoke.time_ms``,
20 calls after a warm-up) and its ``chunk_grads`` by ``torch.profiler``
over ten calls. It prints one JSON line: the card's name and power limit,
per build its two call and C' times, its difference from the repo build
and its ptxas registers, stack and spills.
"""
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPS = 20
#: C''s loops by their text (stripped)
PRODUCTS = ("for (int cc = 4 * hf; cc < dp; cc += 8) {",
            "for (int c = 4 * g; c < dp; c += 4 * nl) {",
            "for (int i = 0; i < dp; i += 4) {",
            "for (int e = 0; e < dp; e += 4) {")
STEPS = ("for (int t = j0; t < qp; ++t) {",
         "for (int j = 0; j < a * SUB; j += 4) {",
         "for (int t = a2 * SUB; t < (a2 + 1) * SUB; ++t) {")
PAIRS = ("for (int j = a * SUB; j < x0 + 3; ++j) {",
         "for (int t = x0 + 1; t < tend; ++t) {")
#: C''s steps left out, by the texts that start their work
STEP_OFF = {
    "factors": [("    if (c < dp) {\n      const float lc = last[c];",
                 "    if (false) {\n      const float lc = last[c];")],
    "att": [("const bool on = it < 8 * na * (na - 1);",
             "const bool on = false;"),
            ("const bool live = it < (on_diag ? 4 : 6) * na;",
             "const bool live = false;"),
            ("    if (c < dp) {\n      float x = 0.f;",
             "    if (false) {\n      float x = 0.f;")],
    "dv_datt": [("if (j0 < qp && e0 < dp) {", "if (false) {"),
                ("jb = ln & 15;\n    if (t0 < qp) {",
                 "jb = ln & 15;\n    if (false) {")],
    "dr_dk": [("if (tid < NT && x0 < qp) {", "if (false) {"),
              ("} else if (tid >= NT && x0 < qp) {", "} else if (false) {")],
    "dlogw": [("    if (c < dp) {\n      float du = 0.f;",
               "    if (false) {\n      float du = 0.f;"),
              ("    if (c < dp) {\n      float off = X[c];",
               "    if (false) {\n      float off = X[c];")],
}
#: variant -> (loops, unroll factor) or (text, replacement) pairs
VARIANTS = {
    "products_x2": [(PRODUCTS, 2)],
    "steps_x4": [(STEPS, 4)],
    "pairs_x4": [(PAIRS, 4)],
    "pairs_x2_steps_x2": [(PAIRS, 2), (STEPS, 2)],
    "all_x2": [(PRODUCTS, 2), (STEPS, 2), (PAIRS, 2)],
    **{f"no_step_{name}": plan for name, plan in STEP_OFF.items()},
    "no_steps": [pair for plan in STEP_OFF.values() for pair in plan],
    # one half of a step idle
    "idle_att_below": STEP_OFF["att"][:1],
    "idle_att_pairs": STEP_OFF["att"][1:2],
    "idle_dv": STEP_OFF["dv_datt"][:1],
    "idle_datt": STEP_OFF["dv_datt"][1:],
    "idle_dr": STEP_OFF["dr_dk"][:1],
    "idle_dk": STEP_OFF["dr_dk"][1:],
    # one part of d^r and d^k left out
    "no_pairs": [("for (int j = a * SUB; j < x0 + 3; ++j) {",
                  "for (int j = a * SUB; j < 0; ++j) {"),
                 ("for (int t = x0 + 1; t < tend; ++t) {",
                  "for (int t = tend; t < tend; ++t) {")],
    "no_state_products": [
        ("for (int e = 0; e < dp; e += 4) {\n        float4 yv[4], sv[4];",
         "for (int e = 0; e < 0; e += 4) {\n        float4 yv[4], sv[4];"),
        ("for (int e = 0; e < dp; e += 4) {\n        float4 vv[4], gv[4];",
         "for (int e = 0; e < 0; e += 4) {\n        float4 vv[4], gv[4];")],
    "no_below": [("for (int j = 0; j < a * SUB; j += 4) {",
                  "for (int j = 0; j < 0; j += 4) {"),
                 ("for (int a2 = a + 1; a2 < na; ++a2) {",
                  "for (int a2 = a + 1; a2 < 0; ++a2) {")],
}
#: the variants run when none is named: each step and part left out
DEFAULT = [*(f"no_step_{name}" for name in STEP_OFF), "no_steps",
           "no_pairs", "no_state_products", "no_below"]


def patch(src: str, plan) -> str:
    for old, new in plan:
        if isinstance(old, str):
            if src.count(old) != 1:
                raise RuntimeError(f"{old!r} occurs {src.count(old)} times")
            src = src.replace(old, new)
    out = []
    found = {}
    for ln in src.split("\n"):
        for loops, n in plan:
            if not isinstance(loops, str) and ln.strip() in loops:
                found[ln.strip()] = found.get(ln.strip(), 0) + 1
                out.append(f"#pragma unroll {n}")
        out.append(ln)
    missing = [lp for loops, _ in plan if not isinstance(loops, str)
               for lp in loops if lp not in found]
    if missing:
        raise RuntimeError(f"loops not in the source: {missing}")
    return "\n".join(out)


def ptxas(log: str) -> dict:
    """chunk_grads' registers, stack and spills from nvcc's -Xptxas -v."""
    for part in log.split("Compiling entry function '")[1:]:
        if "chunk_grads" in part.split("'", 1)[0]:
            regs = re.search(r"Used (\d+) registers", part)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", part)
            return {"registers": int(regs.group(1)) if regs else -1,
                    **dict(zip(("stack", "spill_stores", "spill_loads"),
                               (int(g) for g in frame.groups())
                               if frame else (-1, -1, -1)))}
    return {}


def build_variants(build, out: pathlib.Path, names) -> tuple:
    src = (build.CSRC / "wkv_chunk_bwd.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "wkv_chunk_bwd.cu"
        cu.write_text(patch(src, VARIANTS[name]))
        lib = d / "libwkv_chunk_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns, res = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).wkv_chunk_bwd
        fn.argtypes = build.ARGTYPES_OF["wkv_chunk_bwd"]
        fn.restype = ctypes.c_int
        fns[name], res[name] = fn, ptxas(log)
    return fns, res


def main() -> int:
    names = sys.argv[1:] or DEFAULT
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
    fns, res = build_variants(build, ROOT / "build" / "wkv_bwd_variants" /
                              build.build_dir().name, names)
    fns["repo"] = build.entry("wkv_chunk_bwd")
    res["repo"] = next(v for k, v in build.ptxas_resources(
        "wkv_chunk_bwd").items() if "chunk_grads" in k)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    b, s, h, d, q = cs.WKV_FULL
    rng = np.random.default_rng(23)

    def normal(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda()
    r, k, v, z, dy = (normal(b, s, h, d) for _ in range(5))
    logw = -torch.exp(z * 0.5)
    u = normal(h, d) * 0.1
    dst = normal(b, h, d, d)
    _, _, ws = TW.wkv_forward_saved(r, k, v, logw, u, q)
    gws = torch.empty_like(ws)
    outs = [torch.empty_like(r) for _ in range(4)]
    du = torch.empty((h, d), device=r.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u.data_ptr(), dy.data_ptr(),
                       dst.data_ptr(), ws.data_ptr(), gws.data_ptr(),
                       *(t.data_ptr() for t in outs), du.data_ptr(), b, s,
                       h, d, q, stream), "wkv_chunk_bwd")
        return (*outs, du)

    ref = [t.clone() for t in call(fns["repo"])]
    diff = {}
    for name in names:
        got = call(fns[name])
        diff[name] = max(float((a - c).abs().max().item())
                         for a, c in zip(got, ref))
    from torch.profiler import ProfilerActivity, profile
    ms = {name: [] for name in fns}
    c_ms = {name: [] for name in fns}
    for order in (["repo", *names], [*reversed(names), "repo"]):
        for name in order:
            fn = fns[name]
            ms[name].append(cs.time_ms(torch, lambda fn=fn: call(fn), REPS))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call(fn)
                torch.cuda.synchronize()
            c_ms[name].append(next(
                (getattr(ev, "device_time_total", 0.0) / 1e3 / 10
                 or "not measured") for ev in prof.key_averages()
                if "chunk_grads" in ev.key))
    print(json.dumps({"card": smi, "shape": cs.WKV_FULL, "ms": ms,
                      "chunk_grads_ms": c_ms, "max_diff_from_repo": diff,
                      "ptxas_chunk_grads": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
