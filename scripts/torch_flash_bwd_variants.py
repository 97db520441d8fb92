#!/usr/bin/env python3
"""Time variants of the f32 flash-attention backward
(``csrc/flash_attention_bwd.cu``'s ``flash_bwd_f32``) against the repo's
build in one call.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_flash_bwd_variants.py [name ...]

Each variant (``VARIANTS``) is a copy of the source with texts replaced
(each found exactly once): a ``#pragma unroll`` changed, the launch
bounds changed, a ``__threadfence()`` put before each release store
(``fence``), or a part of the one pass left out: the S and dP product
(``no_s_dp``), dQ's partial (``no_dq_partial``), dK's or dV's product
(``no_dk``, ``no_dv``), the ordered add's waits and releases
(``no_order``: the adds race) or the whole add (``no_add``: the partial
stored, nothing read, no wait). A left-out part's cost is the repo
build's time less the variant's: the time the card spends on it that
nothing else hides. The copies are built into
``build/flash_bwd_variants/`` (one ``nvcc`` per variant, all started
together). On seeded inputs at ``chip_smoke.py``'s full width (causal
S = T = 4096, 16 heads of 128) and at its f32 reduced training width
(``FLASH_BWD_REDUCED``: 32 heads of 32) it holds each variant's dq, dk,
dv against the repo build's (the largest absolute difference: 0.0 for a
variant that sums in the same order; the others leave work out and are
wrong), then times the repo build and every variant in turns, twice
(repo, variants, repo, variants reversed), each call with CUDA events
(``chip_smoke.time_ms``, 10 calls after a warm-up). It prints one JSON
line: the card's name and power limit, per build and width its two
times, its difference from the repo build and the main pass's ptxas
registers, stack and spills at each W.
"""
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
REPS = 10
#: the one pass's loops and steps by their text
S_DP = "#pragma unroll(W == 32 ? 1 : 2)\n    for (int c = 0; c < d; c += 4) {"
OUTER = ("#pragma unroll(W == 128 ? 4 : 2)\n"
         "      for (int r = 0; r < BQ; ++r) {\n"
         "        float z[GK];\n        float4 y[GF];\n"
         "        load_keys<GK>(z, ")
DV, DK = OUTER + "Ps", OUTER + "dSs"
DQ = "#pragma unroll 2\n    for (int kk = 0; kk < BK; kk += 4) {"
WAIT = "    if (kt > 0) {\n      if (lane == 0)"
READ = "        if (kt > 0 && row < s && col < d)"
RELEASE = "    __syncwarp();\n    if (lane == 0) st_release(counter, kt + 1);"
#: variant -> (text, replacement) pairs
VARIANTS = {
    "s_dp_x2": [(S_DP, S_DP.replace("(W == 32 ? 1 : 2)", " 2"))],
    "outer_x2": [(DK, DK.replace("(W == 128 ? 4 : 2)", " 2")),
                 (DV, DV.replace("(W == 128 ? 4 : 2)", " 2"))],
    "dq_x4": [(DQ, DQ.replace("unroll 2", "unroll 4"))],
    "w32_one_cta": [("W == 32 ? 2 : 1)", "1)")],
    "no_s_dp": [(S_DP, S_DP.replace("c < d", "c < 0"))],
    "no_dq_partial": [(DQ, DQ.replace("kk < BK", "kk < 0"))],
    "no_dk": [(DK, DK.replace("r < BQ", "r < 0"))],
    "no_dv": [(DV, DV.replace("r < BQ", "r < 0"))],
    "fence": [(RELEASE, "    __threadfence();\n" + RELEASE)],
    "no_order": [(WAIT, WAIT.replace("kt > 0", "false")), (RELEASE, "")],
    "no_add": [(WAIT, WAIT.replace("kt > 0", "false")), (RELEASE, ""),
               (READ, READ.replace("kt > 0", "false"))],
}


def patch(src: str, plan) -> str:
    for old, new in plan:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def ptxas(log: str) -> dict:
    """The main pass's registers, stack and spills at each W from nvcc's
    -Xptxas -v."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        fn = part.split("'", 1)[0]
        w = re.search(r"flash_bwd_f32ILi(\d+)E", fn)
        if w:
            regs = re.search(r"Used (\d+) registers", part)
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", part)
            out[w.group(1)] = {
                "registers": int(regs.group(1)) if regs else -1,
                **dict(zip(("stack", "spill_stores", "spill_loads"),
                           (int(g) for g in frame.groups())
                           if frame else (-1, -1, -1)))}
    return out


def build_variants(build, out: pathlib.Path, names) -> tuple:
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "flash_attention_bwd.cu"
        cu.write_text(patch(src, VARIANTS[name]))
        lib = d / "libflash_attention_bwd.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns, res = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        log = log.decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd
        fn.argtypes = build.ARGTYPES_OF["flash_attention_bwd"]
        fn.restype = ctypes.c_int
        fns[name], res[name] = fn, ptxas(log)
    return fns, res


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
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
    from repro_torch.kernels import flash_attention as TF
    build.load()
    fns, res = build_variants(build, ROOT / "build" / "flash_bwd_variants" /
                              build.build_dir().name, names)
    fns["repo"] = build.entry("flash_attention_bwd")
    res["repo"] = ptxas((build.build_dir() / "flash_attention_bwd.ptxas.txt")
                        .read_text(errors="replace"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    rng = np.random.default_rng(24)
    stream = torch.cuda.current_stream().cuda_stream
    widths = {"full": cs.FLASH_FULL, "reduced": cs.FLASH_BWD_REDUCED}
    ms = {w: {name: [] for name in fns} for w in widths}
    diff = {w: {} for w in widths}
    for w, (s, t, h, d) in widths.items():
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (n, h, d), dtype=np.float32)).cuda() for n in (s, t, t, s))
        out, lse = TF._forward(q, k, v, True, 128, 128, True)
        work = torch.empty(TF.bwd_workspace_floats(s, h), device="cuda")
        grads = [torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v)]

        def call(fn):
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           work.data_ptr(), *(g.data_ptr() for g in grads),
                           s, t, h, d, 1, 0, stream), "flash_attention_bwd")
            return grads

        ref = [g.clone() for g in call(fns["repo"])]
        for name in names:
            got = call(fns[name])
            diff[w][name] = max(float((a - c).abs().max().item())
                                for a, c in zip(got, ref))
        for order in (["repo", *names], [*reversed(names), "repo"]):
            for name in order:
                fn = fns[name]
                ms[w][name].append(cs.time_ms(torch, lambda fn=fn: call(fn),
                                              REPS))
        del q, k, v, do, out, lse, work, grads, ref
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "widths": widths, "ms": ms,
                      "max_diff_from_repo": diff, "ptxas_main_pass": res}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
