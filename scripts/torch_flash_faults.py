#!/usr/bin/env python3
"""Hold ``chip_smoke.py``'s bf16 flash attention limit against planted
faults: the unaltered kernel must stay well inside it and each fault must
fall outside it.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_flash_faults.py

It builds copies of ``csrc/flash_attention.cu`` with one fault planted in
the bf16 body each, into ``build/flash_faults/`` (one ``nvcc`` per copy,
all started together; the sound kernel is the repo's own build, called
through its wrapper):

- ``skip_last_tile``: every CTA walks one key tile fewer (when it has two
  or more);
- ``skip_middle_tile``: the middle tile of a walk of more than 8 tiles adds
  nothing;
- ``diagonal_masked``: the causal mask also hides each row's last visible
  key (an off-by-one);
- ``no_rescale``: the accumulator is not rescaled when the running max
  moves.

Then, for every case of ``chip_smoke.FLASH_CASES`` and the full-width call
(causal S = T = 4096, 16 heads of 128), all in bf16 from one seed, it holds
each build's output against ``flash_plain`` and prints one JSON line per
case: for each build the largest |err|, the share of the limit it uses
(the largest |err| / (atol + rtol |want|) over the values, for
``chip_smoke.FLASH_BF16_TOL`` and for the former 5e-2 on both) and
||err|| / ||want||. A share over 1 fails. The last line sums up: the card's
name and power limit, the sound kernel's largest share, and per fault the
cases it passes. It exits 1 when the sound kernel fails the limit or a
fault passes every case.
"""
import ctypes
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (fault, text of the bf16 body, its replacement); each text occurs once
FAULTS = [
    ("skip_last_tile",
     "const int ntiles = (key_end(q0, BQ16, s, t, causal) + BK - 1) / BK;",
     "const int ntiles = max(1, (key_end(q0, BQ16, s, t, causal) + BK - 1) "
     "/ BK - 1);"),
    ("skip_middle_tile",
     "float x = sc[n][e] * sl2;",
     "float x = ntiles > 8 && j == ntiles / 2 ? -INFINITY "
     ": sc[n][e] * sl2;"),
    ("diagonal_masked",
     "else if (causal && key > row0 + (e >> 1) * 8 + offset)",
     "else if (causal && key >= row0 + (e >> 1) * 8 + offset)"),
    ("no_rescale",
     "      acc[n][0] *= corr0;\n      acc[n][1] *= corr0;\n"
     "      acc[n][2] *= corr1;\n      acc[n][3] *= corr1;\n",
     ""),
]
OLD_TOL = (5e-2, 5e-2)


def build_faults(build, out: pathlib.Path) -> dict:
    """One library per fault, compiled in parallel; name -> ctypes entry."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, old, new in FAULTS:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: its text occurs {src.count(old)} "
                               f"times in flash_attention.cu, not once")
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "flash_attention.cu"
        cu.write_text(src.replace(old, new))
        lib = d / "libflash_attention.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n"
                               + log.decode(errors="replace"))
        fn = ctypes.CDLL(str(lib)).flash_attention
        fn.argtypes = build.ARGTYPES_OF["flash_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
    from repro_torch.kernels import flash_attention as TF
    build.load()
    fns = build_faults(build, ROOT / "build" / "flash_faults" /
                       build.build_dir().name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    rng = np.random.default_rng(22)

    def normal(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda()

    def measure(got, want):
        g, w = got.float(), want.float()
        err = (g - w).abs()
        return {"max_abs_err": err.max().item(),
                "limit_share": (err / (cs.FLASH_BF16_TOL[0] +
                                       cs.FLASH_BF16_TOL[1] * w.abs())
                                ).max().item(),
                "old_limit_share": (err / (OLD_TOL[0] + OLD_TOL[1] * w.abs())
                                    ).max().item(),
                "rel_norm": (err.norm() / w.norm()).item()}

    cases = list(cs.FLASH_CASES) + [(*cs.FLASH_FULL, True, 1.0)]
    sound_share, passed = 0.0, {name: [] for name, _, _ in FAULTS}
    for s, t, h, d, causal, scale in cases:
        q = (normal(s, h, d) * scale).bfloat16()
        k, v = normal(t, h, d).bfloat16(), normal(t, h, d).bfloat16()
        want = TF.flash_plain(q, k, v, causal, 128, 128)
        row = {"case": [s, t, h, d, causal, scale],
               "sound": measure(TF.flash_attention_kernel(q, k, v, causal),
                                want)}
        sound_share = max(sound_share, row["sound"]["limit_share"])
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in fns.items():
            out = torch.empty_like(q)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), s, t, h, d, int(causal), 1,
                           stream), name)
            torch.cuda.synchronize()
            row[name] = measure(out, want)
            if row[name]["limit_share"] <= 1.0:
                passed[name].append(row["case"])
        print(json.dumps(row), flush=True)
    summary = {"card": smi, "limit": list(cs.FLASH_BF16_TOL),
               "sound_limit_share": sound_share, "cases": len(cases),
               "faults_pass_in": passed}
    print(json.dumps(summary), flush=True)
    bad = sound_share > 1.0 or any(len(p) == len(cases)
                                   for p in passed.values())
    return 1 if bad else 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
