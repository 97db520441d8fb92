#!/usr/bin/env python3
"""Time the softmax and matmul grids at the zoo's small shapes for one
source tree, and (``--variants``) beside variants of the same kernels, to
see what holds a launch-bound op above the one-CTA kernels it replaced.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_softmax_matmul_variants.py <root> [--variants]

It builds that tree's kernels and prints one JSON line: the device ms of
one launch (CUDA events over 20 launches, ``chip_smoke.time_ms``: more
would let the host's enqueueing outrun the sleep they queue behind) through
the tree's own wrappers of a softmax over 1 x 1,000 f32 and int8 (the
zoo's heads, in place), 16 x 2 f32 (``allops``'), 1 x 12 f32
(``stream_allops``') and 1,024 x 1,000 f32 (rows on warps), and of
``allops``' matmul ((16, 8) x (8, 2), f32 and int8). With
``--variants`` (a tree with ``csrc/softmax_tiles.cuh``) it also times,
through the tree's built libraries or copies of its sources built under
``<root>/build/variants/``:

- ``warp_rows``: the few-row softmaxes on warps (the tiling's warp
  policy forced, the same binary);
- ``no_warp_code``: the softmax kernel built without its warp-row code
  (a CTA row's launch with a smaller binary);
- ``matmul_unroll_2``: the matmul built with two rows of b in flight
  instead of four.

Run it on the two trees in turns (parent, change, change, parent) within
one call: times from two calls may come from two cards.
"""
import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys

#: launches a time averages: few enough that the host enqueues them all
#: while the device still sleeps (``chip_smoke.time_ms``)
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build
    build.load()
    specs = _specs(K)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "wrappers": {}}
    for label, (sp, nbytes) in specs.items():
        a = _arena(torch, nbytes)
        out["wrappers"][label] = cs.time_ms(
            torch, lambda: K.apply_op(a, sp), REPS)
    if args.variants:
        out.update(_variants(torch, cs, K, build, root, specs))
    print(json.dumps(out), flush=True)
    return 0


def _specs(K):
    """label -> (spec, arena bytes): the softmaxes in place at byte 0, the
    matmul's operands and output apart."""
    out = {}
    for label, dt, rows, last in (("softmax 1x1000 f32", "f32", 1, 1000),
                                  ("softmax 1x1000 i8", "i8", 1, 1000),
                                  ("softmax 16x2 f32", "f32", 16, 2),
                                  ("softmax 1x12 f32", "f32", 1, 12),
                                  ("softmax 1024x1000 f32", "f32", 1024,
                                   1000)):
        isz = 1 if dt == "i8" else 4
        out[label] = (K.OpSpec(
            kind="softmax", in_off=(0,), in_shape=((rows, last),),
            out_off=0, out_shape=(rows, last), dtype=dt,
            qmeta=((0.05, 3), (1 / 256, -128)) if dt == "i8" else ()),
            rows * last * isz)
    for dt in ("f32", "i8"):
        isz = 1 if dt == "i8" else 4
        b = 16 * 8 * isz
        o = -(-(b + 8 * 2 * isz) // 16) * 16
        out[f"matmul 16x8x2 {dt}"] = (K.OpSpec(
            kind="matmul", in_off=(0, b), in_shape=((16, 8), (8, 2)),
            out_off=o, out_shape=(16, 2), dtype=dt,
            qmeta=(3, -2, 0.0002, 1) if dt == "i8" else ()), o + 32 * isz)
    return out


def _arena(torch, nbytes: int):
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 120, (-(-nbytes // 16) * 16 + 64,),
                         dtype=torch.uint8, generator=g).cuda()


def _variants(torch, cs, K, build, root, specs) -> dict:
    out = {}
    # the few-row softmaxes on warps, through the built library
    plain_tiling = K.softmax_tiling.__wrapped__

    def warp_tiling(spec):
        _, last = K._softmax_geometry(spec)
        if last > 32 * K.SM_WARP_VALS:
            return plain_tiling(spec)
        vec = 16 // K._isz(spec.dtype)
        return K.SoftmaxTiling(K.SM_WARP, vec, -(-last // (32 * vec)))
    K.softmax_tiling = warp_tiling
    K.buffer_plan.cache_clear()
    fn = build.entry("arena_softmax")
    out["warp_rows"] = _time_entry(torch, cs, K, build, fn, specs,
                                   "softmax", True)
    K.softmax_tiling = plain_tiling
    K.buffer_plan.cache_clear()
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    for name, source, kind, edits in (
            ("no_warp_code", "arena_softmax.cu", "softmax",
             [("softmax_tiles.cuh", "if (t.mode == SM_WARP) {",
               "if (false) {")]),
            ("matmul_unroll_2", "arena_matmul.cu", "matmul",
             [("fc_tiles.cuh", "#pragma unroll 4\n  for (int k = k0; k < k1;",
               "#pragma unroll 2\n  for (int k = k0; k < k1;")])):
        fn, regs = _build(build, root, csrc, name, source, edits)
        # without its warp code the kernel runs every row on a CTA
        out[name] = _time_entry(torch, cs, K, build, fn, specs, kind,
                                name != "no_warp_code")
        out[name]["registers"] = regs
    return out


def _build(build, root, csrc, name, source, edits):
    """Build ``source`` from a copy of the sources with ``edits`` (file,
    old text, new text) applied, under ``<root>/build/variants/<name>``;
    returns its ctypes entry and the registers ``-Xptxas -v`` reports."""
    d = root / "build" / "variants" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    for fname, old, new in edits:
        p = d / fname
        text = p.read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} has no {old!r}")
        p.write_text(text.replace(old, new))
    so = d / f"lib{name}.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(d / source)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, source[:-3])
    fn.argtypes = build.GRID_ARGTYPES[source[:-3]]
    fn.restype = ctypes.c_int
    return fn, [int(x) for x in re.findall(r"Used (\d+) registers",
                                           r.stdout + r.stderr)]


def _time_entry(torch, cs, K, build, fn, specs, kind, warp_ok) -> dict:
    """Device ms of one launch of entry ``fn`` on each spec of ``kind``
    (without ``warp_ok``, none whose tiling puts rows on warps), with the
    descriptor, workspace and grid the tree's wrapper would give it."""
    out = {}
    for label, (spec, nbytes) in specs.items():
        if spec.kind != kind or not warp_ok and \
                K.softmax_tiling(spec).mode == K.SM_WARP:
            continue
        a = _arena(torch, nbytes)
        desc = torch.from_numpy(K.descriptor_words(spec)).cuda()
        ws = K.workspace(spec, "cuda")
        grid = K.softmax_grid(spec) if kind == "softmax" else K.fc_grid(spec)
        smem = K.buffer_plan(spec).smem

        def call():
            build.check(fn(a.data_ptr(), desc.data_ptr(), None,
                           None if ws is None else ws.data_ptr(), smem,
                           *grid, torch.cuda.current_stream().cuda_stream),
                        label)
        out[label] = cs.time_ms(torch, call, REPS)
    return out


if __name__ == "__main__":
    sys.exit(main())
