#!/usr/bin/env python3
"""Time ``arena_conv`` spec by spec on the card: where a forward's conv
time goes.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_conv_specs.py [--graph resnet_50_v2|flagship]
        [--layout flat|blocks]

It builds the kernels, compiles the graph (``zoo.resnet50_v2(224, 4)`` or
the flagship ``mobilenet_v1(0.25, 128, 1)``), walks its program on the
card and, for every conv spec, prints one JSON line: its shapes, kernel
size and stride, order mode (0 disjoint, 1 staged waits, 2 rows one after
another), tiling (threads across channels, pixels a thread, tiles a row,
tiles, footprint bytes), the kernel's device ms (CUDA events,
``chip_smoke.time_auto``), the bound (``chip_smoke.bound_ms``) and, f32
only, one ``F.conv2d`` call at the same shapes (TF32 off). A last line
sums them.
"""
import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="resnet_50_v2",
                    choices=("resnet_50_v2", "flagship"))
    ap.add_argument("--layout", default="flat", choices=("flat", "blocks"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.core import exec as X
    from repro_torch.core import zoo
    from repro_torch.core.pipeline import compile
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build
    build.load()
    graph = (zoo.resnet50_v2(224, 4) if args.graph == "resnet_50_v2"
             else zoo.mobilenet_v1(0.25, 128, 1))
    cp = compile(graph, backend="numpy")
    weights = X.synth_weights(cp.graph, 0)
    quant = X.calibrate(cp.graph, 0, weights) \
        if X.needs_quant(cp.graph) else None
    ex = X.get_backend("cuda", layout=args.layout)
    specs, ws, descs, state = ex.program(cp, None, weights, quant=quant)
    total = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "launches": 0}
    for sp, w, d in zip(specs, ws, descs):
        if K.kernel_of(sp) == "arena_conv":
            a = state.clone()
            ms = cs.time_auto(torch, lambda: K.apply_op(a, sp, w, d))
            lib = None
            if sp.dtype == "f32":
                call = cs.library_call(torch, F, sp)
                lib = None if call is None else cs.time_auto(torch, call)
            tl = K.conv_tiling(sp)
            row = {"kind": sp.kind, "in": sp.in_shape[0], "out": sp.out_shape,
                   "k": sp.meta[0], "stride": sp.meta[2],
                   "order": K.conv_order(sp), "nog": tl.nog, "vp": tl.vp,
                   "tpr": tl.tpr, "tiles": tl.ntiles, "footprint": tl.fp,
                   "ms": ms, "bound_ms": cs.bound_ms(sp), "library_ms": lib}
            print(json.dumps(row), flush=True)
            total["ms"] += ms
            total["bound_ms"] += row["bound_ms"]
            total["launches"] += 1
            if total["library_ms"] is not None:
                total["library_ms"] = None if lib is None \
                    else total["library_ms"] + lib
        K.apply_op(state, sp, w, d)
    torch.cuda.synchronize()
    print(json.dumps({"graph": args.graph, "layout": args.layout,
                      "card": torch.cuda.get_device_name(0), **total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
