#!/usr/bin/env python3
"""Time the port's grid kernels and their neighbours (``arena_conv``,
``arena_pool``, ``arena_elementwise``, ``arena_concat``, ``arena_mean``,
``arena_fully_connected``, the fused chain and the streaming program's
``arena_stream_roll`` and ``arena_stream_stage``) on the card for one
source tree, to compare two commits inside one call.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_ab_row_kernels.py <root of the tree to time> \
        [--against <root of the other tree>]

It builds that tree's kernels (into its own ``build/repro_torch/``),
compiles ``resnet_50_v2`` f32 (``zoo.resnet50_v2(224, 4)``),
``densenet_121`` f32 (``zoo.densenet121(224, 4)``) and the flagship
``mobilenet_v1_0.25_128_8bit`` and prints one JSON line: the device ms of
each kernel per forward, summed over its launches (CUDA events,
``chip_smoke.kernel_times``), on the flat, the row-blocked and the
streaming program of ``resnet_50_v2`` (with the flat program's
``F.conv2d``/``F.max_pool2d``/``torch.relu``/``torch.add``/``torch.mean``/
``torch.matmul`` yardstick, TF32 off, under ``library``),
``arena_elementwise``, ``arena_pool``, ``arena_mean`` and
``arena_fully_connected`` on the flat and blocked ``resnet_50_v2`` int8
forwards and ``arena_stream_roll`` and ``arena_stream_stage`` on the
streaming one, ``arena_concat`` and ``arena_mean`` on the flat and blocked
``densenet_121`` and ``arena_stream_stage`` (its 58 concats, mean, FC and
softmax) on the streaming one (``torch.cat`` under ``library``), and on
the flagship ``arena_conv``, ``arena_mean``, ``arena_fully_connected``
and ``arena_fused_chain`` (flat and row-blocked), ``arena_stream_roll``,
``arena_stream_stage`` (its mean, fully connected and softmax) and
``arena_stream_fused``; then the fused chains alone (``arena_fused_chain``
and ``arena_stream_fused``) on the flagship f32 and at batch 2 on all
three programs, ``mobilenet_v1_1.0_224_8bit`` flat and
``mobilenet_v2_1.0_224`` blocked and streaming; under ``sha256`` a digest
of each program's final device arena after one forward of ``resnet_50_v2``
f32 and int8, ``densenet_121``, the flagship and each of those chains'
graphs on seeded inputs, so two trees' outputs can be compared byte for
byte; and under ``workspace`` the device bytes beside the arena that each
program's ``arena_elementwise``, ``arena_concat``, ``arena_mean``,
``arena_fully_connected`` and ``arena_stream_stage`` specs hold (the sum
of ``arena_ops.buffer_plan(spec).gbytes``, a count from the specs).

Each final arena is also saved under ``<root>/build/ab_arenas/``. With
``--against``, the f32 ones are held against the other tree's saved
arenas of the same name (those its own run left): under ``f32_diff`` the
largest absolute difference and whether every element is within 1e-4 +
1e-4 * |other| (the f32 results of two trees may differ by summation
order where a kernel's order changed; the int8 digests must be equal).

Run it on the two trees in turns (parent, change, change, parent) within
one call: times from two calls may come from two cards.
"""
import argparse
import hashlib
import importlib.util
import json
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.core import exec as X
    from repro_torch.core import zoo
    from repro_torch.core.pipeline import compile
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    cp = compile(zoo.resnet50_v2(224, 4), backend="numpy")
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "sha256": {}, "workspace": {}, "f32_diff": {}}
    saved = root / "build" / "ab_arenas"
    saved.mkdir(parents=True, exist_ok=True)
    other = (pathlib.Path(args.against).resolve() / "build" / "ab_arenas"
             if args.against else None)

    def digest(label, ex, c, inputs, weights, quant, f32):
        out["sha256"][label] = _digest(cs, K, ex, c, inputs, weights, quant,
                                       saved, other, label,
                                       out["f32_diff"] if f32 else None)
    for program, kw in (("flat", {"layout": "flat"}),
                        ("blocks", {"layout": "blocks"}),
                        ("streaming", {"mode": "streaming"})):
        ex = X.get_backend("cuda", **kw)
        per = cs.kernel_times(torch, F, K, ex, cp, plain_too=False,
                              library=program == "flat",
                              only={"arena_conv", "arena_pool",
                                    "arena_elementwise", "arena_mean",
                                    "arena_fully_connected",
                                    "arena_stream_roll",
                                    "arena_stream_stage"})
        out[program] = {k: v["ms"] for k, v in per.items()}
        if program == "flat":
            out["library"] = {k: v["library_ms"] for k, v in per.items()}
        digest(f"resnet_50_v2 {program}", ex, cp,
               X.random_inputs(cp.graph, 0), X.synth_weights(cp.graph, 0),
               None, True)
        out["workspace"][f"resnet_50_v2 {program}"] = _workspace(K, ex, cp)
    c8 = compile(zoo.resnet50_v2(224, 1), backend="numpy")
    w8 = X.synth_weights(c8.graph, 0)
    q8 = X.calibrate(c8.graph, 0, w8)
    heads = {"arena_elementwise", "arena_pool", "arena_mean",
             "arena_fully_connected"}
    for program, kw, only in (
            ("flat", {"layout": "flat"}, heads),
            ("blocks", {"layout": "blocks"}, heads),
            ("streaming", {"mode": "streaming"},
             {"arena_stream_roll", "arena_stream_stage"})):
        ex = X.get_backend("cuda", **kw)
        per = cs.kernel_times(torch, F, K, ex, c8, w8, q8, plain_too=False,
                              only=only)
        out[f"resnet_50_v2 int8 {program}"] = {k: v["ms"]
                                               for k, v in per.items()}
        digest(f"resnet_50_v2 int8 {program}", ex, c8,
               X.quant_inputs(c8.graph, q8, 0), w8, q8, False)
        out["workspace"][f"resnet_50_v2 int8 {program}"] = _workspace(
            K, ex, c8)
    dn = compile(zoo.densenet121(224, 4), backend="numpy")
    for program, kw in (("flat", {"layout": "flat"}),
                        ("blocks", {"layout": "blocks"}),
                        ("streaming", {"mode": "streaming"})):
        ex = X.get_backend("cuda", **kw)
        per = cs.kernel_times(torch, F, K, ex, dn, plain_too=False,
                              library=program == "flat",
                              only={"arena_concat", "arena_mean",
                                    "arena_stream_stage"})
        out[f"densenet_121 {program}"] = {k: v["ms"] for k, v in per.items()}
        if program == "flat":
            out["densenet_121 library"] = {k: v["library_ms"]
                                           for k, v in per.items()}
        digest(f"densenet_121 {program}", ex, dn,
               X.random_inputs(dn.graph, 0), X.synth_weights(dn.graph, 0),
               None, True)
        out["workspace"][f"densenet_121 {program}"] = _workspace(K, ex, dn)
    flag = compile(zoo.mobilenet_v1(0.25, 128, 1), backend="numpy")
    w = X.synth_weights(flag.graph, 0)
    q = X.calibrate(flag.graph, 0, w)
    for program, kw in (("flat", {"layout": "flat"}),
                        ("blocks", {"layout": "blocks"}),
                        ("streaming", {"mode": "streaming"})):
        ex = X.get_backend("cuda", **kw)
        per = cs.kernel_times(torch, F, K, ex, flag, w, q, plain_too=False,
                              only={"arena_conv", "arena_fused_chain",
                                    "arena_mean", "arena_fully_connected",
                                    "arena_stream_roll", "arena_stream_stage",
                                    "arena_stream_fused"})
        out[f"flagship {program}"] = {k: v["ms"] for k, v in per.items()}
        digest(f"flagship {program}", ex, flag,
               X.quant_inputs(flag.graph, q, 0), w, q, False)
    # the fused chains alone on the other graphs that have one
    table3 = zoo.TABLE3_MODELS
    for label, graph, batch, programs in (
            ("flagship f32", zoo.mobilenet_v1(0.25, 128, 4), 1,
             ("flat", "blocks", "streaming")),
            ("flagship batch 2", zoo.mobilenet_v1(0.25, 128, 1), 2,
             ("flat", "blocks", "streaming")),
            ("mobilenet_v1_1.0_224_8bit",
             table3["mobilenet_v1_1.0_224_8bit"][0](), 1, ("flat",)),
            ("mobilenet_v2_1.0_224", table3["mobilenet_v2_1.0_224"][0](), 1,
             ("blocks", "streaming"))):
        c = compile(graph, backend="numpy", batch=batch)
        w = X.synth_weights(c.graph, 0)
        q = X.calibrate(c.graph, 0, w) if X.needs_quant(c.graph) else None
        inputs = (X.quant_inputs(c.graph, q, 0) if q is not None
                  else X.random_inputs(c.graph, 0))
        for program in programs:
            ex = X.get_backend("cuda", **dict(
                flat={"layout": "flat"}, blocks={"layout": "blocks"},
                streaming={"mode": "streaming"})[program])
            per = cs.kernel_times(torch, F, K, ex, c, w, q, plain_too=False,
                                  only={"arena_fused_chain",
                                        "arena_stream_fused"})
            out[f"{label} {program}"] = {k: v["ms"] for k, v in per.items()}
            digest(f"{label} {program}", ex, c, inputs, w, q, q is None)
    print(json.dumps(out), flush=True)
    return 0


def _workspace(K, ex, cp) -> dict:
    """Global workspace bytes of the program's elementwise, concat, mean,
    fully connected and staged specs, by kernel."""
    names = ("arena_elementwise", "arena_concat", "arena_mean",
             "arena_fully_connected", "arena_stream_stage")
    specs = ex.program(cp)[0]
    return {n: sum(K.buffer_plan(s).gbytes for s in specs
                   if K.kernel_of(s) == n) for n in names}


def _digest(cs, K, ex, cp, inputs, weights, quant, saved, other, label,
            diffs) -> str:
    """sha256 of the program's final device arena after one forward; the
    arena's bytes saved as ``saved/<label>.bin``; given ``diffs`` (f32),
    the largest difference from ``other/<label>.bin`` where that exists."""
    import numpy as np
    import torch
    arena = cs.run_arena(K, ex, cp, inputs, weights, quant)
    data = arena.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    name = label.replace(" ", "_") + ".bin"
    (saved / name).write_bytes(data)
    if diffs is not None and other is not None and (other / name).exists():
        got = np.frombuffer(data, np.float32)
        ref = np.frombuffer((other / name).read_bytes(), np.float32)
        err = np.abs(got - ref)
        diffs[label] = {"max_abs": float(err.max()),
                        "within_1e-4": bool((err <= 1e-4 + 1e-4
                                             * np.abs(ref)).all())}
    return hashlib.sha256(data).hexdigest()[:16]


if __name__ == "__main__":
    sys.exit(main())
