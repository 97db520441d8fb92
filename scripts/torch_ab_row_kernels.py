#!/usr/bin/env python3
"""Time the port's grid kernels and their neighbours (``arena_conv``,
``arena_pool``, ``arena_elementwise``, ``arena_concat``, ``arena_mean``,
``arena_fully_connected``, ``arena_softmax``, ``arena_matmul``,
``arena_pad``, the fused chain and the streaming program's
``arena_stream_roll`` and
``arena_stream_stage``) on the card for one source tree, to compare two
commits inside one call.

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
``torch.matmul``/``torch.softmax`` yardstick, TF32 off, under
``library``), ``arena_elementwise``, ``arena_pool``, ``arena_mean`` and
``arena_fully_connected`` on the flat and blocked ``resnet_50_v2`` int8
forwards and ``arena_stream_roll`` and ``arena_stream_stage`` on the
streaming one, ``arena_concat`` and ``arena_mean`` on the flat and blocked
``densenet_121`` and ``arena_stream_stage`` (its 58 concats, mean, FC and
softmax) on the streaming one (``torch.cat`` under ``library``), and on
the flagship ``arena_conv``, ``arena_mean``, ``arena_fully_connected``
and ``arena_fused_chain`` (flat and row-blocked), ``arena_stream_roll``,
``arena_stream_stage`` (its mean, fully connected and softmax) and
``arena_stream_fused``; the flagship's softmaxes alone at batch 1, 2 and 8
(flat and staged); the softmax, matmul and pad of ``allops`` and
``stream_allops`` (f32 and int8) on all three programs; the hand-built
softmaxes (1,024 rows x 1,000, in place and shifted five elements over the
next row), matmuls ((1024, 1024, 1024), the output apart and over a) and
pads ((112, 112, 64) -> (114, 114, 64), the output apart and over the
input), f32 and int8, and the chip script's streaming pad (its TPU window
819,200 B), one launch each on a seeded arena, under ``hand_built``;
the launch floor (an empty kernel through the same launcher, one CTA and
full grids) where the tree has it; then the fused chains alone
(``arena_fused_chain`` and ``arena_stream_fused``) on the flagship f32 and
at batch 2 on all three programs, ``mobilenet_v1_1.0_224_8bit`` flat and
``mobilenet_v2_1.0_224`` blocked and streaming; under ``sha256`` a digest
of each program's final device arena after one forward of ``resnet_50_v2``
f32 and int8, ``densenet_121``, the flagship (also at batch 8),
``allops``, ``stream_allops`` and each of those chains' graphs on seeded
inputs, and of each hand-built spec's arena after its launch, so two
trees' outputs can be compared byte for byte; and under ``workspace`` the
device bytes beside the arena that each program's ``arena_elementwise``,
``arena_concat``, ``arena_mean``, ``arena_fully_connected`` and
``arena_stream_stage`` specs hold (the sum of
``arena_ops.buffer_plan(spec).gbytes``, a count from the specs).

Each final arena is also saved under ``<root>/build/ab_arenas/``. With
``--against``, each is held against the other tree's saved arena of the
same name (those its own run left): under ``f32_diff`` the largest
absolute difference and whether every element is within 1e-4 + 1e-4 *
|other| (the f32 results of two trees may differ by summation order where
a kernel's order changed), under ``i8_diff`` the largest difference of an
int8 arena in steps (0 unless an int8 softmax's sum order changed: at most
1).

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
           "sha256": {}, "workspace": {}, "f32_diff": {}, "i8_diff": {}}
    saved = root / "build" / "ab_arenas"
    saved.mkdir(parents=True, exist_ok=True)
    other = (pathlib.Path(args.against).resolve() / "build" / "ab_arenas"
             if args.against else None)

    def digest(label, ex, c, inputs, weights, quant, f32):
        arena = cs.run_arena(K, ex, c, inputs, weights, quant)
        out["sha256"][label] = _save(arena, saved, other, label,
                                     "f32" if f32 else "i8", out["f32_diff"],
                                     out["i8_diff"])
    for program, kw in (("flat", {"layout": "flat"}),
                        ("blocks", {"layout": "blocks"}),
                        ("streaming", {"mode": "streaming"})):
        ex = X.get_backend("cuda", **kw)
        per = cs.kernel_times(torch, F, K, ex, cp, plain_too=False,
                              library=program == "flat",
                              only={"arena_conv", "arena_pool",
                                    "arena_elementwise", "arena_mean",
                                    "arena_fully_connected",
                                    "arena_softmax", "arena_stream_roll",
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
    # softmax at batch 1, 2 and 8 (one a sample), and the staged one alone
    for batch in (1, 2, 8):
        c = compile(zoo.mobilenet_v1(0.25, 128, 1), backend="numpy",
                    batch=batch)
        w = X.synth_weights(c.graph, 0)
        q = X.calibrate(c.graph, 0, w)
        for program, kw in (("flat", {"layout": "flat"}),
                            ("streaming", {"mode": "streaming"})):
            ex = X.get_backend("cuda", **kw)
            per = cs.kernel_times(torch, F, K, ex, c, w, q, plain_too=False,
                                  only={"arena_softmax",
                                        "arena_stream_stage"},
                                  kinds={"softmax"})
            out[f"flagship batch {batch} softmax {program}"] = {
                k: v["ms"] for k, v in per.items()}
            if batch == 8:
                digest(f"flagship batch 8 {program}", ex, c,
                       X.quant_inputs(c.graph, q, 0), w, q, False)
    # allops (the zoo's only matmul) and stream_allops on every program
    for label, graph in (("allops", cs.allops_graph(4)),
                         ("allops int8", cs.allops_graph(1)),
                         ("stream_allops", cs.stream_allops_graph(4)),
                         ("stream_allops int8", cs.stream_allops_graph(1))):
        c = compile(graph, backend="numpy")
        w = X.synth_weights(c.graph, 0)
        q = X.calibrate(c.graph, 0, w) if X.needs_quant(c.graph) else None
        inputs = (X.quant_inputs(c.graph, q, 0) if q is not None
                  else X.random_inputs(c.graph, 0))
        for program, kw in (("flat", {"layout": "flat"}),
                            ("blocks", {"layout": "blocks"}),
                            ("streaming", {"mode": "streaming"})):
            ex = X.get_backend("cuda", **kw)
            per = cs.kernel_times(torch, F, K, ex, c, w, q, plain_too=False,
                                  only={"arena_softmax", "arena_matmul",
                                        "arena_pad", "arena_stream_stage"},
                                  kinds={"softmax", "matmul", "pad"})
            out[f"{label} {program}"] = {k: v["ms"] for k, v in per.items()}
            digest(f"{label} {program}", ex, c, inputs, w, q, q is None)
    # the hand-built shapes where the work shows, one launch each on a
    # seeded arena (digests of the arena after it), and the launch floor
    out["hand_built"] = {}
    for label, spec, nbytes in _hand_built(K) + [
            ("streaming pad", *cs.stream_pad_spec())]:
        state = cs.seeded_state(torch, spec, nbytes, 0) \
            if hasattr(cs, "seeded_state") else _seeded(torch, spec, nbytes)
        a = state.clone()
        ms = cs.time_auto(torch, lambda: K.apply_op(a, spec))
        a = state.clone()
        K.apply_op(a, spec)
        torch.cuda.synchronize()
        out["hand_built"][label] = ms
        out["sha256"][label] = _save(a, saved, other, label, spec.dtype,
                                     out["f32_diff"], out["i8_diff"])
    if "launch_floor" in getattr(build, "EXTRA_ENTRIES", {}):
        out["launch_floor"] = cs.launch_floor_ms(torch, build)
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


def _save(arena, saved, other, label, dtype, f32_diffs, i8_diffs) -> str:
    """sha256 of a final device arena; its bytes saved as
    ``saved/<label>.bin``; where ``other/<label>.bin`` exists, the largest
    difference from it: f32 (with whether every element is within 1e-4 +
    1e-4 * |other|) or int8 (in steps of the int8 grid)."""
    import numpy as np
    import torch
    data = arena.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    name = label.replace(" ", "_").replace("^", "") + ".bin"
    (saved / name).write_bytes(data)
    if other is not None and (other / name).exists():
        ref_b = (other / name).read_bytes()
        if dtype == "f32":
            got = np.frombuffer(data, np.float32)
            ref = np.frombuffer(ref_b, np.float32)
            err = np.abs(got - ref)
            f32_diffs[label] = {"max_abs": float(err.max()),
                                "within_1e-4": bool((err <= 1e-4 + 1e-4
                                                     * np.abs(ref)).all())}
        else:
            got = np.frombuffer(data, np.int8).astype(np.int32)
            ref = np.frombuffer(ref_b, np.int8).astype(np.int32)
            i8_diffs[label] = int(np.abs(got - ref).max())
    return hashlib.sha256(data).hexdigest()[:16]


def _hand_built(K):
    """(label, spec, arena bytes) of the hand-built softmax, matmul and pad
    specs, built here from the tree's ``OpSpec`` (an older tree's chip
    script has no makers for them): 1,024 rows x 1,000 classes in place
    and with the output five elements on, (1024, 1024, 1024) with the
    output apart and over a, (112, 112, 64) -> (114, 114, 64) with the
    output after the input and from its first byte; f32 and int8."""
    out = []
    for dt in ("f32", "i8"):
        isz = 1 if dt == "i8" else 4
        q = dt == "i8"
        n = 1024 * 1000
        for place, off in (("aligned", 0), ("shifted", 5)):
            spec = K.OpSpec(kind="softmax", in_off=(0,),
                            in_shape=((1024, 1000),), out_off=off * isz,
                            out_shape=(1024, 1000), dtype=dt,
                            qmeta=((0.05, 3), (1 / 256, -128)) if q else ())
            out.append((f"softmax 1024 x 1000 {dt} {place}", spec,
                        -(-(n + off) * isz // 16) * 16))
        m = k = n3 = 1024
        b_off = m * k * isz
        for place, o in (("disjoint", b_off + k * n3 * isz), ("over_a", 0)):
            spec = K.OpSpec(kind="matmul", in_off=(0, b_off),
                            in_shape=((m, k), (k, n3)), out_off=o,
                            out_shape=(m, n3), dtype=dt,
                            qmeta=(3, -2, 0.0002, 1) if q else ())
            out.append((f"matmul 1024^3 {dt} {place}", spec,
                        max(b_off + k * n3 * isz, o + m * n3 * isz)))
        n_in, n_out = 112 * 112 * 64 * isz, 114 * 114 * 64 * isz
        for place, o in (("apart", n_in), ("over", 0)):
            spec = K.OpSpec(kind="pad", in_off=(0,),
                            in_shape=((112, 112, 64),), out_off=o,
                            out_shape=(114, 114, 64), dtype=dt,
                            meta=(((1, 1), (1, 1), (0, 0)),),
                            qmeta=((-3, 0.9), (4,)) if q else ())
            out.append((f"pad 112 x 112 x 64 {dt} {place}", spec,
                        o + n_out))
    return out


def _seeded(torch, spec, nbytes):
    """The chip script's ``seeded_state`` for a flat spec (f32 normal, a
    matmul's b over sqrt(k); int8 uniform bytes), for a tree whose chip
    script predates it."""
    g = torch.Generator(device="cpu").manual_seed(0)
    if spec.dtype != "f32":
        return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                             generator=g).cuda()
    x = torch.randn(-(-nbytes // 4), generator=g)
    if spec.kind == "matmul":
        b0, k = spec.in_off[1] // 4, spec.in_shape[0][-1]
        x[b0:b0 + k * spec.in_shape[1][1]] /= k ** 0.5
    return x.view(torch.uint8)[:nbytes].cuda()


if __name__ == "__main__":
    sys.exit(main())
