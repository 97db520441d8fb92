#!/usr/bin/env python3
"""Time the port's standalone kernels (``flash_attention`` f32 and bf16
and its backward ``flash_attention_bwd``, ``wkv_chunk`` and its backward
``wkv_chunk_bwd``, with ``rmsnorm_inplace`` as a neighbour) and SDPA on
the card for one source tree, to compare two commits inside one call.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_ab_standalone.py <root of the tree to time> \\
        [--against <root of the other tree>] [--train] \\
        [--arch qwen2.5-3b|rwkv6-1.6b] [--grad-check]

It builds that tree's kernels (into its own ``build/repro_torch/``), makes
the full-width inputs of ``chip_smoke.py``'s standalone phase from a seed
(flash attention causal S = T = 4096, 16 heads of 128, f32 and bf16;
RMSNorm x 4096 x 2048, f32 and bf16; WKV B 1, S 4096, 32 heads of 64,
q 64) and prints one JSON line: the card's name and power limit, the
device ms of one call of each kernel through its wrapper (CUDA events
around 20 calls after a warm-up, ``chip_smoke.time_ms``), and of
``F.scaled_dot_product_attention`` on the same inputs in (1, H, S, D)
copies made outside the timed call (``library``). The flash backward
goes through ``flash_attention_bwd.flash_backward_kernel`` on the forward
kernel's own output and lse (f32 and bf16, the same shapes, a seeded
output gradient), and in f32 at the train launcher's ``--reduced``
qwen2.5-3b width (causal S = T = 4096, 32 heads of 32: ``f32 reduced``),
beside SDPA's backward (``chip_smoke.sdpa_backward_ms``: a timed
``torch.autograd.grad`` minus its forward). The WKV backward goes
through ``wkv_chunk.wkv_backward_kernel`` on the forward kernel's own
workspace at ``chip_smoke.WKV_FULL`` (a seeded output gradient and final
state gradient); no PyTorch call computes it. ``launch_ms`` gives each
backward's launches' device ms a call (the flash backward's two: bf16
``bwd_dq_wg`` and ``bwd_dkv_wg``, f32 the pre-pass ``flash_bwd_f32_pre``
and the one pass ``flash_bwd_f32``; the WKV backward's ``grad_parts``, ``grad_scan``, ``chunk_grads`` and
``du_sum``), from ``torch.profiler`` kernel events over ten calls ("not
measured" where the trace holds no device time), and ``ptxas`` the two
backwards' registers, stack and spills (``build.ptxas_resources``).
With ``--train`` it then runs ``chip_smoke.train_steps`` for ``--arch``
(qwen2.5-3b, the default, or rwkv6-1.6b; bf16 at full width, 2 x 4096
tokens in 2 microbatches, remat, three steps) and adds each step's
device ms and its kernels' ms a step under ``train`` (the flash forward
and backward for qwen, the WKV forward and backward for rwkv). With
``--grad-check`` it times ``chip_smoke.py``'s f32 gradient check's loss
(qwen2.5-3b, ``TRAIN_CHECK``: 2 layers at full width in float32, 4096
tokens, remat) and its gradient twice under ``chip_smoke.KernelCalls``
and adds the flash forward's and backward's device ms of the second
under ``grad_check``.

Each kernel's output of one call on the seeded inputs is saved under
``<root>/build/ab_standalone/`` (WKV's y and state apart, and its
backward's five gradients). With
``--against``, each output is held against the other tree's saved output
of the same name: under ``diff`` the largest absolute difference (a kernel
whose summation order changed differs from the other tree's in its last
bits; one that did not change gives 0.0).

Run it on the two trees in turns (parent, change, change, parent) within
one call: times from two calls may come from two cards.
"""
import argparse
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

REPS = 20
#: each backward's launches in a profiler trace, by kernel name
LAUNCH_NAMES = {"flash_attention_bwd": r"(bwd_dq_wg<\d+>|bwd_dkv_wg<\d+>|"
                                       r"flash_bwd_f32_pre|flash_bwd_f32<\d+>|"
                                       r"flash_bwd_dq<\d+>|flash_bwd_dkv<\d+>)",
                "wkv_chunk_bwd": r"(grad_parts|grad_scan|chunk_grads|du_sum)"}
#: the kernels timed within a train step, by architecture
TRAIN_KERNELS = {"qwen2.5-3b": ("flash_attention", "flash_attention_bwd"),
                 "rwkv6-1.6b": ("wkv_chunk", "wkv_chunk_bwd")}


#: the f32 backward at the train launcher's --reduced qwen2.5-3b width,
#: (S, T, B·H, D)
REDUCED = (4096, 4096, 32, 32)


def grad_check_ms(torch, cs) -> dict:
    """Device ms of the flash forward and backward calls within
    ``chip_smoke.grad_check``'s loss and gradient (qwen2.5-3b, 2 float32
    layers at full width, ``TRAIN_CHECK`` tokens, remat, seed 30), the
    second of two runs, by ``chip_smoke.KernelCalls``."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           shard_batch)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    layers, tokens = cs.TRAIN_CHECK
    cfg = get_arch(cs.TRAIN_ARCH)
    cfg2 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = T.init_params(cfg2, torch.Generator(device="cuda")
                           .manual_seed(30))
    batch = shard_batch(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, tokens, 1, seed=30)).packed_batches()), "cuda")
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    rec = {}
    for _ in range(2):
        with cs.KernelCalls(torch, timed=True) as calls:
            loss, _ = TS.loss_fn(cfg2, params, batch, remat=True)
            torch.autograd.grad(loss, leaves)
        rec = {name: {"ms": calls.device_ms(name),
                      "calls": calls.calls(name)}
               for name in ("flash_attention", "flash_attention_bwd")}
    del params, leaves, batch
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--against", default=None)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--arch", default="qwen2.5-3b", choices=TRAIN_KERNELS)
    ap.add_argument("--grad-check", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import inplace_rmsnorm as TR
    from repro_torch.kernels import wkv_chunk as TW
    build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    rng = np.random.default_rng(22)

    def normal(*shape, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    types = {"f32": torch.float32, "bf16": torch.bfloat16}
    fs, ft, fh, fd = 4096, 4096, 16, 128
    n, d = 4096, 2048
    wb, ws, wh, wd, wq = cs.WKV_FULL
    calls, library = {}, {}
    for dt, ty in types.items():
        q, k, v = (normal(m, fh, fd, dtype=ty) for m in (fs, ft, ft))
        fl = (lambda q=q, k=k, v=v: TF.flash_attention_kernel(q, k, v, True))
        calls[f"flash_attention {dt}"] = (fl, fl)
        qh, kh, vh = (a.permute(1, 0, 2)[None].contiguous()
                      for a in (q, k, v))
        library[f"sdpa {dt}"] = (
            lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
        x, g, r = normal(n, d, dtype=ty), normal(d, dtype=ty), \
            normal(n, d, dtype=ty)
        gf, xa = g.float(), x.clone()
        # in place: timed over one copy of x (g cast once, as chip_smoke.py
        # times it), the output from a fresh copy
        calls[f"rmsnorm_inplace {dt}"] = (
            lambda xa=xa, gf=gf, r=r: TR.rmsnorm_scale_residual_inplace(
                xa, gf, r),
            lambda x=x, gf=gf, r=r: TR.rmsnorm_scale_residual_inplace(
                x.clone(), gf, r))
    backward, bwd_inputs = {}, {}
    for dt, ty in types.items():
        q, k, v, do = (normal(m, fh, fd, dtype=ty) for m in (fs, ft, ft, fs))
        out, lse = TF._forward(q, k, v, True, 128, 128, True)
        bwd_inputs[dt] = (q, k, v, do)
        backward[f"flash_attention_bwd {dt}"] = (
            lambda q=q, k=k, v=v, out=out, do=do, lse=lse:
            TF.flash_backward_kernel(q, k, v, out, do, lse, True))
    rs_, rt_, rh_, rd_ = REDUCED
    q, k, v, do = (normal(m, rh_, rd_) for m in (rs_, rt_, rt_, rs_))
    out, lse = TF._forward(q, k, v, True, 128, 128, True)
    bwd_inputs["f32 reduced"] = (q, k, v, do)
    backward["flash_attention_bwd f32 reduced"] = (
        lambda q=q, k=k, v=v, out=out, do=do, lse=lse:
        TF.flash_backward_kernel(q, k, v, out, do, lse, True))
    rr, kk, vv, z = (normal(wb, ws, wh, wd) for _ in range(4))
    logw = -torch.exp(z * 0.5)
    u = normal(wh, wd) * 0.1
    wkv = (lambda: TW.wkv_chunk_kernel(rr, kk, vv, logw, u, q=wq))
    calls["wkv_chunk f32"] = (wkv, wkv)
    wdy, wds = normal(wb, ws, wh, wd), normal(wb, wh, wd, wd)
    _, _, wws = TW.wkv_forward_saved(rr, kk, vv, logw, u, wq)
    backward["wkv_chunk_bwd f32"] = (
        lambda: TW.wkv_backward_kernel(rr, kk, vv, logw, u, wdy, wds, wq,
                                       wws))
    torch.cuda.synchronize()

    saved = root / "build" / "ab_standalone"
    saved.mkdir(parents=True, exist_ok=True)
    other = (pathlib.Path(args.against).resolve() / "build" / "ab_standalone"
             if args.against else None)
    out = {"root": str(root), "card": smi, "ms": {}, "library": {},
           "launch_ms": {}, "diff": {},
           "ptxas": {n: build.ptxas_resources(n) for n in LAUNCH_NAMES}}
    calls.update({name: (fn, fn) for name, fn in backward.items()})
    for name, (timed, once) in calls.items():
        got = once()
        torch.cuda.synchronize()
        names = (("dr", "dk", "dv", "dlogw", "du") if "wkv_chunk_bwd" in name
                 else ("dq", "dk", "dv") if "bwd" in name
                 else ("y", "state"))
        parts = ({f"{name} {part}": a for part, a in zip(names, got)}
                 if isinstance(got, tuple) else {name: got})
        for part, a in parts.items():
            a = a.float().reshape(-1)
            path = saved / (part.replace(" ", "_") + ".pt")
            torch.save(a.cpu(), path)
            theirs = other / path.name if other is not None else None
            if theirs is not None and theirs.exists():
                ref = torch.load(theirs).to(a.device)
                out["diff"][part] = float((a - ref).abs().max().item())
        out["ms"][name] = cs.time_ms(torch, timed, REPS)
    for name, fn in library.items():
        out["library"][name] = cs.time_ms(torch, fn, REPS)
    for dt, (q, k, v, do) in bwd_inputs.items():
        out["library"][f"sdpa_bwd {dt}"] = cs.sdpa_backward_ms(
            torch, F, q, k, v, do)["library_ms"]
    from torch.profiler import ProfilerActivity, profile
    for name, fn in backward.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        pat = re.compile(LAUNCH_NAMES[name.split()[0]])
        out["launch_ms"][name] = {
            pat.search(ev.key).group(1): (
                getattr(ev, "device_time_total", 0.0) / 1e3 / 10
                or "not measured")
            for ev in prof.key_averages() if pat.search(ev.key)}
    if args.grad_check:
        out["grad_check"] = grad_check_ms(torch, cs)
    if args.train:
        del calls, backward, bwd_inputs, library, wws
        torch.cuda.empty_cache()
        from repro_torch.configs import get_arch
        cfg = get_arch(args.arch)
        mbs = 2   # chip_smoke.train_steps checks default_microbatches
        zero = {"flash_attention": 0, "flash_attention_bwd": 0,
                "wkv_chunk": 0, "wkv_chunk_bwd": 0}
        if args.arch == "qwen2.5-3b":   # remat: two forwards a layer
            want = {**zero,
                    "flash_attention": 2 * cfg.num_layers * mbs,
                    "flash_attention_bwd":
                        TF.BWD_KERNELS_PER_CALL * cfg.num_layers * mbs}
        else:
            want = {**zero,
                    "wkv_chunk": 2 * TW.KERNELS_PER_CALL * cfg.num_layers
                    * mbs,
                    "wkv_chunk_bwd": TW.BWD_KERNELS_PER_CALL
                    * cfg.num_layers * mbs}
        rec, _ = cs.train_steps(torch, args.arch, 29, want,
                                TRAIN_KERNELS[args.arch])
        out["train"] = {"arch": args.arch}
        out["train"].update({key: rec[key] for key in (
            "step_ms", "step_ms_median", "tokens_s", "kernel_ms_in_step",
            "kernel_calls_a_step", "update_ms")})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
