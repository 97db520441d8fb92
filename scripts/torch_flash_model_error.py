#!/usr/bin/env python3
"""How far a full-width model's bf16 flash call is from exact attention.

Usage, on a machine with an NVIDIA card, from the root of a checkout::

    python3 scripts/torch_flash_model_error.py [arch ...]

For each arch (default: every arch whose prefill takes the flash kernel
in ``chip_smoke.py``, qwen2.5-3b and the archs phase's), one layer at full
width on bf16 weights drawn from a seed, a prefill of 4 x 4096 prompts
(token ids, or embeddings for a frontend stub) with layer 0's
``ops.flash_attention`` call recorded (``chip_smoke.KernelCalls``). It
holds that call's output, and SDPA's on the same q, k, v, against
``flash_plain`` (largest difference, and its share of
``chip_smoke.FLASH_BF16_TOL`` and of ``chip_smoke.flash_bf16_tol``), and
on the head of the worst element against exact attention in float64 on
the same bf16 inputs (the kernel's, ``flash_plain``'s and SDPA's largest
and mean error), beside the rms of q and v.

It prints one JSON line per arch and, last, the card's name and power
limit; it writes nothing else.
"""
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "yi-6b", "nemotron-4-15b", "olmoe-1b-7b",
         "qwen3-moe-235b-a22b", "internvl2-1b", "musicgen-medium")


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    for arch in argv or ARCHS:
        cfg = dataclasses.replace(get_arch(arch), num_layers=1)
        params = T.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(331))
        rng = np.random.default_rng(331)
        if cfg.frontend != "none":
            prompt = rng.standard_normal((4, 4096, cfg.d_model))
            prompt = torch.as_tensor(prompt.astype(np.float32)).cuda()
        else:
            prompt = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (4, 4096)).astype(np.int32)).cuda()
        with torch.inference_mode(), cs.KernelCalls(torch) as calls:
            T.prefill(cfg, params, prompt, 4104)
        (q, k, v), _, got = calls.first["flash_attention"]
        with torch.inference_mode():
            plain = TF.flash_plain(q, k, v, True, 128, 128).float()
            qh, kh, vh = (a.permute(1, 0, 2)[None].contiguous()
                          for a in (q, k, v))
            sdpa = F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)[0].permute(1, 0, 2)

            def share(t, tol):
                atol, rtol = tol
                return ((t.float() - plain).abs()
                        / (atol + rtol * plain.abs())).max().item()
            d = (got.float() - plain).abs()
            worst = np.unravel_index(int(
                (d / (cs.FLASH_BF16_TOL[0] + cs.FLASH_BF16_TOL[1]
                      * plain.abs())).argmax()), tuple(got.shape))
            h = int(worst[1])
            qf, kf, vf = (a[:, h].double() for a in (q, k, v))
            sc = (qf @ kf.T) / (q.shape[-1] ** 0.5)
            sc = sc.masked_fill(torch.ones_like(sc, dtype=torch.bool)
                                .triu(1), float("-inf"))
            exact = torch.softmax(sc, -1) @ vf

            def vs_exact(t):
                e = (t[:, h].double() - exact).abs()
                return {"max": e.max().item(), "mean": e.mean().item()}
            rec = {
                "arch": arch, "bh_s_d": [q.shape[1], q.shape[0],
                                         q.shape[2]],
                "rms_q": q.float().pow(2).mean().sqrt().item(),
                "rms_v": v.float().pow(2).mean().sqrt().item(),
                "kernel_vs_plain_max": d.max().item(),
                "sdpa_vs_plain_max": (sdpa.float() - plain).abs().max()
                .item(),
                "kernel_share_of_FLASH_BF16_TOL": share(
                    got, cs.FLASH_BF16_TOL),
                "sdpa_share_of_FLASH_BF16_TOL": share(
                    sdpa, cs.FLASH_BF16_TOL),
                "kernel_share_of_flash_bf16_tol": share(
                    got, cs.flash_bf16_tol(v)),
                "worst": [int(i) for i in worst],
                "vs_exact_on_worst_head": {
                    "kernel": vs_exact(got), "plain": vs_exact(plain),
                    "sdpa": vs_exact(sdpa)}}
        print(json.dumps(rec), flush=True)
        del params, calls, q, k, v, got, plain, sdpa, qh, kh, vh, exact
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
