"""Serving launcher: batched greedy generation with the KV cache updated in
place, on random weights drawn from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --batch 4 --prompt-len 4096 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --reduced --device cpu --batch 4 --prompt-len 64 --max-new 32

Without ``--device`` it runs on the card and raises without one;
``--device cpu`` runs the kernels' plain versions. ``--ckpt`` loads the
params of a training checkpoint (``launch/train.py --ckpt-dir``, or the
reference's of the same arch) in place of the random weights.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_arch
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    if args.ckpt:
        # the optimiser's state stays on the meta device, unread
        meta = T.tree_map(lambda t: t.to("meta"), params)
        params = store.restore(args.ckpt, {"params": params,
                                           "opt": adamw.init(meta)},
                               device=dev)["params"]

    scfg = ServeConfig(cache_len=args.prompt_len + args.max_new,
                       window=args.window, max_new_tokens=args.max_new)
    eng = Engine(cfg, params, scfg, dev)

    rng = np.random.default_rng(args.seed)
    if cfg.frontend != "none":
        prompts = rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    else:
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}")
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s incl. prefill and "
          f"the kernels' first build)")
    for i, row in enumerate(out[:4]):
        print(f"  seq{i}: {row.tolist()}")
    return out


if __name__ == "__main__":
    main()
