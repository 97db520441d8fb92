"""Training launcher: synthetic-corpus batches, AdamW, checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 200 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 20 --batch 2 --seq 64 --log-every 5

Without ``--device`` it runs on the card and raises without one;
``--device cpu`` runs the kernels' plain versions. The weights are drawn
from ``--seed``; the state is updated in place every step and saved every
``--ckpt-every`` steps into ``--ckpt-dir`` (the reference's npz format,
which ``launch/serve.py --ckpt`` restores). The flags are the
reference's, with ``--device`` added; as the reference's launcher, it
trains without remat.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       embedding_batches, shard_batch)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim.adamw import OptConfig, tree_leaves
from repro_torch.train import steps as TS


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the 2-layer smoke variant (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, name=cfg.name.replace("-smoke", ""))
    opt = OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps)

    dc = DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    if cfg.frontend != "none":
        batches = embedding_batches(dc, cfg.d_model, seed=args.seed)
    else:
        batches = SyntheticCorpus(dc).packed_batches()

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = TS.init_state(cfg, gen, opt, dev)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} device={dev} params={n_params:,} "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    step_fn = TS.make_train_step(cfg, opt, remat=False,
                                 microbatches=args.microbatches)
    log = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = shard_batch(next(batches), dev)
        state, m = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: float(v) for k, v in m.items()}
            dt = time.perf_counter() - t0
            tok_s = (i + 1) * args.batch * args.seq / max(dt, 1e-9)
            log.append({"step": i, **row, "tok_s": tok_s})
            print(f"step {i:5d} loss={row['loss']:8.4f} "
                  f"ce={row['ce']:8.4f} gnorm={row['grad_norm']:7.3f} "
                  f"lr={row['lr']:.2e} tok/s={tok_s:,.0f}", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            p = store.save(args.ckpt_dir, state, step=i + 1)
            print(f"checkpoint -> {p}", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f}s")
    return log


if __name__ == "__main__":
    main()
