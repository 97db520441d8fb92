"""Dry run: build every (arch × shape) step at full size on PyTorch's meta
device and report its FLOPs, per-device bytes and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all

The counterpart of the reference's ``src/repro/launch/dryrun.py``, which
lowers and compiles each step with XLA on 512 forced host devices and
reads the compiled HLO. The port has no compiler and forces nothing (no
device count, no ``XLA_FLAGS``): it runs the step itself on meta tensors
(shapes and dtypes, no storage, no card) from ``launch/specs.py``:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over the whole
  step: a train step with all its microbatches, forward, recomputation
  (remat), backward and the update; a prefill; one decode step (at the
  cache's last position, so attention covers the whole cache). A train
  step's microbatches share one shape and the counter counts no FLOPs in
  the update or the accumulation, so the counted run is the step on one
  microbatch and the step's FLOPs are its count times the microbatches
  (a meta op costs Python's time, and 256 microbatches of a 36-layer
  model would take an hour). Matrix products are
  counted as the reference's HLO parser counts dots, 2 × |result| ×
  |contraction|. Long causal attention, which on the card runs the flash
  kernel, is counted in the reference's own blockwise form
  (``models/layers.py::_flash_prefill`` takes ``_sdpa_blockwise`` on the
  meta device, the work the reference's HLO
  holds); the WKV runs its plain version.
- **Per-device bytes**: each argument leaf's bytes (the train state and
  batch, or the params, inputs and cache) over the product of the mesh
  axes in its spec; ``bytes`` (the memory term) is that once on every
  device, a floor: the port has no per-op traffic to sum.
- **Collectives**: 0 on one card; on a mesh of more than one device
  ``null``, since without an SPMD compiler the port cannot say what its
  collectives would move (ROADMAP §3).

Each record carries the reference's fields (``compile_s`` is the time of
the counted run), printed as a roofline row (``repro_torch.roofline``, H100
peaks) and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import roofline as RL
from repro_torch import sharding as SH
from repro_torch.configs import arch_names, get_arch, get_shape
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.train import steps as TS

MESHES = {"host": lambda: M.make_host_mesh(),
          "pod": lambda: M.make_production_mesh(),
          "multi-pod": lambda: M.make_production_mesh(multi_pod=True)}


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def batch_axes_for(cfg: ArchConfig, shape: ShapeConfig, mesh) -> tuple:
    """The batch's mesh axes: ``batch_axes``, and for a pure data-parallel
    train step also the model axis where the batch divides (the
    reference's ``_lower_train``)."""
    ba = M.batch_axes(mesh)
    if shape.kind == "train" and SP.parallel_policy(cfg, mesh) == "dp":
        ext = (*ba, "model")
        if shape.global_batch % _axes_size(mesh, ext) == 0:
            return ext
    return ba


def _leaf_bytes(t: torch.Tensor, spec, mesh) -> float:
    shards = 1
    for ax in spec:
        if ax is not None:
            shards *= _axes_size(mesh, ax if isinstance(ax, tuple)
                                 else (ax,))
    return t.numel() * t.element_size() / shards


def _tree_bytes(tree, specs, mesh) -> float:
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k], mesh) for k in tree)
    return _leaf_bytes(tree, specs, mesh)


def argument_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh, ins) -> float:
    """Per-device bytes of the step's arguments under the specs."""
    ba = batch_axes_for(cfg, shape, mesh)
    bax = ba if len(ba) > 1 else ba[0]
    if shape.kind == "train":
        st = SP.state_shardings(cfg, mesh,
                                policy=SP.parallel_policy(cfg, mesh))
        bs = SP.batch_shardings(cfg, shape, mesh, batch_ax=bax)
        return (_tree_bytes(ins["state"], st, mesh)
                + _tree_bytes(ins["batch"], bs, mesh))
    ps = SP.param_shardings(cfg, mesh)
    tok = ins["inputs"] if shape.kind == "prefill" else ins["tokens"]
    tok_spec = SP._fit(mesh, tuple(tok.shape),
                       [bax] + [None] * (tok.dim() - 1))
    n = _tree_bytes(ins["params"], ps, mesh) + _leaf_bytes(tok, tok_spec,
                                                           mesh)
    if shape.kind != "prefill":
        n += _tree_bytes(ins["cache"], SP.cache_shardings(cfg, shape, mesh),
                         mesh)
    return n


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh, ins) -> tuple:
    """(FLOPs of the whole step on the meta inputs ``ins``
    (``specs.input_specs``), record extras)."""
    extra: Dict[str, Any] = {}
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            ba = batch_axes_for(cfg, shape, mesh)
            micro = TS.default_microbatches(
                cfg, shape.global_batch, shape.seq_len,
                _axes_size(mesh, ba))
            extra = {"microbatches": micro,
                     "policy": SP.parallel_policy(cfg, mesh)}
            mb = shape.global_batch // micro
            TS.train_step(cfg, TS.opt_config_for(cfg), ins["state"],
                          {k: v[:mb] for k, v in ins["batch"].items()},
                          remat=True, microbatches=1,
                          accum_dtype=TS.accum_dtype_for(cfg))
        elif shape.kind == "prefill":
            T.prefill(cfg, ins["params"], ins["inputs"],
                      cache_len=shape.seq_len)
        else:
            cl = SP.cache_len_for(cfg, shape)
            window = SP.decode_window(cfg, shape)
            extra = {"window": window, "cache_len": cl}
            T.decode_step(cfg, ins["params"], ins["cache"],
                          ins["tokens"], cl - 1, window=window)
    return float(fc.get_total_flops()) * extra.get("microbatches", 1), extra


def run_one(arch: str, shape_name: str, mesh_name: str = "host"
            ) -> Dict[str, Any]:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    mesh = MESHES[mesh_name]()
    chips = mesh.size
    t0 = time.time()
    with SH.axis_env(mesh, batch=batch_axes_for(cfg, shape, mesh)):
        ins = SP.input_specs(cfg, shape)
        t_lower = time.time() - t0
        t1 = time.time()
        flops, extra = count_step(cfg, shape, mesh, ins)
        compile_s = time.time() - t1
        args = argument_bytes(cfg, shape, mesh, ins)
    coll = {} if chips == 1 else None
    cost = {"flops": flops, "bytes": args * chips, "collectives": coll,
            "per_device_bytes": {"arguments": args}}
    rl = RL.analyse(f"{arch}/{shape_name}/{'x'.join(map(str, mesh.axis_sizes))}",
                    cost, RL.model_flops_for(cfg, shape), chips)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "chips": chips, "lower_s": round(t_lower, 1), **extra,
        "compile_s": round(compile_s, 1),
        "hlo_flops": rl.hlo_flops, "hlo_bytes": rl.hlo_bytes,
        "collective_bytes": rl.coll_bytes,
        "collectives": coll,
        "t_compute_s": rl.t_compute, "t_memory_s": rl.t_memory,
        "t_collective_s": rl.t_collective, "bottleneck": rl.bottleneck,
        "model_flops": rl.model_flops,
        "useful_flops_ratio": rl.useful_flops_ratio,
        "per_device_bytes": {"arguments": args, "outputs": None,
                             "temps": None, "code": None},
        "peak": rl.peak.name,
    }
    print(rl.row(), flush=True)
    print(f"  per-device: args={args / 2**30:.2f}GiB (H100 80GB)",
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=[*MESHES, "all"], default="host",
                    help="host: the visible cards (one); pod: (16, 16); "
                         "multi-pod: (2, 16, 16)")
    ap.add_argument("--out", default="experiments/dryrun_torch_results.jsonl")
    args = ap.parse_args(argv)

    archs = arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ok = fail = 0
    with open(args.out, "a") as f:
        for a in archs:
            for s in shapes:
                for m in meshes:
                    print(f"=== dry-run {a} × {s} × {m}", flush=True)
                    try:
                        rec = run_one(a, s, m)
                        rec["ok"] = True
                        ok += 1
                    except Exception as e:  # record failures: they are bugs
                        traceback.print_exc()
                        rec = {"arch": a, "shape": s, "mesh": m, "ok": False,
                               "error": f"{type(e).__name__}: {e}"}
                        fail += 1
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    print(f"dry-run complete: {ok} ok, {fail} failed")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
