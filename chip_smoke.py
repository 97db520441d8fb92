#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) and prints the build time and the
   ``-Xptxas -v`` register and shared-memory report;
3. holds every kernel against its plain PyTorch version on the card, on
   copies of the arena as the program reaches each spec, comparing the
   whole arena (int8 bit-exact except softmax and sigmoid <= 1 LSB, f32
   within 1e-4 + 1e-4 * |ref|):
   every spec of the flagship (int8, f32 and int8 at batch 2) and of
   ``mobilenet_v1_1.0_224_8bit``; every pool, elementwise, concat,
   mean, matmul, pad and fully connected spec and every row op wider than
   8,192
   outputs of ``resnet_50_v2`` (f32 and int8), ``densenet_121`` and the
   reference's test graph ``allops`` (f32 and int8); a hand-built fused
   chain with pool and elementwise stages (f32 and int8), and its variant
   whose terminal concat reads the chain input it overwrites (the staged
   last level); a hand-built chain whose conv footprint takes per-CTA
   global slices; a hand-built
   conv whose output row exceeds a CTA's shared memory (cut into column
   tiles), and one whose input footprint exceeds the conv's shared memory
   budget (staged in per-CTA slices of the global workspace); hand-built
   softmaxes over 1,024 rows x 1,000 (f32 and int8; in place, order word
   1, and shifted five elements over the next row, order word 2), over one
   row of 65,536 (a CTA row staged in the workspace), matmuls (1024,
   1024, 1024) with the output apart (order word 0) and over a (order word
   2) and pads (112, 112, 64) -> (114, 114, 64) (ResNet50's stem pad, f32
   and int8) with the output apart (order word 0) and over the input
   (order word 2). For every fused chain it prints the schedule
   (``[chain]`` lines: levels, stages and tiles per level, the grid and
   its CTAs an SM, the workspace bytes beside the one-CTA kernel's scratch
   bytes) and checks that each runs on more than one CTA; for every
   hand-built softmax, matmul and pad a ``[softmax]``, ``[matmul]`` or
   ``[pad]`` line (order word, tiling, grid, CTAs an SM, workspace and
   shared bytes), and checks that each runs on more than one CTA where its
   rows allow;
4. runs the flagship slice: ``compile(mobilenet_v1(0.25, 128, 1),
   backend="cuda")`` (verified ``numeric+cuda``, winner ``fuse``, 49,805 B)
   and three requests through ``CompiledPlan.execute``, each matching the
   numpy backend and counting 29 launches, with the launch counts reset
   just before; then the f32 flagship, the flagship at batch 2 and
   ``mobilenet_v1_1.0_224_8bit``;
5. runs ``resnet_50_v2`` at full width, f32
   (``zoo.resnet50_v2(224, 4)``) and int8: ``compile(..., backend="cuda")``
   and three requests each, matching the numpy backend, 90 launches each,
   the device arena exactly ``plan.peak_bytes`` (7,225,344 B in f32);
   then repeats the ``resnet_50_v2`` f32 and flagship int8 forwards five
   times each on the same inputs, on the flat and on the streaming
   program: the final device arenas must be identical, byte for byte
   (``arena_conv``, ``arena_pool``, ``arena_stream_roll``,
   ``arena_elementwise``, ``arena_concat``, ``arena_mean``,
   ``arena_fully_connected`` and the staged elementwise, concat, mean and
   FC bodies of ``arena_stream_stage`` run over the whole card with tiles,
   chunks or slices that wait on each other; a race would show here), and
   the ``densenet_121`` forward (its 58 concats) three times on each;
   prints each tile kernel's order modes, tiles and the device bytes its
   counters take, each elementwise and staged spec's order word, grid and
   workspace bytes, and each pool, fully connected, concat and mean spec's
   order word, grid, tiles or units and workspace and shared bytes, on the
   flat, blocked and streaming ``resnet_50_v2`` f32 and int8 and
   ``densenet_121``;
6. runs every row of ``zoo.TABLE3_MODELS`` at full width once on the card
   against the numpy backend, and ``allops`` (f32 and int8); prints each
   row's winner, arena, launches and seconds. ``nasnet_mobile``'s graph
   adds a (28, 28, 22) tensor to a (56, 56, 22) one, which no backend of
   either package executes: the script checks that the port and the numpy
   backend both refuse it;
7. runs the row-blocked program (``get_backend("cuda", layout="blocks")``)
   on the flagship (int8, f32, batch 2), ``resnet_50_v2`` (f32, int8),
   ``densenet_121``, ``mobilenet_v2_1.0_224`` (the fused chain's global
   scratch) and ``allops`` (f32, int8): every spec's kernel against its
   plain blocked version, one request each with the launch counts reset
   just before, outputs bit-equal to the flat route's on the same inputs
   and within tolerance of the numpy backend, the typed device arena
   ``total_rows x arena_rowlen`` elements (73,728, 327,680, 1,835,008 and
   7,340,032 B for the flagship int8 and f32 and ``resnet_50_v2`` int8 and
   f32); and hand-built blocked fused chains with pool and elementwise
   stages (packed and spanning rows, f32 and int8, with and without the
   staged last level);
8. runs the streaming program (``get_backend("cuda", mode="streaming")``)
   on the flagship (int8, f32, batch 2), ``resnet_50_v2`` (f32, int8),
   ``densenet_121``, ``mobilenet_v2_1.0_224`` and ``allops`` (f32, int8):
   every streaming
   spec's kernel (``arena_stream_roll``, ``arena_stream_stage``,
   ``arena_stream_fused``) against its plain streaming version, one
   request each through ``execute()`` with the launch counts reset just
   before (29 on the flagship, 90 on ``resnet_50_v2``, 247 on
   ``densenet_121``), outputs bit-equal to the blocked route's and within
   tolerance of the numpy backend, the final device arena bit-equal to the
   blocked route's on the same inputs; prints each graph's largest
   resident window, whether the card stages it in shared or global memory
   (a rolling op: its row tiles' footprints; a fused chain and every
   staged body run in place), and the bytes each streaming form stages, in
   the TPU program and in the card's kernels (counts from the specs), and
   checks that no staged spec of any graph takes a window (the card stages
   0 B for the staged form); then a hand-built streaming pad whose TPU
   window (819,200 B) exceeds a CTA's shared memory runs in place against
   its plain version;
9. runs the standalone DMO depthwise conv ``kernels.ops.dmo_dwconv2d`` on
   the card on the reference's ``DWCONV_CASES`` and two real layers
   ((64, 64, 8) of the flagship, (112, 112, 32) of
   ``mobilenet_v1_1.0_224``), counting its launches, each against its
   plain version and against ``F.conv2d`` (depthwise, TF32 off);
10. runs the three standalone kernels through their entry points
   (``kernels.ops.rmsnorm_residual``, ``kernels.ops.flash_attention``,
   ``kernels.wkv_chunk.wkv_chunk_kernel``): each kernel against its plain
   version and its oracle (``kernels/ref.py``; the sequential recurrence
   for WKV) at the reference's test shapes (attention also at D = 96 and
   a ragged D = 40, a decode step over 4096 keys and q x 8; WKV also at a
   ragged D = 40 with q = 24, a single chunk and strong decays, its
   outputs finite, and no stack frame or spills in any of its three
   kernels in the ``-Xptxas -v`` report), then once
   each at full width
   with the launch counts reset just before (RMSNorm at 4096 tokens x
   2048, the qwen2.5-3b width, f32 and bf16, its result x's own storage
   and the call's rise in peak memory under x's bytes; causal attention at
   S = T = 4096, 16 heads of 128, f32 and bf16; WKV at B = 1, S = 4096, 32
   heads of 64, the rwkv6-1.6b width, three launches a call), against its
   plain version, timed
   with CUDA events beside its plain version, its bound and one PyTorch
   call (``F.rms_norm`` then ``torch.add``;
   ``F.scaled_dot_product_attention``; none for WKV); then the flash
   backward (``csrc/flash_attention_bwd.cu``, two launches a call; no
   stack frame or spills in its bf16 body's wgmma kernels or its f32
   body's pre-pass and one pass) at the same full width in f32 and bf16,
   and in f32 at the reduced training width (32 heads of 32):
   ``ops.flash_attention`` under autograd once per case with the counts
   reset just before, each call's dq, dk,
   dv against ``flash_backward_plain`` on the forward's own output and
   lse (``FLASH_BWD_TOL``), a second call bit-equal, timed beside its
   plain version, its bound (the backward's five products) and SDPA's
   backward (a timed ``torch.autograd.grad`` minus its forward); then
   the WKV backward (``csrc/wkv_chunk_bwd.cu``, four launches a call):
   no stack frame or spills in its four kernels, each launch's CTAs an
   SM by the card's occupancy calculator (C' at least 16 warps), on
   ``WKV_CASES``, strong decays, unaligned inputs and ``WKV_BWD_SUB``
   (three sub-chunks, the last ragged) against ``wkv_backward_plain``
   (``WKV_BWD_TOL``), then ``wkv_chunk_kernel`` under autograd once at
   ``WKV_FULL`` with the counts reset just before (three forward and
   four backward launches), its dr, dk, dv, dlogw, du against the plain
   version, a second call bit-equal, timed beside the plain version and
   its bound (``wkv_bwd_cost``; no PyTorch call computes it);
10b. runs the plan-routed serving runtime on the card (``serve`` phase):
   ``PlanServer`` with no device, so each flush is one batch variant's
   flat arena program through the kernels. Server A: the flagship int8
   at batches 1, 2, 4, 8 (arenas 49,805, 98,957, 197,261 and 393,869 B);
   Server B: the same with a 200,000 B budget, which must reject batch 8;
   Server C: the f32 flagship at batches 1, 2, 4; each a closed loop of 64
   float requests and a tail of 7 (flushed 4 + 2 + 1), every flush with
   the launch counts reset just before and read just after (one launch a
   spec of its variant, kernel for kernel) and a device arena of exactly
   its variant's peak; and a server over A's variants without batch 1,
   whose tail of 3 forces a padded flush. Every spec of every variant is
   held against its plain version at the server's calibration, and every
   request against ``FastExec`` on that request alone
   (``compare_outputs``). ``[serve]`` lines give each server's variants,
   peaks, rejections, ``batches_run``, inferences a second and mean queue
   wait, and per batch the median ``execute_s`` beside the device ms of
   one flush's launches;
10c. runs the decoder models and the decode engines at full width
   (``models`` phase), on weights drawn from a seed: ``qwen2.5-3b`` (36
   layers, d 2048, 16 heads x 128 on 2 kv heads) and ``rwkv6-1.6b`` (24
   layers, d 2048, 32 WKV heads of 64). In float32 (TF32 off), for each:
   ``forward_train`` over S + extra tokens (4096 + 4 for qwen, whose
   causal attention then runs ``flash_attention``; 4096 + 64 for rwkv, a
   multiple of the WKV chunk, so ``wkv_chunk`` runs), then ``prefill`` of
   S tokens and four ``decode_step``s, each step's logits within the
   reference's 2e-3 of the full pass; the launch counts reset just before
   and read just after that prefill (36 flash launches, one a layer; 72
   WKV launches, three a layer) and layer 0's kernel call held against
   its plain version (the ``standalone`` phase's tolerances). For qwen,
   ``ContinuousEngine`` on 4 slots, ``cache_len`` 512, six requests of 37
   to 300 tokens and 8 new tokens each: every request's tokens equal to a
   single-request ``Engine`` on the card. Then in bfloat16,
   ``Engine.generate`` at batch 4, prompt 4096, 32 new tokens, greedy:
   the launches of one generate (the prefill's only), three timed runs
   (CUDA events around the prefill and each decode step: medians of the
   prefill ms and the decode ms a token, tok/s, and the device ms of the
   kernel's launches within one prefill); layer 0's bf16 call against
   its plain version, timed beside it, SDPA (flash) and its bound (the
   kernel's row is one call's numbers: its ms the prefill's device ms
   over its calls, plain and library ms layer 0's call); and
   one decode step after a prefill, which must leave every stacked cache
   tensor in its storage and raise the peak memory by less than the
   cache's bytes. ``[models]`` lines;
10d. trains at full width (``train`` phase): ``qwen2.5-3b`` in bf16 on
   seeded weights, the port's ``SyntheticCorpus`` at batch 2 x 4096 (the
   reference's ``train_4k`` length) in ``default_microbatches`` = 2
   microbatches, remat on, three ``make_train_step`` steps, each with
   the counts reset just before: every loss and gradient norm finite, 144
   flash forward launches (36 layers x 2 with remat x 2 microbatches) and
   144 backward launches a step, every param, m and v leaf in its storage
   after each update; the update's peak-memory rise under the largest
   leaf's f32 bytes (3.25 GB) and the step's peak against the state's
   bytes; step ms (CUDA events), tokens/s and the flash forward and
   backward device ms within a step (``KernelCalls``); layer 0's forward
   and backward calls of the last step against their plain versions,
   timed beside them, their bounds and SDPA. Then a gradient check: 2
   layers at full width in f32 over 4096 tokens, every gradient leaf of
   the loss on the kernels within ``TRAIN_GRAD_TOL`` of the same loss
   with attention from ``flash_plain_lse`` and ``flash_backward_plain``
   called directly (``plain_attention``), wq, wk, wv non-zero. Then RWKV:
   the same gradient check on ``rwkv6-1.6b`` (2 f32 layers, 4096
   tokens; six forward and four backward WKV launches a layer, against
   the WKV from ``wkv_plain`` and ``wkv_backward_plain`` called directly,
   ``plain_wkv``; wr, wk, wv, wd and u non-zero), then ``rwkv6-1.6b`` at
   full width in bf16 (24 layers, d 2048, 32 WKV heads of 64) with the
   same batch, microbatches, remat and steps: 288 forward and 192
   backward WKV launches a step (``csrc/wkv_chunk_bwd.cu``, four a
   call), step ms, tokens/s, peak against the state's bytes, the WKV
   forward and backward device ms a step and layer 0's calls against
   their plain versions. Every train run also logs the step's model
   FLOPs (``repro_torch.roofline.model_flops_for``) and their share of
   the bf16 peak at the step's ms. ``[train]`` lines;
10e. runs the eight configured archs no earlier phase runs (``archs``
   phase, ``ARCH_SERVE``, ``ARCH_TRAIN``), each on bf16 weights drawn
   from a seed on the card and freed before the next. First the MLA arch
   ``minicpm3-4b`` (62 layers, d 2560, 40 heads of nope 64 + rope 32, v
   64, latent ranks 768 and 256) in float32 as the models phase checks
   qwen (``ARCH_F32``): ``forward_train`` over 4096 + 4 tokens (its
   attention the flash kernel at the folded D = 96), ``prefill`` of 4096
   and four ``decode_step``s within 2e-3 of it, 62 flash launches and
   layer 0's call against its plain version. Each is served at
   full width: ``Engine.generate`` at batch 4, 8 new tokens, greedy,
   twice on the same prompts (``yi-6b``, ``nemotron-4-15b``,
   ``olmoe-1b-7b``, ``internvl2-1b``, ``musicgen-medium`` and
   ``minicpm3-4b`` uncut at prompt 4096, ``internvl2-1b`` and
   ``musicgen-medium`` on embedding prompts;
   ``qwen3-moe-235b-a22b`` cut to 8 of its 94 layers; ``hymba-1.5b``
   uncut at prompt 1024), the cut printed on its ``[models]`` line: each
   run's flash launches, one a layer (none for hymba, whose windowed
   attention takes ``_sdpa`` as the reference's model does; the line says
   so), the two runs' tokens equal, layer 0's flash call within
   ``flash_bf16_tol`` of ``flash_plain`` (``FLASH_BF16_TOL``, its atol
   scaled by the values' rms past 1; SDPA's difference beside), one
   decode step leaving every
   cache tensor in its storage with a peak rise under the cache's bytes,
   and the second run's prefill ms, decode ms a token, tok/s, weight
   bytes, peak memory, the flash calls' device ms inside the prefill
   (``KernelCalls``), the GQA copy's bytes (MLA: the fold's copies, k_rope
   expanded over the heads and v padded to D = 96) and, for hymba, the
   Mamba loop's device ms and share of the prefill. Then four are trained
   in bf16 with remat for three steps, step 0 the warm-up
   (``train_steps``): ``olmoe-1b-7b`` at 4 of 16 layers, 2 x 4096 in 2
   microbatches, first two forward and backward passes on one batch whose
   loss and every gradient leaf must be bit-equal; ``hymba-1.5b`` at 4 of
   32 layers, 1 x 1024, the Mamba loop's device ms in a step and one
   layer's backward; ``internvl2-1b`` uncut, 2 x 4096 embeddings in 2
   microbatches; ``minicpm3-4b`` at 8 of 62 layers, 2 x 4096 in 2
   microbatches, first the bit-equal repeat, after the steps a 2-layer
   float32 gradient check over 4096 tokens against ``plain_attention``
   (every latent projection's gradient non-zero): finite
   losses and grad norms, the state in place, the flash forward and
   backward launches, step ms, tokens/s, the peak against the state's
   bytes and the flash ms a step. Every flash shape new here adds its
   rows to the ``kernels`` line (``flash_attention [<arch> prefill]``,
   ``flash_attention`` and ``flash_attention_bwd [<arch> train]``) with
   its bound and SDPA's time;
10f. runs the reference's shapes past 4,096 tokens (``shapes`` phase,
   ``models/config.py`` ``SHAPES``): ``prefill_32k`` and ``decode_32k``
   on ``qwen2.5-3b`` (D 128) and ``minicpm3-4b`` (folded D 96) in bf16,
   uncut, batch cut to 2, a prompt of 32,760 tokens into
   ``cache_len_for(decode_32k)`` = 32,768 slots, 8 new, greedy, twice
   (``arch_serve``: tokens equal, one flash launch a layer, layer 0's
   call at S = 32,760 against ``flash_plain``, a decode step in place,
   rows ``flash_attention [<arch> 32k prefill]``); ``qwen2.5-3b`` in
   float32 at batch 1, prefill 32,760 tokens and one decode step within
   2e-3 of a prefill one token longer; then ``long_500k``:
   ``rwkv6-1.6b`` bf16 at batch 1 over 524,288 tokens, 8 new, twice (72
   WKV launches a prefill, tokens equal, layer 0's WKV call, 2^30 floats
   an input, within 3e-4 of ``wkv_plain``, prefill ms and peak memory,
   row ``wkv_chunk [rwkv6-1.6b 500k prefill]``), and ``qwen2.5-3b``'s
   4,096-slot ring with window 0 filled by a 4,096-token prompt and
   wrapped by 64 decode steps, twice (tokens equal, every cache tensor
   in its storage after every step). ``[shapes]`` lines;
11. times with CUDA events, after a warm-up, every kernel per forward of the
   path that runs it (``resnet_50_v2`` f32 for conv, pool, elementwise and
   the head; ``densenet_121`` for concat, flat, blocked and staged in the
   streaming program; ``allops`` f32 for matmul and
   pad; the flagship for the fused chain), on both programs, its plain
   version, and one PyTorch call per op at the same f32 shapes as the
   yardstick (``F.conv2d`` with TF32 off, ``F.max_pool2d``,
   ``torch.relu``, ``torch.add``, ``torch.cat``, ``torch.matmul``,
   ``F.pad``, ``torch.mean``, ``torch.softmax``; the port never calls
   them), plus the flagship's int8 and f32 kernel times, ``resnet_50_v2``
   int8, the ``dmo_dwconv2d`` cases and both programs' execute walls;
   the streaming kernels per forward (rolling and staged on
   ``resnet_50_v2`` f32, fused on the flagship), their plain versions and
   the streaming ``execute()`` walls beside the blocked ones; and the fused
   chains alone per forward (``arena_fused_chain`` and
   ``arena_stream_fused``, each beside its plain version and its bound) on
   the flagship int8, f32 and batch 2 on all three programs,
   ``mobilenet_v1_1.0_224_8bit`` flat and ``mobilenet_v2_1.0_224`` blocked
   and streaming; the softmax alone on the flagship int8 at batch 1, 2
   and 8 (one a sample, a ``[softmax]`` line each) and the matmul and
   softmax of ``allops`` int8, beside their plain versions; the
   hand-built softmaxes, matmuls and pads beside their plain versions,
   bounds and ``torch.softmax``/``torch.matmul``/``F.pad`` (f32, TF32
   off); and the launch
   floor, an empty kernel through the same launcher (one CTA, a
   cooperative grid of one CTA an SM, two CTAs an SM), under
   ``softmax_matmul`` in the JSON;
12. writes every number to ``build/chip_smoke.json`` (the chains'
    schedules and times under ``chains``, the serving runtime under
    ``serve``, the models under ``models``, training under ``train``, the
    archs phase under ``archs``, the shapes phase under ``shapes``) and
    prints the
    ``kernels`` JSON line (a ``[blocks]`` line per kernel for the
    row-blocked program, the three streaming kernels, a ``dmo_dwconv2d``
    line, the three standalone kernels, ``flash_attention_bwd`` and
    ``wkv_chunk_bwd``, ``flash_attention`` and ``wkv_chunk`` on the
    models' prefill, ``flash_attention`` and ``flash_attention_bwd`` in
    qwen's train step, ``wkv_chunk`` and ``wkv_chunk_bwd`` in rwkv's, the
    archs phase's flash rows and the shapes phase's flash and WKV rows),
    the card line, and as its last line the device JSON.

Any failed check raises and the script exits non-zero. It exits 2, printing
no result, when no CUDA device is visible or when it does not sit at the
root of a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

FLAGSHIP_BYTES = 49_805
RESNET_BYTES = 7_225_344
RESNET_LAUNCHES = 90
DENSENET_LAUNCHES = 247
WIDE_ROW = 8_192               # rows wider need a staged row buffer
HBM_BYTES_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_S = 67e12              # f32 outside the tensor cores
BF16_OPS_S = 989e12            # dense bf16 tensor-core peak
F32_TOL = 1e-4

CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {
    # name -> (source, TPU kernel it replaces)
    "arena_conv": (CSRC + "arena_conv.cu",
                   "src/repro/kernels/arena_ops.py:525"),
    "arena_pool": (CSRC + "arena_pool.cu",
                   "src/repro/kernels/arena_ops.py:569"),
    "arena_elementwise": (CSRC + "arena_elementwise.cu",
                          "src/repro/kernels/arena_ops.py:616"),
    "arena_matmul": (CSRC + "arena_matmul.cu",
                     "src/repro/kernels/arena_ops.py:652"),
    "arena_pad": (CSRC + "arena_pad.cu",
                  "src/repro/kernels/arena_ops.py:682"),
    "arena_concat": (CSRC + "arena_concat.cu",
                     "src/repro/kernels/arena_ops.py:673"),
    "arena_mean": (CSRC + "arena_mean.cu",
                   "src/repro/kernels/arena_ops.py:692"),
    "arena_fully_connected": (CSRC + "arena_fully_connected.cu",
                              "src/repro/kernels/arena_ops.py:638"),
    "arena_softmax": (CSRC + "arena_softmax.cu",
                      "src/repro/kernels/arena_ops.py:628"),
    "arena_fused_chain": (CSRC + "arena_fused_chain.cu",
                          "src/repro/kernels/arena_ops.py:736"),
    "arena_stream_roll": (CSRC + "arena_stream_roll.cu",
                          "src/repro/kernels/arena_ops.py:762"),
    "arena_stream_stage": (CSRC + "arena_stream_stage.cu",
                           "src/repro/kernels/arena_ops.py:817"),
    "arena_stream_fused": (CSRC + "arena_stream_fused.cu",
                           "src/repro/kernels/arena_ops.py:844"),
    "rmsnorm_inplace": (CSRC + "rmsnorm_inplace.cu",
                        "src/repro/kernels/inplace_rmsnorm.py:28"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:59"),
    # the backward of row 14, which the TPU kernel never had (the
    # reference's training attends blockwise through XLA)
    "flash_attention_bwd": (CSRC + "flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:59"),
    "wkv_chunk": (CSRC + "wkv_chunk.cu",
                  "src/repro/kernels/wkv_chunk.py:67"),
    # the backward of row 15, which the TPU kernel never had (the
    # reference trains RWKV through its chunked form in XLA)
    "wkv_chunk_bwd": (CSRC + "wkv_chunk_bwd.cu",
                      "src/repro/kernels/wkv_chunk.py:67"),
}
#: the standalone kernels, each reached through its own entry point
STANDALONE = ("rmsnorm_inplace", "flash_attention", "wkv_chunk")
#: the kernels only training reaches (through autograd)
TRAIN_KERNELS = ("flash_attention_bwd", "wkv_chunk_bwd")
#: the kernels of the streaming program, and the path each one's line in
#: the ``kernels`` JSON is measured on
STREAM_KERNEL_PATH = {"arena_stream_roll": "resnet_50_v2",
                      "arena_stream_stage": "resnet_50_v2",
                      "arena_stream_fused": "flagship"}
#: the kernels of the flat and row-blocked programs
PROGRAM_KERNELS = [n for n in KERNELS
                   if n not in STREAM_KERNEL_PATH and n not in STANDALONE
                   and n not in TRAIN_KERNELS]
#: the reference's row-blocked memory layer each kernel now runs under
BLOCK_REPLACES = {name: "src/repro/kernels/arena_ops.py:314"
                  for name in PROGRAM_KERNELS}
BLOCK_REPLACES["arena_fused_chain"] = "src/repro/kernels/arena_ops.py:397"
#: the blocked path each kernel's ``[blocks]`` line is measured on
BLOCK_KERNEL_PATH = {
    "arena_conv": "resnet_50_v2", "arena_pool": "resnet_50_v2",
    "arena_elementwise": "resnet_50_v2", "arena_mean": "resnet_50_v2",
    "arena_fully_connected": "resnet_50_v2", "arena_softmax": "resnet_50_v2",
    "arena_concat": "densenet_121", "arena_matmul": "allops",
    "arena_pad": "allops", "arena_fused_chain": "flagship",
}
#: bytes of the typed blocked arena (total_rows x arena_rowlen x dtype)
BLOCK_BYTES = {"flagship": 73_728, "flagship f32": 327_680,
               "resnet_50_v2 int8": 1_835_008, "resnet_50_v2": 7_340_032}
#: the standalone depthwise conv's cases (ih, iw, c, k, stride, pad): the
#: reference's DWCONV_CASES (tests/test_kernels.py), then a flagship layer
#: and a mobilenet_v1_1.0_224 layer
DMO_CASES = [
    (16, 16, 8, 3, 1, 1), (17, 13, 4, 3, 2, 0), (20, 20, 16, 3, 2, 1),
    (12, 12, 8, 5, 1, 2), (8, 24, 2, 3, 1, 0), (15, 15, 1, 3, 3, 1),
    (64, 64, 8, 3, 1, 1), (112, 112, 32, 3, 1, 1),
]
#: the path each kernel's line in the ``kernels`` JSON is measured on
KERNEL_PATH = {
    "arena_conv": "resnet_50_v2", "arena_pool": "resnet_50_v2",
    "arena_elementwise": "resnet_50_v2", "arena_mean": "resnet_50_v2",
    "arena_fully_connected": "resnet_50_v2", "arena_softmax": "resnet_50_v2",
    "arena_concat": "densenet_121", "arena_matmul": "allops",
    "arena_pad": "allops", "arena_fused_chain": "mobilenet_v1_0.25_128_8bit",
}
#: the standalone kernels' checks: RMSNorm (n, d) and WKV (s, h, d, q) at
#: the reference's test shapes (tests/test_kernels.py; WKV at batch 2; WKV
#: also with a ragged D and q, a single chunk, D = 7 (no multiple of 4:
#: 4-byte copies and scalar stores), strong decays (logw = -exp(z / 2 +
#: 3), chunk log-decays far past -88.7), and inputs one float into their
#: storage (not 16-byte aligned: the 4-byte copies at D = 64)),
#: flash attention (s, t, h, d, causal, q scale) at them, its non-causal
#: case, a causal call with T < S, a padded reduction depth (D = 96) at a
#: length no multiple of the tiles, a decode step over 4096 keys, T < S
#: with a ragged D = 40, and q x 8 (scores of tens: the running max moves
#: and the rescaling carries the result)
RMS_CASES = [(64, 32), (256, 64), (128, 200), (8, 8)]
FLASH_CASES = [(128, 128, 4, 64, True, 1.0), (256, 256, 2, 32, True, 1.0),
               (64, 256, 3, 16, True, 1.0), (32, 32, 1, 128, True, 1.0),
               (64, 128, 2, 32, False, 1.0), (64, 32, 2, 32, True, 1.0),
               (1000, 1000, 4, 96, True, 1.0),
               (1, 4096, 8, 128, False, 1.0),
               (300, 200, 2, 40, True, 1.0), (512, 512, 4, 128, True, 8.0)]
WKV_CASES = [(128, 2, 64, 32), (256, 4, 64, 64), (192, 1, 64, 64),
             (192, 1, 40, 24), (64, 3, 64, 64), (35, 1, 7, 5)]
WKV_STRONG = [(256, 4, 64, 64)]
WKV_UNALIGNED = [(256, 4, 64, 64)]
#: the WKV backward's sub-chunk cases, (b, s, h, d, q, shift): q = 48 (three
#: sub-chunks) and q = 40 (the third ragged) with D = 12 and strong decays
WKV_BWD_SUB = [(1, 96, 2, 64, 48, 0.0), (1, 80, 3, 12, 40, 3.0)]
#: the least warps an SM of the WKV backward's C' (chunk_grads)
WKV_BWD_MIN_WARPS = 16
#: full width, 4096 tokens: qwen2.5-3b (configs/qwen2_5_3b.py: d_model
#: 2048, 16 heads of 128) and rwkv6-1.6b (configs/rwkv6_1_6b.py: d_model
#: 2048, WKV heads of 64, so 32)
RMS_FULL = (4096, 2048)
FLASH_FULL = (4096, 4096, 16, 128)
#: the flash backward's f32 case at the train launcher's --reduced
#: qwen2.5-3b width (4 heads of 32, models/config.py::reduced) at --seq
#: 4096 and its default batch 8: B·H = 32 heads of 32
FLASH_BWD_REDUCED = (4096, 4096, 32, 32)
WKV_FULL = (1, 4096, 32, 64, 64)
#: the reference's tolerances (atol = rtol) in f32, by kernel; bf16 5e-2
STANDALONE_TOL = {"rmsnorm_inplace": 2e-5, "flash_attention": 2e-4,
                  "wkv_chunk": 3e-4}
BF16_TOL = 5e-2
#: flash attention's bf16 limit, (atol, rtol): its outputs are mostly
#: hundredths at long walks, where 5e-2 would pass a dropped key tile. The
#: kernel's own rounding (P to bf16 before P V, out to bf16) stays well
#: inside this, and skipped, masked or unrescaled key tiles fall far
#: outside it (scripts/torch_flash_faults.py)
FLASH_BF16_TOL = (4e-3, 2e-2)


def flash_bf16_tol(v) -> tuple:
    """``FLASH_BF16_TOL`` for a call whose values ``v`` may be larger than
    unit scale: the kernel's rounding (P to bf16 before P V) is linear in
    v, so atol scales with v's rms where that exceeds 1 (never below
    ``FLASH_BF16_TOL``). A full-width model's layer 0 at d_model 6144
    (nemotron-4-15b) has rms(v) 1.57, and SDPA's bf16 output there is as
    far from ``flash_plain`` as the kernel's (``scripts/torch_flash_model_
    error.py``)."""
    atol, rtol = FLASH_BF16_TOL
    return (atol * max(1.0, v.float().pow(2).mean().sqrt().item()), rtol)

#: the flash backward's limits against flash_backward_plain, (atol, rtol)
#: with atol scaled by the plain version's largest entry: f32 1e-4 (sums
#: in other orders); bf16 the forward's FLASH_BF16_TOL, since both compute
#: in f32 from the same bf16 inputs and round dq, dk, dv at the end
FLASH_BWD_TOL = {"f32": (1e-4, 0.0), "bf16": FLASH_BF16_TOL}

#: the train phase: qwen2.5-3b at full width, bf16, seeded weights; (batch,
#: seq) of a step, the reference's train_4k length; steps; remat
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_BATCH = (2, 4096)
TRAIN_STEPS = 3
#: the gradient check: layers of the float32 model, tokens, and the limit
#: of every gradient leaf against the same loss with attention from the
#: plain versions, (atol, rtol) with atol scaled by the leaf's largest
#: entry (the kernels sum in other orders; 2 layers of float32)
TRAIN_CHECK = (2, 4096)
TRAIN_GRAD_TOL = (2e-4, 1e-3)
#: RWKV's training: rwkv6-1.6b at full width in bf16 with TRAIN_BATCH in
#: the default microbatches and remat, TRAIN_STEPS steps; its gradient
#: check, 2 float32 layers over 4096 tokens, against the same loss with
#: the WKV from its plain versions (``plain_wkv``), TRAIN_GRAD_TOL
RWKV_TRAIN_ARCH = "rwkv6-1.6b"
RWKV_CHECK = (2, 4096)
#: the WKV backward's limit against wkv_backward_plain, (atol, rtol) with
#: atol scaled by the plain version's largest entry of each gradient: the
#: forward's STANDALONE_TOL (sums in other orders, exps by exp2f)
WKV_BWD_TOL = (3e-4, 3e-4)

#: the serve phase: the flagship's batch variants and their arena peaks (the
#: port's compile), Server B's budget, and the closed loop's requests: 64
#: in full flushes of the largest variant, then a tail of 7 the forced
#: drain serves as 4 + 2 + 1, so every variant flushes
SERVE_PEAKS = {1: 49_805, 2: 98_957, 4: 197_261, 8: 393_869}
SERVE_BUDGET = 200_000
SERVE_REQUESTS = 64
SERVE_TAIL = 7

#: the models phase: two decoder models at full width (configs/: qwen2.5-3b
#: 36 layers, d 2048, 16 heads x 128 on 2 kv heads, d_ff 11008, vocab
#: 151,936; rwkv6-1.6b 24 layers, d 2048, 32 WKV heads of 64, d_ff 7168,
#: vocab 65,536), weights drawn from a seed. (arch, prompt S, extra tokens
#: of the float32 full pass): qwen's both passes past FLASH_THRESHOLD, and
#: rwkv's 4160 a multiple of the WKV chunk, so both stay on the kernels
MODEL_RUNS = (("qwen2.5-3b", 4096, 4), ("rwkv6-1.6b", 4096, 64))
MODEL_STEPS = 4
#: the reference's decode-against-forward tolerance (tests/test_models.py)
MODEL_TOL = 2e-3
#: the bf16 serving run: Engine.generate, batch, prompt, new tokens, greedy
MODEL_SERVE = (4, 4096, 32)
MODEL_SERVE_REPS = 3
#: continuous batching (qwen, float32): slots, cache length, new tokens,
#: and the six requests' prompt lengths
CONT = (4, 512, 8)
CONT_PROMPTS = (37, 300, 120, 64, 211, 150)

#: the archs phase (10e): the eight configured archs that no earlier phase
#: runs, each served in bf16 on weights drawn from a seed at batch
#: ARCH_SERVE_BATCH with ARCH_SERVE_NEW new tokens, greedy, twice: (arch,
#: layers kept, None for every layer, prompt length). Width is never cut:
#: qwen3-moe-235b-a22b keeps 8 of its 94 layers (all 94 are 470 GB of
#: bf16 weights), hymba-1.5b's prompt is 1024 (its Mamba loop is a Python
#: loop of S steps a layer)
ARCH_SERVE = (("yi-6b", None, 4096), ("nemotron-4-15b", None, 4096),
              ("olmoe-1b-7b", None, 4096), ("qwen3-moe-235b-a22b", 8, 4096),
              ("hymba-1.5b", None, 1024), ("internvl2-1b", None, 4096),
              ("musicgen-medium", None, 4096), ("minicpm3-4b", None, 4096))
ARCH_SERVE_BATCH = 4
ARCH_SERVE_NEW = 8
#: four of them trained in bf16 with remat, TRAIN_STEPS steps (step 0 the
#: warm-up): (arch, layers kept, (batch, seq), microbatches).
#: minicpm3-4b keeps 8 of its 62 layers: all 62 are 4.26 G parameters,
#: 42.6 GB of state at 10 B a parameter
ARCH_TRAIN = (("olmoe-1b-7b", 4, (2, 4096), 2),
              ("hymba-1.5b", 4, (1, 1024), 1),
              ("internvl2-1b", None, (2, 4096), 2),
              ("minicpm3-4b", 8, (2, 4096), 2))
#: the MLA arch's float32 check before it is served, as the models phase
#: checks qwen: (arch, prompt S, extra tokens of the full pass)
ARCH_F32 = (("minicpm3-4b", 4096, 4),)
#: MLA's latent projections, each of which must get a gradient
MLA_PROJECTIONS = ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b")

#: the shapes phase (10f): the reference's prefill_32k and decode_32k
#: (models/config.py SHAPES) in bf16 on a GQA arch (D 128) and the MLA arch
#: (folded D 96), batch cut to SHAPE_BATCH (the reference's global batches
#: are 32 and 128), a prompt of SHAPE_PROMPT tokens into the
#: cache_len_for(decode_32k) = 32,768 slots, ARCH_SERVE_NEW new tokens
SHAPE_ARCHS = ("qwen2.5-3b", "minicpm3-4b")
SHAPE_BATCH = 2
SHAPE_PROMPT = 32760
#: then qwen2.5-3b in float32 at batch 1: prefill SHAPE_PROMPT tokens and
#: one decode step, against a prefill one token longer (MODEL_TOL)
SHAPE_F32_ARCH = "qwen2.5-3b"
#: long_500k on the sub-quadratic family: rwkv6-1.6b bf16 at batch 1 over
#: LONG_PROMPT tokens (a multiple of WKV_CHUNK, so the WKV kernel runs),
#: ARCH_SERVE_NEW new tokens, twice. hymba-1.5b stays out: its Mamba loop
#: is a Python loop of S steps a layer
LONG_ARCH = "rwkv6-1.6b"
LONG_PROMPT = 524_288
#: long_500k on an attention arch: a prompt of cache_len_for(long_500k) =
#: 4,096 tokens into that ring with window 0, then RING_STEPS decode steps
#: that wrap it, batch 1, twice. decode_window(long_500k) is the arch's
#: sliding_window, 4,096 (ArchConfig's default) for qwen2.5-3b: on a ring
#: of as many slots it masks nothing that window 0 keeps, and a prefill
#: with a window leaves the flash kernel for the plain blockwise path
RING_ARCH = "qwen2.5-3b"
RING_STEPS = 64

#: the mesh phase (10g): the expert-parallel MoE body on a (data, model)
#: mesh of processes (``launch/mesh.py``) whose ranks share the one card
#: over gloo. MESH_ARCH in bf16 at full width (E 64, k 8, d 2048, f 1024),
#: served uncut under each (mesh, fsdp) of MESH_SERVE at MESH_SERVE_SHAPE
#: (batch, prompt, new tokens), twice; then trained under MESH_TRAIN
#: (mesh, fsdp, layers kept, (batch, seq)) with remat. Ranks on one card
#: time nothing about several cards: the card and the host's gloo copies
#: are shared by every rank
MESH_ARCH = "olmoe-1b-7b"
MESH_SERVE = (((1, 2), False), ((2, 2), True))
MESH_SERVE_SHAPE = (4, 4096, 8)
MESH_TRAIN = ((2, 2), True, 4, (2, 4096))
#: the prefill's last hidden state at data 1 against the one-process local
#: path on the same weights: ||a - b|| / ||b||. bf16 keeps 8 bits (a step
#: of 2^-8 = 3.9e-3 relative); the two paths round each MoE output at
#: other points (each model rank's partial sum, then their sum) in each
#: of the 16 layers
MESH_HIDDEN_TOL = 5e-2
#: seconds each spawn of the phase may take before its ranks are killed
MESH_LIMIT_S = 300


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def _el(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ---------------------------------------------------------------------------
# graphs and specs of the checks (also used by the CPU tests)
# ---------------------------------------------------------------------------


def allops_graph(dtype_bytes: int = 4, graph_cls=None):
    """The reference's test graph ``allops_graph`` (tests/test_executors.py:
    max pool, pad, concat, mean, matmul, relu6, add, sigmoid, softmax, two
    outputs), built with the port's ``Graph`` unless another package's
    ``graph_cls`` is given; ``dtype_bytes=1`` is its int8 build."""
    if graph_cls is None:
        from repro_torch.core.graph import Graph as graph_cls
    g = graph_cls("allops")
    a = g.tensor("a", (8, 8, 4), dtype_bytes, "input")
    b2 = g.tensor("b", (8, 2), dtype_bytes, "input")
    p = g.op("pool", [a], (4, 4, 4),
             dict(kernel=(3, 3), stride=(2, 2), padding="same", mode="max"))
    q = g.op("pad", [p], (6, 6, 4), dict(paddings=((1, 1), (1, 1), (0, 0))))
    c = g.op("concat", [p, p], (4, 4, 8), dict(axis=-1))
    m = g.op("mean", [q], (4,), dict(axes=(0, 1)))
    r1 = g.op("reshape", [c], (16, 8))
    mm = g.op("matmul", [r1, b2], (16, 2))
    s = g.op("elementwise", [mm], (16, 2), dict(fn="relu6"))
    ss = g.op("elementwise", [s, mm], (16, 2), dict(fn="add"))
    g.op("softmax", [ss], (16, 2), name="out", out_kind="output")
    g.op("elementwise", [m], (4,), dict(fn="sigmoid"), name="out2",
         out_kind="output")
    g.validate()
    return g


def stream_allops_graph(dtype_bytes: int = 4, graph_cls=None):
    """The reference's streaming test graph ``stream_allops``
    (tests/test_streaming.py: rolling conv2d, depthwise and max pool;
    staged add, pad, concat, mean, fully_connected and softmax), built with
    the port's ``Graph`` unless another package's ``graph_cls`` is given;
    ``dtype_bytes=1`` is its int8 build."""
    if graph_cls is None:
        from repro_torch.core.graph import Graph as graph_cls
    g = graph_cls("stream_allops")
    x = g.tensor("x", (16, 16, 8), dtype_bytes, "input")
    c = g.op("conv2d", [x], (16, 16, 8),
             dict(kernel=(3, 3), stride=(1, 1), padding="same"))
    d = g.op("depthwise_conv2d", [c], (16, 16, 8),
             dict(kernel=(3, 3), stride=(1, 1), padding="same"))
    e = g.op("elementwise", [d, c], (16, 16, 8), dict(fn="add"))
    p = g.op("pool", [e], (8, 8, 8),
             dict(kernel=(2, 2), stride=(2, 2), padding="valid", mode="max"))
    pd = g.op("pad", [p], (10, 10, 8),
              dict(paddings=((1, 1), (1, 1), (0, 0))))
    cc = g.op("concat", [pd, pd], (10, 10, 16), dict(axis=-1))
    m = g.op("mean", [cc], (16,), dict(axes=(0, 1)))
    f = g.op("fully_connected", [m], (12,))
    g.op("softmax", [f], (12,), out_kind="output")
    g.validate()
    return g


def fused_demo_spec(dtype: str, h: int, w: int, c: int, rowlen: int = 0,
                    arena_cat: bool = False):
    """A fused chain with every stage kind the fused kernel runs, built by
    hand (the zoo's chains are conv, depthwise and concat only): conv2d
    3x3 (arena -> scratch s0), max pool 3x3/1 (s0 -> s1), add of s1 and the
    chain input (-> s2), avg pool 3x3/1 (s2 -> s1), relu6 in place on s1,
    then concat [s1, s0] written to the arena over the chain input
    (``arena_cat``: concat [s1, the chain input], so the terminal stage
    reads arena bytes it overwrites); the filter is (3, 3, c, c).
    ``rowlen == 0`` builds the flat program and returns (spec, the arena
    bytes it needs); ``rowlen > 0`` the row-blocked one over
    ``rowlen``-element rows, each tensor packed, plain or spanning by its
    image row's width, and returns (spec, the arena rows it needs)."""
    from repro_torch.kernels.arena_ops import OpSpec
    q = dtype == "i8"
    isz = 1 if q else 4
    hw, hw2 = (h, w, c), (h, w, 2 * c)

    def addr(shape):
        """((rows, used), (c, k, rl)) of an image tensor."""
        rl = shape[1] * shape[2]
        if rl <= rowlen:
            cp = rowlen // rl
            return (-(-shape[0] // cp), cp * rl), (cp, 1, rl)
        k = -(-rl // rowlen)
        return (shape[0] * k, rowlen), (1, k, rl)

    if rowlen:
        n = addr(hw)[0][0]                    # rows of one (h, w, c) slot
        x_off, y_off = n // 2, 0
        need = max(x_off + n, y_off + addr(hw2)[0][0])
    else:
        n = h * w * c * isz
        x_off, y_off = _round16(n // 2), 0
        need = max(x_off + n, y_off + 2 * n)

    def st(kind, ins, offs, scr, out_off, out_scr, out_shape, meta, qmeta):
        blk = {}
        if rowlen:
            blk = dict(rowlen=rowlen,
                       in_rows=tuple(addr(i)[0] for i in ins),
                       out_rows=addr(out_shape)[0],
                       in_addr=tuple(addr(i)[1] for i in ins),
                       out_addr=addr(out_shape)[1])
        return OpSpec(kind=kind, in_off=offs, in_shape=ins, out_off=out_off,
                      out_shape=out_shape, dtype=dtype, meta=meta,
                      qmeta=qmeta if q else (), in_scratch=scr,
                      out_scratch=out_scr, **blk)

    s0, s1, s2 = 0, n, 2 * n
    pool_q = (-2, float(np.float32(0.93)), 3)
    stages = (
        st("conv2d", (hw,), (x_off,), (0,), s0, 1, hw,
           (3, 3, 1, 1, 1, 1, 1, 1, 1),
           (-3, float(np.float32(0.0123)), 5)),
        st("pool", (hw,), (s0,), (1,), s1, 1, hw,
           (3, 3, 1, 1, 1, 1, "max"), pool_q),
        st("elementwise", (hw, hw), (s1, x_off), (1, 0), s2, 1, hw,
           ("add",), (((0.05, 3), (0.07, -2)), (0.09, 1))),
        st("pool", (hw,), (s2,), (1,), s1, 1, hw,
           (3, 3, 1, 1, 1, 1, "avg"), pool_q),
        st("elementwise", (hw,), (s1,), (1,), s1, 1, hw,
           ("relu6",), (((0.04, -1),), (0.03, -100))),
        st("concat", (hw, hw), (s1, x_off) if arena_cat else (s1, s0),
           (1, 0) if arena_cat else (1, 1), y_off, 0, hw2,
           (-1,), (((-100, float(np.float32(0.75))),
                    (5, float(np.float32(1.25)))), (2,))),
    )
    blk = {}
    if rowlen:
        blk = dict(rowlen=rowlen, in_rows=(addr(hw)[0],),
                   out_rows=addr(hw2)[0])
    spec = OpSpec(kind="fused", in_off=(x_off,), in_shape=(hw,),
                  out_off=y_off, out_shape=hw2, dtype=dtype,
                  meta=("demo",) + (("arena_cat",) if arena_cat else ()),
                  stages=stages, scratch_rows=3 * n, **blk)
    return spec, need


def stream_chain_spec(spec):
    """The streaming form of a hand-built row-blocked fused chain (as
    ``CudaExecutor.lower_stream`` gives a planner's chain): every external
    input and the terminal output get a slot of their own after the
    chain's scratch rows, every stage operand addresses the scratch, and
    the window is the whole scratch."""
    from repro_torch.kernels.arena_ops import stream_form
    cur, slots = spec.scratch_rows, []
    for rows, _ in spec.in_rows:
        slots.append(cur)
        cur += rows
    out_slot = cur
    cur += spec.out_rows[0]

    def slot_of(off, offs, rows, bases):
        (base,) = [b + off - o for o, (r, _), b in zip(offs, rows, bases)
                   if o <= off < o + r]
        return base

    stages = []
    for st in spec.stages:
        ins = tuple(off if f else slot_of(off, spec.in_off, spec.in_rows,
                                          slots)
                    for off, f in zip(st.in_off, st.in_scratch))
        out = st.out_off if st.out_scratch else \
            out_slot + st.out_off - spec.out_off
        stages.append(dataclasses.replace(
            st, in_off=ins, in_scratch=(1,) * len(ins), out_off=out,
            out_scratch=1))
    stream = dataclasses.replace(
        spec, stages=tuple(stages), scratch_rows=cur, win_rows=cur,
        in_slots=tuple(slots), out_slot=out_slot)
    assert stream_form(stream) == "fused"
    return stream


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def wide_row_spec(ow: int, oc: int):
    """A hand-built f32 conv2d 3x3 whose output row (ow * oc outputs) may
    exceed a CTA's shared memory (the global row buffer), overlapped with
    its input. Returns (spec, arena bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    ic, rows = 4, 3
    in_b, out_b = rows * ow * ic * 4, rows * ow * oc * 4
    spec = OpSpec(kind="conv2d", in_off=(out_b // 3 // 16 * 16,),
                  in_shape=((rows, ow, ic),), out_off=0,
                  out_shape=(rows, ow, oc), dtype="f32",
                  meta=(3, 3, 1, 1, 1, 1, 1, 1, 1))
    return spec, max(spec.in_off[0] + in_b, out_b)


def deep_footprint_spec():
    """A hand-built f32 conv2d 3x3 over 6,000 input channels: one output
    column's input footprint (3 x 3 x 6,000 f32) exceeds the conv's shared
    memory budget, so each CTA stages it in its slice of the global
    workspace; the output overlaps the input's first row. Returns (spec,
    arena bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    ic, oc = 6_000, 8
    spec = OpSpec(kind="conv2d", in_off=(128,), in_shape=((3, 3, ic),),
                  out_off=0, out_shape=(3, 3, oc), dtype="f32",
                  meta=(3, 3, 1, 1, 1, 1, 1, 1, 1))
    return spec, 128 + 3 * 3 * ic * 4


def deep_chain_spec():
    """A hand-built flat f32 fused chain whose conv2d stage's footprint
    exceeds the conv's shared memory budget (``deep_footprint_spec``'s 3x3
    conv over 6,000 input channels, into scratch), so the chain stages each
    footprint in its CTA's slice of the global workspace; then a concat of
    the conv's output into the arena after the input. Returns (spec, arena
    bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    conv, nbytes = deep_footprint_spec()
    stage = dataclasses.replace(conv, out_off=0, out_scratch=1,
                                in_scratch=(0,))
    cat = OpSpec(kind="concat", in_off=(0,), in_shape=((3, 3, 8),),
                 out_off=nbytes, out_shape=(3, 3, 8), meta=(-1,),
                 in_scratch=(1,))
    spec = OpSpec(kind="fused", in_off=conv.in_off, in_shape=conv.in_shape,
                  out_off=nbytes, out_shape=(3, 3, 8), meta=("deep",),
                  stages=(stage, cat), scratch_rows=3 * 3 * 8 * 4)
    return spec, nbytes + 3 * 3 * 8 * 4


#: int8 params of the hand-built softmax ((x scale, x_zp), (y scale,
#: y_zp)) and matmul (a_zp, b_zp, multiplier, y_zp)
SOFTMAX_QM = ((float(np.float32(0.05)), 3),
              (float(np.float32(1 / 256)), -128))
MATMUL_QM = (3, -2, float(np.float32(0.0002)), 1)
#: where a hand-built softmax's output lies, in elements past its input's
#: start: over it (each row over its own input: order word 1), five
#: elements on (a row's last outputs over the next row's first inputs:
#: order word 2), after it (order word 0)
SOFTMAX_PLACES = ("aligned", "shifted", "disjoint")


def softmax_spec(dtype: str, rows: int, last: int, place: str):
    """A hand-built flat softmax over ``rows`` rows of ``last``, its output
    placed by ``place`` (``SOFTMAX_PLACES``). Returns (spec, arena
    bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    isz = 1 if dtype == "i8" else 4
    n = rows * last
    out = {"aligned": 0, "shifted": 5, "disjoint": n}[place]
    spec = OpSpec(kind="softmax", in_off=(0,), in_shape=((rows, last),),
                  out_off=out * isz, out_shape=(rows, last), dtype=dtype,
                  qmeta=SOFTMAX_QM if dtype == "i8" else ())
    return spec, _round16((out + n) * isz)


def matmul_spec(dtype: str, m: int, k: int, n: int, place: str):
    """A hand-built flat matmul (m, k) x (k, n): a at byte 0, b after it
    at a 16-byte boundary, the output after both (``place`` "disjoint":
    order word 0) or over a from its first byte ("over_a": order word 2).
    Returns (spec, arena bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    isz = 1 if dtype == "i8" else 4
    b_off = _round16(m * k * isz)
    out = 0 if place == "over_a" else _round16(b_off + k * n * isz)
    spec = OpSpec(kind="matmul", in_off=(0, b_off),
                  in_shape=((m, k), (k, n)), out_off=out, out_shape=(m, n),
                  dtype=dtype, qmeta=MATMUL_QM if dtype == "i8" else ())
    return spec, _round16(max(b_off + k * n * isz, out + m * n * isz))


def stream_pad_spec():
    """A hand-built f32 pad of the streaming program, (64, 64, 16) -> (66,
    66, 16) on rows of 1,024 (its output rows span two arena rows): the
    TPU program's staged window for it (the input block and the output
    block, 819,200 B) exceeds a CTA's shared memory; the card runs it in
    place on the arena. Returns (spec, arena rows)."""
    from repro_torch.core.planner import staged_slots
    from repro_torch.kernels.arena_ops import OpSpec
    spec = OpSpec(kind="pad", in_off=(0,), in_shape=((64, 64, 16),),
                  out_off=64, out_shape=(66, 66, 16), dtype="f32",
                  meta=(((1, 1), (1, 1), (0, 0)),), rowlen=1024,
                  in_rows=((64, 1024),), out_rows=(132, 1024),
                  in_addr=((1, 1, 1024),), out_addr=(1, 2, 1056))
    win = staged_slots([64], 132, 8)[2]
    return dataclasses.replace(spec, win_rows=win), 64 + 132


#: the hand-built specs timed where the work shows: (label, maker, args)
HAND_SOFTMAX = [(f"softmax 1024 x 1000 {dt} {pl}", softmax_spec,
                 (dt, 1024, 1000, pl))
                for dt in ("f32", "i8") for pl in ("aligned", "shifted")]
HAND_MATMUL = [(f"matmul 1024^3 {dt} {pl}", matmul_spec,
                (dt, 1024, 1024, 1024, pl))
               for dt in ("f32", "i8") for pl in ("disjoint", "over_a")]
#: int8 params of the hand-built pads ((x_zp, multiplier), (y_zp,)), and
#: where a pad's output lies: after its input (order word 0) or from its
#: input's first byte, over it (order word 2)
PAD_QM = ((-3, float(np.float32(0.9))), (4,))
PAD_PLACES = ("apart", "over")


def pad_spec(dtype: str, h: int, w: int, c: int, place: str):
    """A hand-built flat pad (h, w, c) -> (h + 2, w + 2, c), a row and a
    column on each side, its output placed by ``place`` (``PAD_PLACES``).
    At (112, 112, 64) it is Keras's ResNet50 ``pool1_pad``
    (ZeroPadding2D((1, 1), (1, 1)) before the stem's max pool). Returns
    (spec, arena bytes)."""
    from repro_torch.kernels.arena_ops import OpSpec
    isz = 1 if dtype == "i8" else 4
    n_in, n_out = h * w * c * isz, (h + 2) * (w + 2) * c * isz
    out = 0 if place == "over" else _round16(n_in)
    spec = OpSpec(kind="pad", in_off=(0,), in_shape=((h, w, c),),
                  out_off=out, out_shape=(h + 2, w + 2, c), dtype=dtype,
                  meta=(((1, 1), (1, 1), (0, 0)),),
                  qmeta=PAD_QM if dtype == "i8" else ())
    return spec, _round16(max(n_in, out + n_out))


HAND_PAD = [(f"pad 112 x 112 x 64 {dt} {pl}", pad_spec,
             (dt, 112, 112, 64, pl))
            for dt in ("f32", "i8") for pl in PAD_PLACES]
#: checked only, not timed: one row past a CTA's registers and shared
#: memory (a slice of the workspace a CTA)
LONG_SOFTMAX = [(f"softmax 1 x 65536 {dt} disjoint", softmax_spec,
                 (dt, 1, 65_536, "disjoint")) for dt in ("f32", "i8")]


def graph_fault(graph):
    """The first binary elementwise op whose second operand does not
    broadcast to the first (numpy rules), as (name, shapes), or None."""
    for op in graph.ops:
        if op.kind != "elementwise" or len(op.inputs) != 2:
            continue
        a, b = tuple(op.inputs[0].shape), tuple(op.inputs[1].shape)
        if _el(a) != _el(b) and (len(b) > len(a) or any(
                y not in (1, x) for x, y in zip(a[::-1], b[::-1]))):
            return op.name, (a, b)
    return None


# ---------------------------------------------------------------------------
# per-spec helpers
# ---------------------------------------------------------------------------


def out_ranges(spec):
    """Byte ranges of the arena a spec writes: its output, or a fused
    chain's terminal stage's, one range an image where the chain is
    batched (the spec's ``out_shape`` is one image's)."""
    isz = 1 if spec.dtype == "i8" else 4
    outs = [st for st in spec.stages if not st.out_scratch] or [spec]
    return [(o.out_off, o.out_off + _el(o.out_shape) * isz) for o in outs]


def lsb_limit(spec) -> int:
    """int8 tolerance: exp differs by an ulp between libraries, so softmax
    and sigmoid (alone or as a fused stage) may differ by one step."""
    kinds = [spec] + list(spec.stages)
    return int(any(s.kind == "softmax" or (s.kind == "elementwise"
                                           and s.meta[0] == "sigmoid")
                   for s in kinds))


def arena_diff(torch, got, ref, spec) -> float:
    """Max abs difference of two arenas after one spec; raises past the
    tolerance. Bytes outside the spec's output (flat), or rows outside its
    output block (row-blocked), must be equal."""
    if spec.rowlen:
        return _block_diff(torch, got, ref, spec)
    ranges = out_ranges(spec)
    outside = torch.ones(got.numel(), dtype=torch.bool, device=got.device)
    for lo, hi in ranges:
        outside[lo:hi] = False
    check(torch.equal(got[outside], ref[outside]),
          f"{spec.kind}: bytes outside its output differ")
    got = torch.cat([got[lo:hi] for lo, hi in ranges])
    ref = torch.cat([ref[lo:hi] for lo, hi in ranges])
    if spec.dtype == "i8":
        g = got.view(torch.int8).to(torch.int32)
        r = ref.view(torch.int8).to(torch.int32)
        err = (g - r).abs().max().item() if g.numel() else 0
        limit = lsb_limit(spec)
        check(err <= limit, f"{spec.kind}: int8 max error {err} > {limit}")
        return float(err)
    g = got.view(torch.float32)
    r = ref.view(torch.float32)
    err = (g - r).abs()
    check(bool(torch.isfinite(g).all()), f"{spec.kind}: non-finite output")
    check(bool((err <= F32_TOL + F32_TOL * r.abs()).all()),
          f"{spec.kind}: f32 error {err.max().item()} over tolerance")
    return float(err.max().item())


def _block_diff(torch, got, ref, spec) -> float:
    lo, hi = spec.out_off, spec.out_off + spec.out_rows[0]
    outside = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    outside[lo:hi] = False
    check(torch.equal(got[outside], ref[outside]),
          f"{spec.kind}: rows outside its output block differ")
    if spec.dtype == "i8":
        err = (got[lo:hi].to(torch.int32) - ref[lo:hi].to(torch.int32)) \
            .abs().max().item() if hi > lo else 0
        limit = lsb_limit(spec)
        check(err <= limit, f"{spec.kind}: int8 max error {err} > {limit}")
        return float(err)
    g, r = got[lo:hi], ref[lo:hi]
    err = (g - r).abs()
    check(bool(torch.isfinite(g).all()), f"{spec.kind}: non-finite output")
    check(bool((err <= F32_TOL + F32_TOL * r.abs()).all()),
          f"{spec.kind}: f32 error {err.max().item()} over tolerance")
    return float(err.max().item())


def spec_cost(spec):
    """(bytes the op must move, operations, operation rate) at this spec:
    each input read once, each output written once, filters read once;
    multiply-adds count two operations (every tap of the window), a pool
    one per tap, an elementwise op one per operand element, a concat or
    pad one per output element (the rescale)."""
    isz = 1 if spec.dtype == "i8" else 4
    rate = INT8_OPS_S if spec.dtype == "i8" else F32_OPS_S
    k = spec.kind
    if k == "fused":
        ext = sum(_el(s) for s in spec.in_shape) * isz
        out = _el(spec.out_shape) * isz
        w_bytes, ops = 0, 0
        for st in spec.stages:
            _, o, _ = spec_cost(st)
            ops += o
            if st.kind in ("conv2d", "depthwise_conv2d"):
                kh, kw = st.meta[:2]
                ic, oc = st.in_shape[0][-1], st.out_shape[-1]
                w_bytes += kh * kw * (ic * oc if st.kind == "conv2d"
                                      else oc) * isz
        return ext + out + w_bytes, ops, rate
    inb = sum(_el(s) for s in spec.in_shape) * isz
    outb = _el(spec.out_shape) * isz
    n_out = _el(spec.out_shape)
    if k in ("conv2d", "depthwise_conv2d"):
        kh, kw = spec.meta[:2]
        ic = spec.in_shape[0][-1]
        oc = spec.out_shape[-1]
        per = kh * kw * (ic if k == "conv2d" else 1)
        wb = kh * kw * (ic * oc if k == "conv2d" else oc) * isz
        return inb + outb + wb, 2 * n_out * per, rate
    if k == "pool":
        return inb + outb, n_out * spec.meta[0] * spec.meta[1], rate
    if k == "fully_connected":
        idim = spec.in_shape[0][-1]
        return inb + outb + idim * n_out * isz, 2 * idim * n_out, rate
    if k == "matmul":
        return inb + outb, 2 * spec.in_shape[0][-1] * n_out, rate
    if k == "elementwise":
        return inb + outb, n_out * len(spec.in_shape), rate
    if k in ("concat", "pad"):
        return inb + outb, n_out, rate
    return inb + outb, 4 * _el(spec.in_shape[0]), rate  # mean, softmax


def tpu_staging_bytes(K, spec) -> int:
    """Bytes the TPU program's streaming spec copies beyond its op's own
    work (a planner count): a rolling op's window fetches (``win_in`` rows
    per tile) and its output tiles (copied in and back), a staged op's or
    chain's blocks in and out (padding rows included); 0 outside the
    streaming program."""
    form = K.stream_form(spec)
    if form is None:
        return 0
    rowb = spec.rowlen * (1 if spec.dtype == "i8" else 4)
    if form == "roll":
        tr, tile_ar = K._tile_geom(spec)
        oh = spec.out_shape[-3]
        rows = 0
        for t in range(len(spec.win_starts)):
            a0, a1 = K._tile_rows(spec, t * tr, min((t + 1) * tr, oh))
            rows += (spec.win_rows - tile_ar) + 2 * (a1 - a0)
        return rows * rowb
    return (sum(r for r, _ in spec.in_rows) + spec.out_rows[0]) * rowb


def card_staging_bytes(K, spec) -> int:
    """Bytes the card's kernel copies on its way for a streaming spec: a
    rolling op's row tiles stage their footprints, the columns and
    channels each tile reads through its window (the Python mirror,
    ``arena_ops.tile_reads``), and store straight into the arena; a fused
    chain and every staged op run in place (nothing)."""
    if K.stream_form(spec) != "roll":
        return 0
    return sum(n for t in range(K.conv_tiling(spec).ntiles)
               for _, _, n in K.tile_reads(spec, t))


def bound_ms(spec) -> float:
    nbytes, ops, rate = spec_cost(spec)
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / rate)


def bound_by(specs) -> str:
    t_bytes = sum(spec_cost(s)[0] / HBM_BYTES_S for s in specs)
    t_ops = sum(spec_cost(s)[1] / spec_cost(s)[2] for s in specs)
    return "bytes" if t_bytes >= t_ops else "operations"


def rmsnorm_cost(n: int, d: int, esize: int):
    """(bytes, operations, rate) of the in-place RMSNorm: x, r and the f32
    g read once and x written once; 5 operations an element (square, sum,
    two scalings, the residual add)."""
    return (3 * n * d * esize + 4 * d, 5 * n * d, F32_OPS_S)


def attention_cost(s: int, t: int, h: int, d: int, causal: bool,
                   esize: int):
    """(bytes, operations, rate) of flash attention: q, k, v read once and
    the output written once; 4·D operations per (query, key) pair a row
    takes part in (q·k and p·v; the exponentials are not counted). A
    causal row sees ``min(T, qpos + 1)`` keys, and a row that sees none
    (T < S) averages all T. bf16 at the tensor cores' peak, f32 at the FMA
    units'."""
    if causal:
        off = t - s
        pairs = sum(t if i + off < 0 else min(t, i + off + 1)
                    for i in range(s))
    else:
        pairs = s * t
    return ((2 * s + 2 * t) * h * d * esize, 4 * d * h * pairs,
            BF16_OPS_S if esize == 2 else F32_OPS_S)


def attention_bwd_cost(s: int, t: int, h: int, d: int, causal: bool,
                       esize: int):
    """(bytes, operations, rate) of the flash backward: q, k, v, out and
    its gradient and the f32 lse read once, dq, dk, dv written once; the
    backward's five products (q·k, do·v, dS·k, dS·q, p·do), 10·D
    operations per visible (query, key) pair, not the kernel's
    recomputation of q·k and do·v in its second launch. The pairs as
    :func:`attention_cost` counts them."""
    nbytes, ops, rate = attention_cost(s, t, h, d, causal, esize)
    return ((4 * s + 4 * t) * h * d * esize + 4 * s * h, ops * 10 // 4,
            rate)


def wkv_cost(b: int, s: int, h: int, d: int, q: int):
    """(bytes, operations, rate) of the chunked WKV, f32: r, k, v, logw and
    u read once, y and the final state written once. Operations per chunk,
    each exp counted as one, with the chunk cut into sub-chunks of 16
    steps (the last one ragged), as the kernel computes att: 5·D per pair
    j < t inside one sub-chunk (difference, exp, two products, sum) and
    3·D on the diagonal; 2·D per pair below the sub-chunks (r~ k~^T), with
    the factors r~ (3·D a step, 2·D in the first sub-chunk), k~ (3·D per
    row before each later sub-chunk) and E (D exps per later sub-chunk,
    D products per step of it); 2·D per pair j <= t of att @ v; per step
    2·D·D for the carried state's product, 3·D for k's decay and 2·D·D
    for the state update, plus 2·D·D for the state's decay."""
    starts = range(0, q, 16)
    lens = [min(16, q - s0) for s0 in starts]
    pairs_in = sum(n * (n - 1) // 2 for n in lens)
    pairs_lt, pairs_le = q * (q - 1) // 2, q * (q + 1) // 2
    later = q - lens[0]                          # steps past sub-chunk 0
    factors = (3 * d * later + 2 * d * lens[0]   # r~
               + 3 * d * sum(starts)             # k~
               + d * (len(lens) - 1) + d * later)  # E and r~ E
    per_chunk = (5 * d * pairs_in + 3 * d * q + 2 * d * (pairs_lt - pairs_in)
                 + factors + 2 * d * pairs_le
                 + q * (4 * d * d + 3 * d) + 2 * d * d)
    nbytes = 4 * (5 * b * s * h * d + b * h * d * d + h * d)
    return nbytes, b * h * (s // q) * per_chunk, F32_OPS_S


def wkv_bwd_cost(b: int, s: int, h: int, d: int, q: int,
                 state_grad: bool = True):
    """(bytes, operations, rate) of the chunked WKV's backward, f32: r, k,
    v, logw, dy, u and the state's gradient (where there is one) read
    once, dr, dk, dv, dlogw and du written once. Operations per chunk,
    each exp counted as one, once each however the kernel repeats them,
    with att, dr and dk cut into sub-chunks of 16 steps as
    :func:`wkv_cost` cuts att: inside one sub-chunk, per pair j < t, 5·D
    for att (difference, exp, two products, sum) and 3·D each for dr and
    dk (the decay shared with att); below the sub-chunks 2·D per pair
    each for att (r~ k~^T), dr (datt k~) and dk (datt^T r~), with the
    factors r~ and k~ as :func:`wkv_cost` counts them, D a step to carry
    dr~ back through r~'s factor and 2·D per row before each later
    sub-chunk to carry dk~ back through k~'s. Per step and per chunk as
    the kernel's phases need: the states' part (r 2^lwp, a D x D product,
    3·D + 2·D·D a step; the reverse scan, 2·D·D); 3·D a step for u in
    att and datt (2·D per pair j <= t); dv (2·D per pair j <= t, 2·D·D
    + 3·D a step for k's decay and G_c); dr and dk's state part, decay
    and u (2·D·D + 5·D and 2·D·D + 6·D a step); dlogw (6·D a step, 2·D·D
    for the state's decay); du (3·D a step)."""
    starts = range(0, q, 16)
    lens = [min(16, q - s0) for s0 in starts]
    pairs_in = sum(n * (n - 1) // 2 for n in lens)
    pairs_lt, pairs_le = q * (q - 1) // 2, q * (q + 1) // 2
    later = q - lens[0]                          # steps past sub-chunk 0
    factors = (3 * d * later + 2 * d * lens[0]   # r~
               + 3 * d * sum(starts)             # k~
               + d * later                       # dr~ back through r~
               + 2 * d * sum(starts))            # dk~ back through k~
    per_chunk = (11 * d * pairs_in + 6 * d * (pairs_lt - pairs_in)
                 + factors + 4 * d * pairs_le
                 + q * (8 * d * d + 29 * d) + 4 * d * d)
    nbytes = 4 * (9 * b * s * h * d + 2 * h * d
                  + state_grad * b * h * d * d)
    return nbytes, b * h * (s // q) * per_chunk, F32_OPS_S


def cost_ms(cost) -> float:
    nbytes, ops, rate = cost
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / rate)


def cost_by(cost) -> str:
    nbytes, ops, rate = cost
    return "bytes" if nbytes / HBM_BYTES_S >= ops / rate else "operations"


def time_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls queued
    behind a sleep kernel, so host launch overhead does not show as device
    idle time between them."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, n_launch: int, reps: int = 3) -> float:
    """Device ms of one ``fn()`` that makes ``n_launch`` launches, the
    median of ``reps``: CUDA events around one call queued behind a sleep
    kernel long enough that the host has queued every launch before the
    first one starts (checked), so the host's launch time does not show.
    One call a sleep: the device's queue of pending launches is finite,
    and a host that fills it waits for the sleep to end. A warm-up call
    first."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(20_000_000 + 400_000 * n_launch)
        marks[1].record()
        t0 = time.perf_counter()
        fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        marks[2].record()
        torch.cuda.synchronize()
        check(host_ms < marks[0].elapsed_time(marks[1]),
              f"{n_launch} launches took {host_ms:.3f} ms to queue, longer "
              "than the sleep ahead of them")
        times.append(marks[1].elapsed_time(marks[2]))
    return statistics.median(times)


def time_auto(torch, fn, budget_ms: float = 40.0, max_reps: int = 20):
    """Device ms of one ``fn()`` after a warm-up, with as many repetitions
    (1 to ``max_reps``) as fit ``budget_ms``."""
    first = time_ms(torch, fn, 1)
    reps = int(min(max_reps, budget_ms // max(first, 1e-3)))
    return time_ms(torch, fn, reps, warm=False) if reps > 1 else first


def library_call(torch, F, spec):
    """One PyTorch call computing the spec's f32 function at its shapes, on
    fresh random tensors; None where no single call does. Padding the
    library call needs (TF SAME pads unevenly) is applied outside it."""
    dev = "cuda"
    k = spec.kind
    rnd = lambda *s: torch.randn(*s, device=dev)  # noqa: E731
    if k in ("conv2d", "depthwise_conv2d", "pool"):
        ih, iw, ic = spec.in_shape[0][-3:]
        oh, ow, oc = spec.out_shape[-3:]
        if k == "pool":
            kh, kw, sh, sw, ph, pw, mode = spec.meta
            dh = dw = 1
        else:
            kh, kw, sh, sw, dh, dw, ph, pw, _ = spec.meta
        if ph < 0:
            return None
        x = rnd(1, ic, ih, iw)
        padh = max(0, (oh - 1) * sh + (kh - 1) * dh + 1 - ih)
        padw = max(0, (ow - 1) * sw + (kw - 1) * dw + 1 - iw)
        pads = (pw, padw - pw, ph, padh - ph)
        if k == "pool":
            if mode == "max":
                xp = F.pad(x, pads, value=-float("inf"))
                return lambda: F.max_pool2d(xp, (kh, kw), (sh, sw))
            if pads[0] != pads[1] or pads[2] != pads[3]:
                return None
            return lambda: F.avg_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                        count_include_pad=False)
        groups = ic if k == "depthwise_conv2d" else 1
        wt = rnd(oc, ic // groups, kh, kw)
        xp = F.pad(x, pads)
        return lambda: F.conv2d(xp, wt, stride=(sh, sw), dilation=(dh, dw),
                                groups=groups)
    if k == "elementwise":
        xs = [rnd(*s) for s in spec.in_shape]
        fn = {"relu": torch.relu, "relu6": F.relu6,
              "sigmoid": torch.sigmoid, "add": torch.add, "mul": torch.mul,
              "sub": torch.sub}.get(spec.meta[0])
        return None if fn is None else (lambda: fn(*xs))
    if k == "concat":
        xs = [rnd(*s) for s in spec.in_shape]
        return lambda: torch.cat(xs, dim=spec.meta[0])
    if k == "matmul":
        kk = spec.in_shape[0][-1]
        a = rnd(_el(spec.in_shape[0]) // kk, kk)
        b = rnd(*spec.in_shape[1])
        return lambda: torch.matmul(a, b)
    if k == "pad":
        x = rnd(*spec.in_shape[0])
        flat = tuple(p for lo_hi in reversed(spec.meta[0]) for p in lo_hi)
        return lambda: F.pad(x, flat)
    if k == "mean":
        x = rnd(*spec.in_shape[0])
        axes = tuple(a % x.dim() for a in spec.meta[0])
        return lambda: x.mean(dim=axes)
    if k == "fully_connected":
        idim = spec.in_shape[0][-1]
        x = rnd(_el(spec.in_shape[0]) // idim, idim)
        wt = rnd(idim, _el(spec.out_shape) * idim // _el(spec.in_shape[0]))
        return lambda: torch.matmul(x, wt)
    if k == "softmax":
        x = rnd(*spec.in_shape[0])
        return lambda: torch.softmax(x, dim=-1)
    return None


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def chain_row(torch, K, spec, label: str):
    """A fused spec's schedule on the card (``arena_ops.chain_schedule``,
    counts from the spec): levels, stages and tiles or chunks per level,
    the grid and the CTAs it puts on an SM, the workspace bytes beside the
    arena (counters, regions and any global slices) and the scratch bytes
    the one-CTA kernel it replaced held (its shared or global scratch, a
    streaming chain's whole window). Logged and returned."""
    s = K.chain_schedule(spec)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    unit = spec.rowlen * (1 if spec.dtype == "i8" else 4) or 1
    row = {"label": label, "kernel": K.kernel_of(spec),
           "stages": len(s.stages), "levels": len(s.levels),
           "stages_per_level": [len(lv) for lv in s.levels],
           "kinds": [sorted({s.stages[j].kind for j in lv})
                     for lv in s.levels],
           "tiles_per_level": [sum(s.items[j] for j in lv)
                               for lv in s.levels],
           "grid": s.grid, "ctas_per_sm": -(-s.grid // sms),
           "barriers": s.n_barriers, "staged_terminal": s.staged,
           "workspace_bytes": K.buffer_plan(spec).gbytes,
           "regions_bytes": s.region_bytes,
           "smem_bytes": K.buffer_plan(spec).smem,
           "parent_scratch_bytes": max(spec.scratch_rows, spec.win_rows)
           * unit}
    log(f"[chain] {label}: {row['kernel']}, {row['stages']} stages in "
        f"{row['levels']} levels {row['stages_per_level']} "
        f"{row['kinds']}, tiles or chunks per level "
        f"{row['tiles_per_level']}, grid {row['grid']} CTAs "
        f"({row['ctas_per_sm']} an SM of {sms}), {row['barriers']} grid "
        f"barriers, workspace {row['workspace_bytes']} B (regions "
        f"{row['regions_bytes']} B) against the one-CTA kernel's scratch "
        f"{row['parent_scratch_bytes']} B, {row['smem_bytes']} B shared")
    return row


def grid_row(torch, K, spec, label: str):
    """A softmax, matmul or pad spec's grid on the card (counts from the
    spec, ``arena_ops.softmax_order``/``softmax_tiling``/``softmax_grid``,
    ``matmul_order``/``fc_tiling``/``fc_grid`` or ``chunk_of``/
    ``chunk_grid``): its order word, tiling, the CTAs it launches and puts
    on an SM, whether they must all be resident, and the workspace and
    shared bytes. Logged as a ``[softmax]``, ``[matmul]`` or ``[pad]`` line
    and returned."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bp = K.buffer_plan(spec)
    if spec.kind == "softmax":
        order, t, grid = (K.softmax_order(spec), K.softmax_tiling(spec),
                          K.softmax_grid(spec))
        shape = "%d x %d" % K._softmax_geometry(spec)
    elif spec.kind == "matmul":
        order, t, grid = (K.matmul_order(spec), K.fc_tiling(spec),
                          K.fc_grid(spec))
        shape = "(%d, %d) x (%d, %d)" % (K._matmul_geometry(spec)[:2]
                                         + K._matmul_geometry(spec)[1:])
    else:
        (t, order), grid = K.chunk_of(spec), K.chunk_grid(spec)
        shape = f"{spec.in_shape[0]} -> {spec.out_shape}"
    row = {"label": label, "kernel": K.kernel_of(spec), "shape": shape,
           "dtype": spec.dtype, "order": order, "tiling": list(t),
           "grid": grid[0], "cooperative": grid[1] > 0,
           "ctas_per_sm": -(-grid[0] // sms),
           "workspace_bytes": bp.gbytes, "smem_bytes": bp.smem}
    log(f"[{spec.kind}] {label}: {row['kernel']} {shape} {spec.dtype}, "
        f"order word {order}, tiling {row['tiling']}, grid {grid[0]} CTAs "
        f"({row['ctas_per_sm']} an SM of {sms}"
        + (", all resident" if grid[1] else "") +
        f"), workspace {bp.gbytes} B, shared {bp.smem} B")
    return row


def compare_program(torch, K, be, cp, label: str, errs, select=None,
                    weights=None, quant=None):
    """Kernel against plain version for every spec of a compiled plan that
    ``select`` picks (default: all), on copies of the arena as the program
    reaches it; the other specs advance the arena through their kernels.
    Returns (specs, the fused chains' ``chain_row``s, specs compared)."""
    specs, ws, descs, state = be.program(cp, None, weights, quant=quant)
    n = 0
    for spec, w, d in zip(specs, ws, descs):
        if select is not None and not select(spec):
            K.apply_op(state, spec, w, d)
            continue
        got = state.clone()
        K.apply_op(got, spec, w, d)
        ref = state.clone()
        K.apply_plain(ref, spec, w)
        torch.cuda.synchronize()
        name = K.kernel_of(spec)
        errs[name] = max(errs.get(name, 0.0), arena_diff(torch, got, ref,
                                                          spec))
        state = ref
        n += 1
    torch.cuda.synchronize()
    chains = [chain_row(torch, K, s, label) for s in specs
              if s.kind == "fused"]
    log(f"[kernels vs plain] {label}: {n} of {len(specs)} specs match")
    return specs, chains, n


def seeded_state(torch, spec, nbytes: int, seed: int = 0):
    """A seeded random arena on the card of ``nbytes`` (flat) or ``nbytes``
    rows (row-blocked): f32 standard normal, int8 uniform. A flat f32
    matmul's b is scaled by 1 / sqrt(k), so its outputs stay near 1 and
    the 1e-4 limit measures the summation, not the operands' size."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if spec.rowlen:
        shape = (nbytes, spec.rowlen)
        return (torch.randn(shape, generator=g) if spec.dtype == "f32" else
                torch.randint(-128, 128, shape, dtype=torch.int8,
                              generator=g)).cuda()
    if spec.dtype != "f32":
        return torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                             generator=g).cuda()
    x = torch.randn(-(-nbytes // 4), generator=g)
    if spec.kind == "matmul":
        k = spec.in_shape[0][-1]
        b0 = spec.in_off[1] // 4
        x[b0:b0 + _el(spec.in_shape[1])] /= k ** 0.5
    return x.view(torch.uint8)[:nbytes].cuda()


def compare_spec(torch, K, spec, nbytes: int, weights, errs, label: str,
                 seed: int = 0):
    """Kernel against plain version on one hand-built spec over a seeded
    random arena of ``nbytes`` (flat) or ``nbytes`` rows (row-blocked)."""
    state = seeded_state(torch, spec, nbytes, seed)
    w = weights
    if spec.kind == "fused":
        w = K.pack_weights(spec, weights, device="cuda")
    elif weights:
        w = weights[0]
    got, ref = state.clone(), state.clone()
    K.apply_op(got, spec, w)
    K.apply_plain(ref, spec, w)
    torch.cuda.synchronize()
    name = K.kernel_of(spec)
    err = arena_diff(torch, got, ref, spec)
    errs[name] = max(errs.get(name, 0.0), err)
    bp = K.buffer_plan(spec)
    log(f"[kernels vs plain] {label}: match (max err {err:g}; global "
        f"buffers: {[n for n, glob, _ in bp.parts if glob] or 'none'})")
    if spec.kind == "fused":
        return chain_row(torch, K, spec, label)


def requests(torch, K, X, cp, label: str, n_launch, peak: int,
             seeds=(0, 1, 2)):
    """Requests through CompiledPlan.execute on the card, each against the
    numpy backend and counted (counts reset just before each; ``n_launch``
    None expects one launch per lowered spec). Returns the launches per
    kernel of one request and the host seconds of the cuda and numpy
    executions."""
    graph = cp.graph
    weights = X.synth_weights(graph, 0)
    quant = X.calibrate(graph, 0, weights) if X.needs_quant(graph) else None
    be = X.get_backend("cuda")
    specs, _, _, arena = be.program(cp, None, weights, quant=quant)
    n_launch = len(specs) if n_launch is None else n_launch
    check(arena.device.type == "cuda" and arena.numel() == peak,
          f"{label}: device arena {arena.numel()} B on {arena.device}, "
          f"expected {peak} B on the card")
    per_request, t_cuda, t_np = None, 0.0, 0.0
    for seed in seeds:
        inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
                  else X.random_inputs(graph, seed))
        K.reset_launches()
        t0 = time.perf_counter()
        got = cp.execute(inputs, weights, quant=quant)
        t_cuda += time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        ref = X.get_backend("numpy").execute(cp, inputs, weights, quant=quant)
        t_np += time.perf_counter() - t0
        X.compare_outputs(ref, got, exact=False, label=f"{label} seed {seed}")
        for k, v in got.items():
            check(bool(np.isfinite(v.astype(np.float64)).all()),
                  f"{label}: non-finite output {k}")
        check(sum(counts.values()) == n_launch,
              f"{label}: {sum(counts.values())} launches, expected "
              f"{n_launch}: {counts}")
        check(per_request is None or counts == per_request,
              f"{label}: launches differ between requests")
        per_request = counts
    log(f"[slice] {label}: {len(seeds)} requests match numpy, {n_launch} "
        f"launches each, device arena {peak} B (execute {t_cuda:.2f} s, "
        f"numpy {t_np:.2f} s)")
    return per_request, t_cuda, t_np


def blocked_requests(torch, K, X, cp, label: str, nbytes=None,
                     seeds=(0,)):
    """Requests through ``get_backend("cuda", layout="blocks")`` on the
    card, counted (counts reset just before each), each bit-equal to the
    flat program's outputs on the same inputs and within
    ``compare_outputs`` of the numpy backend. The typed device arena must
    be ``total_rows x arena_rowlen`` elements (``nbytes`` where given).
    Returns the launches per kernel of one request, the arena bytes and the
    host seconds of the blocked and the flat executions."""
    graph = cp.graph
    weights = X.synth_weights(graph, 0)
    quant = X.calibrate(graph, 0, weights) if X.needs_quant(graph) else None
    be = X.get_backend("cuda", layout="blocks")
    flat = X.get_backend("cuda")
    bp = be.legalised(cp.plan)
    specs, _, _, arena = be.program(cp, None, weights, quant=quant)
    got_bytes = arena.numel() * arena.element_size()
    check(arena.is_cuda and tuple(arena.shape) == (bp.total_rows,
                                                   bp.arena_rowlen)
          and got_bytes == bp.padded_peak_bytes,
          f"{label}: blocked arena {tuple(arena.shape)} {arena.dtype} on "
          f"{arena.device}, expected ({bp.total_rows}, {bp.arena_rowlen})")
    check(nbytes is None or got_bytes == nbytes,
          f"{label}: blocked arena {got_bytes} B, expected {nbytes} B")
    per_request, t_blk, t_flat = None, 0.0, 0.0
    for seed in seeds:
        inputs = (X.quant_inputs(graph, quant, seed) if quant is not None
                  else X.random_inputs(graph, seed))
        K.reset_launches()
        t0 = time.perf_counter()
        got = be.execute(cp, inputs, weights, quant=quant)
        t_blk += time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        want = flat.execute(cp, inputs, weights, quant=quant)
        t_flat += time.perf_counter() - t0
        check(got.keys() == want.keys() and all(
            np.array_equal(got[k], want[k]) for k in want),
            f"{label} seed {seed}: blocked outputs differ from flat")
        X.compare_outputs(X.get_backend("numpy").execute(
            cp, inputs, weights, quant=quant), got, exact=False,
            label=f"{label} blocks seed {seed}")
        want_counts = {n: sum(K.KERNEL_OF[s.kind] == n for s in specs)
                       for n in K.LAUNCHES}
        check(counts == want_counts, f"{label}: blocked launches {counts}, "
              f"expected {want_counts}")
        per_request = counts
    log(f"[blocks] {label}: {len(seeds)} request(s) bit-equal to flat and "
        f"within tolerance of numpy, {len(specs)} launches, {bp.packing} "
        f"arena {bp.total_rows} x {bp.arena_rowlen} = {got_bytes} B "
        f"(flat {cp.peak_bytes} B; execute {t_blk:.2f} s, flat "
        f"{t_flat:.2f} s)")
    return per_request, got_bytes, t_blk, t_flat


def run_arena(K, ex, cp, inputs, weights, quant):
    """The final device arena of one run of ``ex``'s program."""
    specs, ws, descs, arena = ex.program(cp, inputs, weights, quant=quant)
    for spec, w, d in zip(specs, ws, descs):
        K.apply_op(arena, spec, w, d)
    return arena


def largest_window(K, ex, cp):
    """(bytes, op name, "shared", "global" or "in place", windows staged
    in global memory, windows staged in shared memory, specs) of the
    streaming plan: its largest resident window and where the card stages
    it (a rolling op's row tiles' footprints, each its part of the window;
    every staged op and a fused chain run in place and stage nothing)."""
    bp = ex.legalised(cp.plan)
    sched = bp.window_schedule()
    specs = ex.program(cp)[0]
    place = ["in place" if K.stream_form(spec) != "roll"
             else "global" if K.buffer_plan(spec).on_global("tile")
             else "shared" for spec in specs]
    i = max(range(len(specs)),
            key=lambda j: sched.windows[j].resident_rows)
    return (sched.windows[i].resident_rows * sched.row_bytes,
            sched.windows[i].op_name, place[i], place.count("global"),
            place.count("shared"), specs)


def streamed_requests(torch, K, X, cp, label: str, n_launch=None):
    """One request through ``get_backend("cuda", mode="streaming")
    .execute()`` on the card, launch counts reset just before: every
    launch is a streaming kernel, one per spec (``n_launch`` where given);
    outputs bit-equal to the blocked route's and within ``compare_outputs``
    of the numpy backend. Then the final device arenas of both programs on
    the same inputs must be equal, element for element. Returns the
    launches per kernel and the host seconds of the two executions."""
    graph = cp.graph
    weights = X.synth_weights(graph, 0)
    quant = X.calibrate(graph, 0, weights) if X.needs_quant(graph) else None
    inputs = (X.quant_inputs(graph, quant, 0) if quant is not None
              else X.random_inputs(graph, 0))
    st = X.get_backend("cuda", mode="streaming")
    blk = X.get_backend("cuda", layout="blocks")
    specs = st.program(cp, inputs, weights, quant=quant)[0]
    K.reset_launches()
    t0 = time.perf_counter()
    got = st.execute(cp, inputs, weights, quant=quant)
    t_st = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    want = blk.execute(cp, inputs, weights, quant=quant)
    t_blk = time.perf_counter() - t0
    want_counts = {n: sum(K.kernel_of(s) == n for s in specs)
                   for n in K.LAUNCHES}
    check(counts == want_counts and all(
        n.startswith("arena_stream") for n, v in counts.items() if v),
        f"{label}: streaming launches {counts}, expected {want_counts}")
    check(n_launch is None or sum(counts.values()) == n_launch,
          f"{label}: {sum(counts.values())} launches, expected {n_launch}")
    check(got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want),
        f"{label}: streaming outputs differ from blocked")
    X.compare_outputs(X.get_backend("numpy").execute(
        cp, inputs, weights, quant=quant), got, exact=False,
        label=f"{label} streaming")
    a = run_arena(K, st, cp, inputs, weights, quant)
    b = run_arena(K, blk, cp, inputs, weights, quant)
    torch.cuda.synchronize()
    check(a.is_cuda and torch.equal(a, b),
          f"{label}: final streaming arena differs from the blocked one")
    return counts, t_st, t_blk


def repeat_forwards(torch, K, X, cp, label: str, ex, kernel: str,
                    n: int = 5):
    """``n`` forwards of ``cp`` on the card through ``ex``'s program on the
    same inputs; every final device arena must equal the first, byte for
    byte. Returns the tile kernel ``kernel``'s (``arena_conv`` or
    ``arena_stream_roll``) order modes, tiles a spec, largest tile
    footprint in shared memory and the workspace bytes its specs hold
    (counters and any staging slices: the device memory it adds to the
    arena)."""
    graph = cp.graph
    weights = X.synth_weights(graph, 0)
    quant = X.calibrate(graph, 0, weights) if X.needs_quant(graph) else None
    inputs = (X.quant_inputs(graph, quant, 0) if quant is not None
              else X.random_inputs(graph, 0))
    first = None
    for _ in range(n):
        arena = run_arena(K, ex, cp, inputs, weights, quant)
        torch.cuda.synchronize()
        if first is None:
            first = arena
        check(torch.equal(arena, first),
              f"{label}: repeated forwards give different arenas")
    convs = [s for s in ex.program(cp)[0] if K.kernel_of(s) == kernel]
    tiles = [K.conv_tiling(s).ntiles for s in convs]
    row = {"forwards": n, "kernel": kernel,
           "arena_bytes": first.numel() * first.element_size(),
           "modes": [sum(K.conv_order(s) == m for s in convs)
                     for m in (K.ORDER_DISJOINT, K.ORDER_STAGED,
                               K.ORDER_ROWS)],
           "tiles_min": min(tiles), "tiles_max": max(tiles),
           "max_tile_smem": max(K.buffer_plan(s).smem for s in convs),
           "workspace_bytes": sum(K.buffer_plan(s).gbytes for s in convs)}
    log(f"[repeats] {label}: {n} forwards, final arenas identical "
        f"({row['arena_bytes']} B); {kernel}: {len(convs)} specs, order "
        f"modes (disjoint, staged, rows) {row['modes']}, {min(tiles)}-"
        f"{max(tiles)} tiles a spec, up to {row['max_tile_smem']} B of "
        f"shared memory a CTA (footprint and filter chunks), counters "
        f"and slices {row['workspace_bytes']} B of device memory beside "
        f"the arena")
    return row


def ew_rows(K, ex, cp, label: str):
    """The elementwise grid body's specs of ``ex``'s program of ``cp``
    (``arena_elementwise``, and ``arena_stream_stage``'s elementwise
    bodies; the other staged specs beside them): per spec its order word,
    units, grid arguments and the workspace and shared bytes its buffers
    take, and a count of each order word. Counts from the specs
    (``arena_ops.ew_order``, ``ew_tiling``, ``buffer_plan``)."""
    specs = [s for s in ex.program(cp)[0]
             if K.kernel_of(s) in ("arena_elementwise", "arena_stream_stage")]
    rows = []
    for s in specs:
        bp = K.buffer_plan(s)
        grid = (K.chunk_grid(s) if K.runs_chunk_walk(s) else
                K.fc_grid(s) if K.runs_product_grid(s) else
                K.softmax_grid(s) if K.runs_softmax_grid(s) else (1, 0, 0))
        row = {"kernel": K.kernel_of(s), "fn": s.meta[0] if
               s.kind == "elementwise" else s.kind, "grid": list(grid),
               "smem_bytes": bp.smem, "workspace_bytes": bp.gbytes}
        if K.runs_ew_grid(s):
            row.update(order=K.ew_order(s), tiling=list(K.ew_tiling(s)))
        rows.append(row)
    ew = [r for r in rows if "order" in r]
    out = {"specs": rows,
           "orders": [sum(r["order"] == m for r in ew)
                      for m in (K.EW_DISJOINT, K.EW_ALIGNED, K.EW_OVERLAP)],
           "vector_specs": sum(r["tiling"][0] > 1 for r in ew),
           "workspace_bytes": sum(r["workspace_bytes"] for r in rows)}
    log(f"[repeats] {label}: {len(ew)} elementwise grid specs, order words "
        f"(disjoint, aligned, overlap) {out['orders']}, {out['vector_specs']}"
        f" in 16-byte units, grids "
        f"{min((r['grid'][0] for r in ew), default=0)}-"
        f"{max((r['grid'][0] for r in ew), default=0)} CTAs; "
        f"{len(rows) - len(ew)} other staged specs; workspace "
        f"{out['workspace_bytes']} B beside the arena: "
        + json.dumps([[r["fn"], r.get("order"), r["grid"][0],
                       r["workspace_bytes"]] for r in rows]))
    return out


def head_rows(K, ex, cp, label: str):
    """The pool, fully connected, concat and mean specs of ``ex``'s program
    of ``cp`` (``arena_pool`` and ``arena_stream_roll``'s pools on row
    tiles; ``arena_fully_connected`` and ``arena_stream_stage``'s FC on
    column blocks x K slices; ``arena_concat``, ``arena_mean`` and
    ``arena_stream_stage``'s concats and means on chunks of units): per
    spec its kernel, order word, tiles, items or units, grid arguments and
    the workspace and shared bytes its buffers take. Counts from the specs
    (``arena_ops.conv_order``, ``conv_tiling``, ``fc_order``,
    ``fc_tiling``, ``chunk_of``, ``buffer_plan``)."""
    rows = []
    for s in ex.program(cp)[0]:
        if s.kind not in ("pool", "fully_connected", "concat", "mean"):
            continue
        bp = K.buffer_plan(s)
        row = {"kernel": K.kernel_of(s), "kind": s.kind,
               "smem_bytes": bp.smem, "workspace_bytes": bp.gbytes}
        if s.kind == "pool":
            row.update(order=K.conv_order(s),
                       grid=list(K.conv_grid(s)),
                       tiles=K.conv_tiling(s).ntiles,
                       tiling=list(K.conv_tiling(s)))
        elif s.kind == "fully_connected":
            row.update(order=K.fc_order(s), grid=list(K.fc_grid(s)),
                       tiles=K.fc_tiling(s).ctas,
                       tiling=list(K.fc_tiling(s)))
        else:
            t, order = K.chunk_of(s)
            row.update(order=order, grid=list(K.chunk_grid(s)),
                       tiles=t.units, tiling=list(t))
        rows.append(row)
    log(f"[repeats] {label}: pool, fully connected, concat and mean specs "
        f"[kernel, kind, order word, CTAs at most, CTAs at once, tiles, "
        f"items or units, workspace B, shared B]: "
        + json.dumps([[r["kernel"], r["kind"], r["order"], r["grid"][0],
                       r["grid"][1], r["tiles"], r["workspace_bytes"],
                       r["smem_bytes"]] for r in rows]))
    return rows


def refused(fn, label: str, exc=ValueError) -> str:
    """Run ``fn``; it must raise ``exc`` (a ValueError: a graph no backend
    executes). Returns the message."""
    try:
        fn()
    except exc as e:
        return str(e).splitlines()[0]
    raise SmokeError(f"{label}: expected a {exc.__name__}")


def close_err(torch, got, want, tol, label: str) -> float:
    """Max |got - want|; raises unless every value is finite and within
    ``atol + rtol * |want|`` (the reference's assert_allclose), where
    ``tol`` is ``(atol, rtol)`` or one number for both."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    g, w = got.float(), want.float()
    check(g.shape == w.shape, f"{label}: shape {tuple(g.shape)} against "
          f"{tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite values")
    diff = (g - w).abs()
    err = diff.max().item()
    check(bool((diff <= atol + rtol * w.abs()).all()),
          f"{label}: max |err| {err:g} outside atol {atol:g}, rtol "
          f"{rtol:g}")
    return err


def grads_close(torch, got, want, tol, label: str,
                names=("dq", "dk", "dv")) -> float:
    """A backward's gradients (the flash backward's dq, dk, dv) against
    the plain version's, each within ``(atol, rtol)`` with atol scaled by
    the largest entry of the plain version's tensor. Returns the largest
    |error|."""
    atol, rtol = tol
    return max(close_err(torch, g, w, (atol * w.float().abs().max().item(),
                                       rtol), f"{label} {name}")
               for name, g, w in zip(names, got, want))


#: the WKV backward's gradients, in its return order
WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du")


def plain_wkv(torch):
    """``wkv_chunk.wkv_chunk_kernel``'s signature with the WKV from the
    plain versions called directly: the forward ``wkv_plain``, the
    backward ``wkv_backward_plain``. The train phase's RWKV gradient check
    puts it in the model's place for one loss."""
    from repro_torch.kernels import wkv_chunk as TW

    class PlainWkv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u, q):
            ctx.save_for_backward(r, k, v, logw, u)
            ctx.q = q
            return TW.wkv_plain(r, k, v, logw, u, q)

        @staticmethod
        def backward(ctx, dy, dstate):
            return (*TW.wkv_backward_plain(*ctx.saved_tensors, dy, dstate,
                                           ctx.q), None)

    def wkv(r, k, v, logw, u, q=64, device=None):
        return PlainWkv.apply(r, k, v, logw, u, q)
    return wkv


def plain_attention(torch):
    """``ops.flash_attention``'s signature with its gradient from the plain
    versions, called directly: the forward ``flash_plain_lse``, the
    backward ``flash_backward_plain``. The train phase's gradient check
    puts it in the model's place for one loss."""
    from repro_torch.kernels import flash_attention as TF

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = TF.flash_plain_lse(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            return (*TF.flash_backward_plain(q, k, v, out, do.contiguous(),
                                             lse, ctx.causal), None)

    def attend(q, k, v, causal=True, block_q=128, block_k=128, device=None):
        return PlainFlash.apply(q, k, v, causal)
    return attend


def sdpa_backward_ms(torch, F, q, k, v, do) -> dict:
    """SDPA's backward at (1, H, S, D) copies of (S, H, D) inputs, causal:
    a timed ``torch.autograd.grad`` of its forward minus the forward
    (grad enabled), TF32 off. The port never calls it."""
    qh, kh, vh = (a.detach().permute(1, 0, 2)[None].contiguous()
                  .requires_grad_() for a in (q, k, v))
    doh = do.permute(1, 0, 2)[None].contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    fwd_ms = time_auto(torch, fwd)
    both_ms = time_auto(torch, lambda: torch.autograd.grad(
        fwd(), (qh, kh, vh), doh))
    return {"library_ms": both_ms - fwd_ms, "library_fwd_bwd_ms": both_ms,
            "library_fwd_ms": fwd_ms}


def flash_bwd_standalone(torch, F, normal) -> tuple:
    """The standalone phase's backward row: causal S = T = 4096, 16 heads
    of 128, f32 and bf16, and the f32 reduced training width
    (``FLASH_BWD_REDUCED``: 32 heads of 32). The main path:
    ``ops.flash_attention`` under autograd once per case, the counts reset
    just before (one forward and one backward call each). Then each
    backward against ``flash_backward_plain`` on the forward's own output
    and lse, a second call bit-equal, and its device ms beside the plain
    version, its bound and SDPA's backward. The bf16 body's two wgmma
    kernels (both slab counts) and the f32 body's pre-pass and one pass
    (each W) have no stack frame or spills (``-Xptxas -v``). Returns (row,
    section)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops as TO
    res = build.ptxas_resources("flash_attention_bwd")
    wg = {fn: r for fn, r in res.items()
          if "bwd_dq_wg" in fn or "bwd_dkv_wg" in fn}
    f32 = {fn: r for fn, r in res.items() if "flash_bwd_f32" in fn}
    check(len(wg) == 4, f"flash_attention_bwd: {len(wg)} wgmma kernels in "
          f"the ptxas report")
    check(len(f32) == 4, f"flash_attention_bwd: {len(f32)} f32 kernels in "
          f"the ptxas report")
    for fn, r in {**wg, **f32}.items():
        check(r["stack"] == r["spill_stores"] == r["spill_loads"] == 0
              and r["registers"] > 0, f"flash_attention_bwd {fn}: {r}")
    log(f"[standalone] flash_attention_bwd ptxas: {json.dumps(res)}")
    fs, ft, fh, fd = FLASH_FULL
    rs, rt, rh, rd = FLASH_BWD_REDUCED
    cases = {"f32": (torch.float32, FLASH_FULL),
             "bf16": (torch.bfloat16, FLASH_FULL),
             "f32 reduced": (torch.float32, FLASH_BWD_REDUCED)}
    ins = {dt: [normal(n, h, d, dtype=ty) for n in (s, t, t, s)]
           for dt, (ty, (s, t, h, d)) in cases.items()}
    torch.cuda.synchronize()
    TF.reset_launches()
    grads = {}
    for dt in cases:
        q, k, v, do = ins[dt]
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        grads[dt] = torch.autograd.grad(TO.flash_attention(*leaves), leaves,
                                        do)
    torch.cuda.synchronize()
    launches = {"flash_attention": TF.LAUNCHES,
                "flash_attention_bwd": TF.BWD_LAUNCHES}
    check(launches == {"flash_attention": len(cases), "flash_attention_bwd":
                       len(cases) * TF.BWD_KERNELS_PER_CALL},
          f"flash backward: launches {launches}")
    errs, timing = {}, {}
    for dt, (ty, (s, t, h, d)) in cases.items():
        q, k, v, do = ins[dt]
        out, lse = TF._forward(q, k, v, True, 128, 128, True)
        want = TF.flash_backward_plain(q, k, v, out, do, lse, True)
        label = f"flash backward {dt} ({s}, {t}, {h}, {d})"
        errs[dt] = grads_close(torch, grads[dt], want,
                               FLASH_BWD_TOL[dt.split()[0]], label)
        again = TF.flash_backward_kernel(q, k, v, out, do, lse, True)
        check(all(bool(torch.equal(a, b)) for a, b in zip(again, grads[dt])),
              f"{label}: a second call is not bit-equal to the first")
        del want, again
        cost = attention_bwd_cost(s, t, h, d, True, q.element_size())
        timing[dt] = {
            "ms": time_auto(torch, lambda: TF.flash_backward_kernel(
                q, k, v, out, do, lse, True)),
            "plain_ms": time_ms(torch, lambda: TF.flash_backward_plain(
                q, k, v, out, do, lse, True), 1),
            **sdpa_backward_ms(torch, F, q, k, v, do),
            "bound_ms": cost_ms(cost), "bound_by": cost_by(cost)}
    source, replaces = KERNELS["flash_attention_bwd"]
    row = {"name": "flash_attention_bwd", "route": "cuda", "source": source,
           "replaces": replaces,
           "path": f"qwen2.5-3b width: causal S = T = {fs}, {fh} heads of "
                   f"{fd}, f32; the backward of ops.flash_attention under "
                   f"autograd, {TF.BWD_KERNELS_PER_CALL} launches a call",
           "launches": launches["flash_attention_bwd"],
           "max_abs_err": errs["f32"], **timing["f32"],
           "bf16": dict(timing["bf16"], max_abs_err=errs["bf16"]),
           "f32_reduced": dict(timing["f32 reduced"],
                               max_abs_err=errs["f32 reduced"],
                               shape=[rs, rt, rh, rd])}
    section = {"launches": launches, "errors": errs, "times": timing,
               "bit_equal_repeat": True, "ptxas": res}
    log(f"[standalone] flash backward at full width and the f32 reduced "
        f"width {FLASH_BWD_REDUCED}: launches {launches}, against plain "
        f"{json.dumps(errs)}, a second call bit-equal; times (ms) "
        f"{json.dumps(timing)}")
    return row, section


def wkv_bwd_standalone(torch, normal, wkv_inputs, one_float_in) -> tuple:
    """The standalone phase's WKV backward row: no stack frame or spills
    in its four kernels (``-Xptxas -v``); each launch's CTAs an SM and
    warps an SM (``wkv_chunk.bwd_occupancy``), C' at least
    ``WKV_BWD_MIN_WARPS``; on ``WKV_CASES``, strong decays, inputs one
    float into their storage (no state gradient there) and
    ``WKV_BWD_SUB``, ``wkv_backward_kernel`` on the forward kernel's
    workspace against ``wkv_backward_plain`` (``WKV_BWD_TOL``). The main
    path at full width
    (``WKV_FULL``): ``wkv_chunk_kernel`` under autograd once, the counts
    reset just before (three forward and four backward launches), its
    gradients for a random dy and state gradient against the plain
    version, a second call bit-equal, and its device ms beside the plain
    version and its bound (no PyTorch call computes it). Returns (row,
    section)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv_chunk as TW
    res = build.ptxas_resources("wkv_chunk_bwd")
    check(len(res) >= TW.BWD_KERNELS_PER_CALL,
          f"wkv_chunk_bwd: {len(res)} entry functions in the ptxas report")
    for fn, r in res.items():
        check(r["stack"] == r["spill_stores"] == r["spill_loads"] == 0
              and r["registers"] > 0, f"wkv_chunk_bwd {fn}: {r}")
    log(f"[standalone] wkv_chunk_bwd ptxas: {json.dumps(res)}")
    occ = TW.bwd_occupancy()
    log("[standalone] wkv_chunk_bwd CTAs an SM: " + ", ".join(
        f"{name} {o['ctas_an_sm']} of {o['threads']} threads "
        f"({o['warps_an_sm']} warps)" for name, o in occ.items()))
    check(occ["chunk_grads"]["warps_an_sm"] >= WKV_BWD_MIN_WARPS
          and all(o["ctas_an_sm"] >= 1 for o in occ.values()),
          f"wkv_chunk_bwd: occupancy {occ}")
    err = 0.0
    for (b, s, h, d, qc), shift, skew in (
            [((2, *c), 0.0, False) for c in WKV_CASES]
            + [((2, *c), 3.0, False) for c in WKV_STRONG]
            + [((2, *c), 0.0, True) for c in WKV_UNALIGNED]
            + [(c[:5], c[5], False) for c in WKV_BWD_SUB]):
        r, k, v, logw, _, u = wkv_inputs(b, s, h, d, shift)
        dy, dst = normal(b, s, h, d), None if skew else normal(b, h, d, d)
        if skew:
            r, k, v, logw, dy = (one_float_in(t) for t in (r, k, v, logw, dy))
            check(r.data_ptr() % 16 != 0, "wkv: the skewed input is aligned")
        _, _, ws = TW.wkv_forward_saved(r, k, v, logw, u, qc)
        got = TW.wkv_backward_kernel(r, k, v, logw, u, dy, dst, qc, ws)
        label = (f"wkv backward ({b}, {s}, {h}, {d}, q={qc}"
                 f"{', strong decay' if shift else ''}"
                 f"{', one float into storage, no state gradient' if skew else ''})")
        err = max(err, grads_close(
            torch, got, TW.wkv_backward_plain(r, k, v, logw, u, dy, dst, qc),
            WKV_BWD_TOL, label, WKV_GRADS))
    wb, sq, wh, wd, wq = WKV_FULL
    r, k, v, logw, _, u = wkv_inputs(wb, sq, wh, wd)
    dy, dst = normal(wb, sq, wh, wd), normal(wb, wh, wd, wd)
    torch.cuda.synchronize()
    TW.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
    y, st = TW.wkv_chunk_kernel(*leaves, q=wq)
    grads = torch.autograd.grad((y, st), leaves, (dy, dst))
    torch.cuda.synchronize()
    launches = {"wkv_chunk": TW.LAUNCHES, "wkv_chunk_bwd": TW.BWD_LAUNCHES}
    check(launches == {"wkv_chunk": TW.KERNELS_PER_CALL,
                       "wkv_chunk_bwd": TW.BWD_KERNELS_PER_CALL},
          f"wkv backward full width: launches {launches}")
    del leaves, y, st
    full_err = grads_close(
        torch, grads, TW.wkv_backward_plain(r, k, v, logw, u, dy, dst, wq),
        WKV_BWD_TOL, "wkv backward full width", WKV_GRADS)
    _, _, saved = TW.wkv_forward_saved(r, k, v, logw, u, wq)
    again = TW.wkv_backward_kernel(r, k, v, logw, u, dy, dst, wq, saved)
    check(all(bool(torch.equal(a, b)) for a, b in zip(again, grads)),
          "wkv backward full width: a second call is not bit-equal to the "
          "first")
    del again, grads
    cost = wkv_bwd_cost(wb, sq, wh, wd, wq)
    timing = {
        "ms": time_auto(torch, lambda: TW.wkv_backward_kernel(
            r, k, v, logw, u, dy, dst, wq, saved)),
        "plain_ms": time_ms(torch, lambda: TW.wkv_backward_plain(
            r, k, v, logw, u, dy, dst, wq), 1),
        "library_ms": None, "bound_ms": cost_ms(cost),
        "bound_by": cost_by(cost)}
    source, replaces = KERNELS["wkv_chunk_bwd"]
    row = {"name": "wkv_chunk_bwd", "route": "cuda", "source": source,
           "replaces": replaces,
           "path": f"rwkv6-1.6b width: B {wb}, S {sq}, {wh} heads of {wd}, "
                   f"q {wq}, f32; the backward of wkv_chunk_kernel under "
                   f"autograd, {TW.BWD_KERNELS_PER_CALL} launches a call",
           "launches": launches["wkv_chunk_bwd"],
           "max_abs_err": max(err, full_err), **timing}
    section = {"launches": launches,
               "errors": {"reference_shapes": err, "full_width": full_err},
               "times": timing, "ptxas": res, "occupancy": occ,
               "bit_equal_repeat": True,
               "workspace_bytes": 4 * TW.workspace_floats(wb, sq, wh, wd,
                                                          wq)}
    log(f"[standalone] wkv backward: launches {launches}, against plain "
        f"{json.dumps(section['errors'])}, a second call bit-equal; times "
        f"(ms) {json.dumps(timing)}")
    return row, section


def wkv_sequential(torch, r, k, v, w, u):
    """The WKV recurrence one step at a time, as the reference's
    ``models/ssm.py::_rwkv_step``: returns (y (B, S, H, D), state)."""
    b, s, h, d = r.shape
    st = torch.zeros((b, h, d, d), device=r.device)
    ys = []
    for i in range(s):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, i],
                               st + u[:, :, None] * kv))
        st = w[:, i, :, :, None] * st + kv
    return torch.stack(ys, 1), st


def serve_loop(torch, K, X, srv, label: str, n: int, tail: int,
               seed0: int = 0) -> dict:
    """A closed loop of ``n`` float requests (seeds ``seed0`` on), each
    submitted then ``step()``ped, then a ``tail`` drained by forced
    flushes. Every flush runs with the launch counts reset just before and
    read just after: one launch a spec of its variant, kernel for kernel,
    and a device arena of exactly the variant's ``peak_bytes``. Every
    request's output must be within ``compare_outputs`` of ``FastExec.run``
    on that request alone. Returns the server's stats, its flushes and the
    seconds the loop took."""
    graph = srv.graph
    imgs = [X.random_inputs(graph, seed=seed0 + i) for i in range(n + tail)]
    want = {}
    for b, cp in srv.variants.items():
        specs = srv._runner.program(cp, None, srv.params[b][0],
                                    quant=srv.params[b][1])[0]
        want[b] = {name: sum(K.kernel_of(sp) == name for sp in specs)
                   for name in K.LAUNCHES}

    def flush(force: bool) -> int:
        K.reset_launches()
        served = srv.step(force=force)
        counts = dict(K.LAUNCHES)
        if served:
            f = srv.flushes[-1]
            check(counts == want[f.batch] and sum(counts.values()) == f.specs,
                  f"{label}: batch {f.batch} flush launched {counts}, "
                  f"expected {want[f.batch]}")
            check(f.arena_bytes == srv.variants[f.batch].peak_bytes,
                  f"{label}: batch {f.batch} flush arena {f.arena_bytes} B, "
                  f"expected {srv.variants[f.batch].peak_bytes} B")
        else:
            check(not any(counts.values()), f"{label}: launches without a "
                  "flush")
        return served

    t0 = time.perf_counter()
    for im in imgs[:n]:
        srv.submit(im)
        flush(False)
    for im in imgs[n:]:
        srv.submit(im)
    while srv.queue:
        flush(True)
    loop_s = time.perf_counter() - t0
    check(len(srv.done) == n + tail, f"{label}: served {len(srv.done)} of "
          f"{n + tail}")
    for r in srv.done:
        got = r.output
        ref = srv._exec.run({k: v[None] for k, v in imgs[r.rid].items()})
        X.compare_outputs({k: v[0] for k, v in ref.items()}, got,
                          exact=False, label=f"{label} request {r.rid}")
        for k, v in got.items():
            check(bool(np.isfinite(v.astype(np.float64)).all()),
                  f"{label}: non-finite output {k}")
    # each flush's (assembly start, execute start, done), ms from the
    # first submit: where the loop's time goes beside execute
    timeline = sorted({tuple(1e3 * (t - srv._t0) for t in
                             (r.t_batch, r.t_exec0, r.t_done))
                       for r in srv.done})
    return {"stats": srv.stats(), "loop_s": loop_s, "timeline_ms": timeline,
            "assemble_s": sum(e - a for a, e, _ in timeline) / 1e3,
            "flushes": [dataclasses.asdict(f) for f in srv.flushes]}


def serve_phase(torch, K, X, zoo) -> dict:
    """The plan-routed serving runtime on the card: three servers over the
    flagship's batch variants, every flush one variant's flat arena program
    through the kernels (``PlanServer`` with no device). Server A: int8 at
    batches 1, 2, 4, 8, no budget; Server B: the same with a 200,000 B
    budget, which must reject batch 8; Server C: the f32 flagship at
    batches 1, 2, 4; and a server over A's variants without batch 1, whose
    odd tail forces a padded flush. Every spec of every variant is held
    against its plain version at the server's calibration
    (``compare_program``); each batch's median ``execute_s`` (host: upload,
    kernels, download) beside the device ms of one flush's launches (CUDA
    events, ``queued_ms``). ``[serve]`` lines per server."""
    from repro_torch.serve import PlanServer
    out = {"servers": {}, "errors": {}}
    flag = zoo.mobilenet_v1(0.25, 128, 1)
    servers = (
        ("A int8", flag, dict(batches=(1, 2, 4, 8))),
        ("B int8 budget", flag, dict(batches=(1, 2, 4, 8),
                                     arena_budget=SERVE_BUDGET)),
        ("C f32", zoo.mobilenet_v1(0.25, 128, 4), dict(batches=(1, 2, 4))))
    for i, (label, graph, kw) in enumerate(servers):
        srv = PlanServer(graph, max_delay_s=10.0, **kw)
        check(srv.device.type == "cuda", f"{label}: server on {srv.device}")
        peaks = srv.stats()["per_batch_peak_bytes"]
        if label.startswith(("A", "B")):
            check(all(peaks[b] == SERVE_PEAKS[b] for b in peaks),
                  f"{label}: peaks {peaks}, expected {SERVE_PEAKS}")
        if label.startswith("B"):
            check(sorted(srv.variants) == [1, 2, 4]
                  and srv.rejected == {8: SERVE_PEAKS[8]},
                  f"{label}: admitted {sorted(srv.variants)}, rejected "
                  f"{srv.rejected}")
        errs = out["errors"].setdefault(label, {})
        n_specs = {}
        for b, cp in srv.variants.items():
            w, q = srv.params[b]
            _, _, n_specs[b] = compare_program(
                torch, K, srv._runner, cp, f"serve {label} batch {b}", errs,
                weights=w, quant=q)
        row = serve_loop(torch, K, X, srv, label, SERVE_REQUESTS,
                         SERVE_TAIL, seed0=1000 * i)
        st = row["stats"]
        check(all(st["batches_run"][b] > 0 for b in srv.variants),
              f"{label}: a variant never flushed: {st['batches_run']}")
        per_batch = {}
        for b, cp in srv.variants.items():
            w, q = srv.params[b]
            inputs = srv._stack([srv.done[0]] * b, b)
            specs, ws, descs, arena = srv._runner.program(cp, inputs, w,
                                                          quant=q)
            check(len(specs) == n_specs[b], f"{label}: batch {b} specs")

            def run(specs=specs, ws=ws, descs=descs, arena=arena):
                for sp, wt, d in zip(specs, ws, descs):
                    K.apply_op(arena, sp, wt, d)
            ex_s = [f["execute_s"] for f in row["flushes"]
                    if f["batch"] == b]
            per_batch[b] = {
                "peak_bytes": cp.peak_bytes, "launches": len(specs),
                "flushes": len(ex_s),
                "median_execute_ms": 1e3 * statistics.median(ex_s),
                "max_execute_ms": 1e3 * max(ex_s),
                "kernel_ms": queued_ms(torch, run, len(specs))}
        row["per_batch"] = per_batch
        out["servers"][label] = row
        log(f"[serve] {label}: variants {sorted(srv.variants)} peaks "
            f"{json.dumps(peaks)} rejected {json.dumps(st['rejected_batches'])}"
            f" batches_run {json.dumps(st['batches_run'])}; "
            f"{st['requests_served']} requests within tolerance of FastExec; "
            f"{st['throughput_inf_s']} inf/s, mean queue wait "
            f"{st['mean_queue_wait_ms']} ms; max err vs plain "
            f"{json.dumps(errs)}")
        row["execute_s"] = sum(f["execute_s"] for f in row["flushes"])
        log(f"[serve] {label}: the loop {1e3 * row['loop_s']:.3f} ms, "
            f"flushes' execute {1e3 * row['execute_s']:.3f} ms, assembly "
            f"{1e3 * row['assemble_s']:.3f} ms; flushes (ms from the first "
            "submit: assembly, execute, done) " + json.dumps(
                [[round(t, 3) for t in f] for f in row["timeline_ms"]]))
        for b, r in per_batch.items():
            log(f"[serve] {label} batch {b}: arena {r['peak_bytes']} B, "
                f"{r['launches']} launches, execute median "
                f"{r['median_execute_ms']:.3f} ms (max "
                f"{r['max_execute_ms']:.3f}) over {r['flushes']} "
                f"flush(es), kernels {r['kernel_ms']:.4f} ms a flush")
    label = "A int8 padded tail"
    srv = PlanServer(flag, batches=(2, 4, 8), max_delay_s=10.0)
    row = serve_loop(torch, K, X, srv, label, 0, 3, seed0=5000)
    padded = [f for f in row["flushes"] if f["requests"] < f["batch"]]
    check(row["stats"]["batches_run"] == {2: 2, 4: 0, 8: 0}
          and len(padded) == 1,
          f"{label}: flushes {row['flushes']}, expected 2 then a padded 2")
    out["servers"][label] = row
    log(f"[serve] {label}: 3 requests as a flush of 2 and a padded flush "
        f"of 2 ({padded[0]['requests']} request), within tolerance of "
        "FastExec")
    return out


class KernelCalls:
    """Wraps the model path's kernel entry points for one pass
    (``kernels.ops.flash_attention``, which ``models/layers.py`` calls,
    ``kernels.wkv_chunk.wkv_chunk_kernel``, which ``models/ssm.py``
    calls, ``kernels.flash_attention.flash_backward_kernel``, which
    the ``FlashAttention`` Function's backward calls, and
    ``kernels.wkv_chunk.wkv_backward_kernel``, which ``WkvChunk``'s
    backward calls): keeps the first
    call's inputs and outputs (layer 0's in a forward) and the last's
    (layer 0's in a backward) and, with ``timed``, CUDA events around
    every call. The kernels' own launch counters are untouched. ``extra``
    (name -> (module, function)) wraps more of the path the same way
    (the archs phase: ``ssm.mamba_forward``, hymba's Mamba loop).
    ``keep`` names the calls whose tensors are kept: a run whose layer
    inputs are gigabytes keeps only the first or none, since the last
    call's tensors stay alive until the next call returns. With ``host``
    the kept tensors are copied to the host as the call returns, so they
    take no device memory for the rest of the run."""

    def __init__(self, torch, timed: bool = False, extra=None,
                 keep=("first", "last"), host: bool = False):
        from repro_torch.kernels import flash_attention as TF
        from repro_torch.kernels import ops as TO
        from repro_torch.kernels import wkv_chunk as TW
        self.torch, self.timed = torch, timed
        #: kernel name -> (module, entry point)
        self.mods = {"flash_attention": (TO, "flash_attention"),
                     "wkv_chunk": (TW, "wkv_chunk_kernel"),
                     "flash_attention_bwd": (TF, "flash_backward_kernel"),
                     "wkv_chunk_bwd": (TW, "wkv_backward_kernel"),
                     **(extra or {})}
        self.first, self.last, self.events = {}, {}, {}
        self.keep, self.host = keep, host

    def _kept(self, x):
        """``x`` (a call's args, kwargs or outputs), on the host with
        ``host``."""
        if not self.host:
            return x
        if isinstance(x, self.torch.Tensor):
            return x.to("cpu")
        if isinstance(x, (tuple, list)):
            return type(x)(self._kept(y) for y in x)
        if isinstance(x, dict):
            return {k: self._kept(v) for k, v in x.items()}
        return x

    def _wrap(self, name, fn):
        def run(*args, **kw):
            ev = None
            if self.timed:
                ev = [self.torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
            out = fn(*args, **kw)
            if ev:
                ev[1].record()
                self.events.setdefault(name, []).append(ev)
            if "first" in self.keep and name not in self.first:
                self.first[name] = self._kept((args, kw, out))
            if "last" in self.keep:
                self.last[name] = self._kept((args, kw, out))
            return out
        return run

    def __enter__(self):
        self.real = {k: getattr(m, n) for k, (m, n) in self.mods.items()}
        for k, (m, n) in self.mods.items():
            setattr(m, n, self._wrap(k, self.real[k]))
        return self

    def __exit__(self, *exc):
        for k, (m, n) in self.mods.items():
            setattr(m, n, self.real[k])

    def device_ms(self, name) -> float:
        """Device ms of every timed call of ``name`` (synchronises)."""
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events.get(name, []))

    def calls(self, name) -> int:
        """Timed calls of ``name``."""
        return len(self.events.get(name, []))


def _leaf_names(tree, prefix: str = "") -> list:
    """The '/'-joined names of a tree's leaves in ``adamw.tree_leaves``
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def model_kernel_check(torch, calls: KernelCalls, name: str, tol) -> float:
    """Layer 0's kernel call of the pass ``calls`` recorded, held against
    the kernel's plain version on the same inputs."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    args, kw, out = calls.first[name]
    if name == "flash_attention":
        q, k, v = args
        return close_err(torch, out, TF.flash_plain(q, k, v, True, 128, 128),
                         tol, "flash layer 0 against plain")
    y0, st0 = TW.wkv_plain(*args, kw["q"])
    return max(close_err(torch, out[0], y0, tol, "wkv layer 0 y"),
               close_err(torch, out[1], st0, tol, "wkv layer 0 state"))


def event_wrap(torch, fn, marks: list):
    """``fn`` with CUDA events recorded around each call into ``marks``."""
    def run(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = fn(*args)
        ev[1].record()
        marks.append(ev)
        return res
    return run


def flash_prefill_row(torch, F, calls: KernelCalls, arch: str,
                      launches: int, kernel_ms: float,
                      tag: str = "prefill") -> dict:
    """The ``flash_attention [<arch> <tag>]`` row of a served bf16
    prefill: layer 0's call
    of the pass ``calls`` recorded, against ``flash_plain`` within
    ``flash_bf16_tol`` (SDPA's largest difference from it beside), timed
    beside its plain version, SDPA on (1, B·H, S, D) copies and its
    bound. Its ``ms`` is the prefill's device ms over
    its ``launches`` calls (CUDA events around each, all of one shape);
    plain and library ms are layer 0's call's."""
    from repro_torch.kernels import flash_attention as TF
    (q, k, v), _, res = calls.first["flash_attention"]
    plain = TF.flash_plain(q, k, v, True, 128, 128)  # also its warm-up
    tol = flash_bf16_tol(v)
    err = close_err(torch, res, plain, tol, f"{arch} bf16 flash layer 0")
    sq, bh, d = q.shape
    qh, kh, vh = (a.permute(1, 0, 2)[None].contiguous() for a in (q, k, v))
    # SDPA's bf16 output against the same plain version, for scale
    lib_err = (F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)[0]
               .permute(1, 0, 2).float() - plain.float()).abs().max().item()
    del plain
    call_ms = time_auto(torch, lambda: TF.flash_attention_kernel(
        q, k, v, True))
    plain_ms = time_ms(torch, lambda: TF.flash_plain(q, k, v, True, 128,
                                                     128), 1, warm=False)
    library_ms = time_auto(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    del qh, kh, vh
    cost = attention_cost(sq, sq, bh, d, True, q.element_size())
    return {
        "name": f"flash_attention [{arch} {tag}]", "route": "cuda",
        "source": KERNELS["flash_attention"][0],
        "replaces": KERNELS["flash_attention"][1],
        "path": (f"{arch} bf16 prefill: B·H = {bh}, S = T = {sq}, D = {d}, "
                 f"{launches} a prefill; every time one call's"),
        "launches": launches, "max_abs_err": err,
        "ms": kernel_ms / launches, "plain_ms": plain_ms,
        "bound_ms": cost_ms(cost), "bound_by": cost_by(cost),
        "library_ms": library_ms, "calls_a_prefill": launches,
        "prefill_device_ms": kernel_ms, "layer0_call_ms": call_ms,
        "tol": list(tol), "library_max_abs_err": lib_err}


def decode_in_place(torch, eng, prompts, sp: int, arch: str) -> dict:
    """One decode step of ``eng`` after its prefill of ``prompts``: every
    stacked cache tensor keeps its storage and the step's peak memory
    rises by less than the cache's bytes."""
    with torch.inference_mode():
        logits, cache = eng._prefill(eng.params, prompts)
        tok = torch.argmax(logits[:, -1].float(), -1)[:, None]
        ptrs = {n: t.data_ptr() for n, t in cache.items()}
        cache_bytes = _tree_bytes(cache)
        del logits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        logits, cache = eng._decode(eng.params, cache, tok, sp)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base_mem
    check({n: t.data_ptr() for n, t in cache.items()} == ptrs,
          f"{arch}: a decode step moved the cache")
    check(rise < cache_bytes, f"{arch}: one decode step's peak memory "
          f"rose {rise} B, the stacked cache is {cache_bytes} B")
    return {"decode_step_peak_rise_bytes": rise, "cache_bytes": cache_bytes}


def f32_decode_check(torch, base, s: int, extra: int, rng, gen) -> tuple:
    """``base`` at full width in float32 (TF32 off) on weights drawn from
    ``gen`` (seed 0): ``forward_train`` over ``s + extra`` tokens from
    ``rng``, then ``prefill`` of the first ``s`` and ``MODEL_STEPS``
    ``decode_step``s, each step's logits within ``MODEL_TOL`` of the full
    pass; the prefill's launches (one flash a layer, or three WKV), with
    the counts reset just before and read just after, and layer 0's kernel
    call against its plain version (``STANDALONE_TOL``). Returns (record,
    the float32 config, its weights)."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models import transformer as T
    arch = base.name
    kname = "wkv_chunk" if base.attention == "none" else "flash_attention"
    want_launches = base.num_layers * (
        TW.KERNELS_PER_CALL if kname == "wkv_chunk" else 1)
    cfg = dataclasses.replace(base, dtype="float32")
    params = T.init_params(cfg, gen.manual_seed(0))
    rec = {"f32_param_bytes": _tree_bytes(params)}
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, s + extra)).astype(np.int32)).cuda()
    with torch.inference_mode():
        full, _ = T.forward_train(cfg, params, toks)
        want = full[0, s - 1:s + MODEL_STEPS].clone()
        del full
        TF.reset_launches()
        TW.reset_launches()
        with KernelCalls(torch) as calls:
            logits, cache = T.prefill(cfg, params, toks[:, :s], s + extra)
        torch.cuda.synchronize()
        launches = {"flash_attention": TF.LAUNCHES, "wkv_chunk": TW.LAUNCHES}
        check(launches[kname] == want_launches and sum(
            launches.values()) == want_launches,
            f"{arch} f32 prefill: launches {launches}, expected "
            f"{want_launches} of {kname}")
        rec["f32_prefill_launches"] = launches
        rec["f32_kernel_vs_plain"] = model_kernel_check(
            torch, calls, kname, STANDALONE_TOL[kname])
        del calls
        errs = [close_err(torch, logits[0, 0], want[0], MODEL_TOL,
                          f"{arch} f32 prefill against the full pass")]
        for i in range(MODEL_STEPS):
            logits, cache = T.decode_step(cfg, params, cache,
                                          toks[:, s + i:s + i + 1], s + i)
            errs.append(close_err(
                torch, logits[0, 0], want[i + 1], MODEL_TOL,
                f"{arch} f32 decode step {i} against the full pass"))
    rec["f32_decode_vs_full"] = errs
    del cache, logits, want
    log(f"[models] {arch} f32: full pass over {s + extra} tokens; "
        f"prefill {s} + {MODEL_STEPS} decode steps within "
        f"{max(errs):.3g} of it (limit {MODEL_TOL}); one prefill "
        f"{json.dumps(launches)} launches, layer 0's {kname} within "
        f"{rec['f32_kernel_vs_plain']:.3g} of its plain version")
    return rec, cfg, params


def models_phase(torch, F) -> tuple:
    """Phase 10c of the module docstring: the decoder models and the decode
    engines at full width. Returns the model path's rows of the ``kernels``
    line and the ``models`` section of ``build/chip_smoke.json``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   Engine, Request, ServeConfig)
    kernel_of = {"attention": "flash_attention", "rwkv": "wkv_chunk"}
    out, rows = {}, []
    for arch, s, extra in MODEL_RUNS:
        base = get_arch(arch)
        fam = "rwkv" if base.attention == "none" else "attention"
        kname = kernel_of[fam]
        per_call = TW.KERNELS_PER_CALL if kname == "wkv_chunk" else 1
        want_launches = base.num_layers * per_call
        rec = out[arch] = {"layers": base.num_layers, "kernel": kname}
        rng = np.random.default_rng(28)
        gen = torch.Generator(device="cuda")

        # 1-2. float32: decode against the full pass; one prefill's launches
        f32, cfg, params = f32_decode_check(torch, base, s, extra, rng, gen)
        rec.update(f32)

        # 5. continuous batching against single-request engines (qwen)
        if fam == "attention":
            slots, clen, new = CONT
            eng = ContinuousEngine(cfg, params, ContinuousConfig(
                slots=slots, cache_len=clen))
            single = Engine(cfg, params, ServeConfig(cache_len=clen,
                                                     max_new_tokens=new))
            prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                       for n in CONT_PROMPTS]
            reqs = [Request(i, p, max_new_tokens=new)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            t0 = time.perf_counter()
            eng.run(max_steps=200)
            torch.cuda.synchronize()
            cont_s = time.perf_counter() - t0
            for r, p in zip(reqs, prompts):
                alone = single.generate(p[None])[0].tolist()
                check(r.done and r.out == alone,
                      f"{arch} continuous request {r.rid} ({len(p)} "
                      f"tokens): {r.out}, alone {alone}")
            rec["continuous"] = {
                "slots": slots, "cache_len": clen, "new_tokens": new,
                "prompts": list(CONT_PROMPTS), "wall_s": cont_s,
                "tokens": [r.out for r in reqs]}
            log(f"[models] {arch} continuous f32: {len(reqs)} requests "
                f"({min(CONT_PROMPTS)}-{max(CONT_PROMPTS)} tokens) on "
                f"{slots} slots, cache {clen}, {new} new each, in "
                f"{cont_s:.3f} s (host clock); every request equal to a "
                "single-request Engine on the card")
            del eng, single
        del params
        torch.cuda.empty_cache()

        # 3. bfloat16 serving through Engine.generate
        b, sp, new = MODEL_SERVE
        cfg = base
        params = T.init_params(cfg, gen.manual_seed(0))
        rec["bf16_param_bytes"] = _tree_bytes(params)
        eng = Engine(cfg, params, ServeConfig(cache_len=sp + new,
                                              max_new_tokens=new))
        prompts = rng.integers(0, cfg.vocab_size, (b, sp)).astype(np.int32)
        TF.reset_launches()
        TW.reset_launches()
        first = eng.generate(prompts)
        torch.cuda.synchronize()
        launches = {"flash_attention": TF.LAUNCHES, "wkv_chunk": TW.LAUNCHES}
        check(launches[kname] == want_launches
              and sum(launches.values()) == want_launches,
              f"{arch} bf16 generate: launches {launches}, expected "
              f"{want_launches} of {kname} (prefill only)")
        rec["bf16_generate_launches"] = launches
        marks = {"prefill": [], "decode": []}
        eng._prefill = event_wrap(torch, eng._prefill, marks["prefill"])
        eng._decode = event_wrap(torch, eng._decode, marks["decode"])
        walls, same, kernel_ms = [], True, []
        for _ in range(MODEL_SERVE_REPS):
            with KernelCalls(torch, timed=True) as calls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = eng.generate(prompts)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            kernel_ms.append(calls.device_ms(kname))
            same &= bool((got == first).all())
        pre = [a.elapsed_time(z) for a, z in marks["prefill"]]
        dec = [a.elapsed_time(z) for a, z in marks["decode"]]
        wall = statistics.median(walls)
        serve = {
            "batch": b, "prompt": sp, "new_tokens": new,
            "reps": MODEL_SERVE_REPS,
            "prefill_ms": statistics.median(pre), "prefill_ms_all": pre,
            "decode_ms": statistics.median(dec),
            "decode_ms_max": max(dec), "decode_steps": len(dec),
            "generate_wall_s": walls,
            "tok_s": b * new / wall,
            "decode_tok_s": 1e3 * b / statistics.median(dec),
            "kernel_ms_in_prefill": statistics.median(kernel_ms),
            "kernel_ms_all": kernel_ms,
            "greedy_tokens_repeat": same}
        rec["bf16_serve"] = serve
        log(f"[models] {arch} bf16 Engine.generate, batch {b}, prompt "
            f"{sp}, {new} new, greedy ({MODEL_SERVE_REPS} runs, CUDA "
            f"events, medians): prefill {serve['prefill_ms']:.3f} ms, "
            f"decode {serve['decode_ms']:.4f} ms a token (max "
            f"{serve['decode_ms_max']:.4f}), {serve['tok_s']:.1f} tok/s "
            f"end to end (host wall {wall:.3f} s, prefill included), "
            f"{serve['decode_tok_s']:.1f} tok/s in decode; {kname} "
            f"{want_launches} launches a prefill, "
            f"{serve['kernel_ms_in_prefill']:.4f} device ms of them; "
            f"tokens equal across runs: {same}")

        # the kernel's row: layer 0's bf16 call against its plain version,
        # its per-launch times beside the plain version, library, bound
        if kname == "flash_attention":
            rows.append(flash_prefill_row(torch, F, calls, arch,
                                          want_launches,
                                          serve["kernel_ms_in_prefill"]))
        else:
            args, kw, res = calls.first[kname]
            err = model_kernel_check(torch, calls, kname,
                                     STANDALONE_TOL[kname])
            bb, sw, hh, dd = args[0].shape
            cost = wkv_cost(bb, sw, hh, dd, kw["q"])
            # every number of the row is one call's: ms the served
            # prefill's calls (CUDA events around each, all of one shape)
            # over their count; plain ms measured on layer 0's call
            calls_n = base.num_layers
            rows.append({
                "name": f"{kname} [{arch} prefill]", "route": "cuda",
                "source": KERNELS[kname][0], "replaces": KERNELS[kname][1],
                "path": (f"{arch} bf16 prefill: B {bb}, S {sw}, {hh} heads "
                         f"of {dd}, q {kw['q']}, f32 inside, 3 x "
                         f"{base.num_layers}; every time one call's"),
                "launches": launches[kname], "max_abs_err": err,
                "ms": serve["kernel_ms_in_prefill"] / calls_n,
                "plain_ms": time_ms(torch, lambda: TW.wkv_plain(
                    *args, kw["q"]), 1),
                "bound_ms": cost_ms(cost), "bound_by": cost_by(cost),
                "library_ms": None, "calls_a_prefill": calls_n,
                "prefill_device_ms": serve["kernel_ms_in_prefill"],
                "layer0_call_ms": time_auto(torch, lambda: (
                    TW.wkv_chunk_kernel(*args, **kw)))})
            del args, kw, res
        del calls

        # 4. one decode step updates the stacked cache in place
        rec.update(decode_in_place(torch, eng, prompts, sp, arch))
        log(f"[models] {arch} bf16 decode step in place: peak memory rose "
            f"{rec['decode_step_peak_rise_bytes']} B against the stacked "
            f"cache's {rec['cache_bytes']} B; every cache tensor kept its "
            f"storage; {kname} row: " + json.dumps(rows[-1]))
        del eng, params
        torch.cuda.empty_cache()
    return rows, out


def train_steps(torch, arch: str, seed: int, want: dict, timed,
                cfg=None, shape=TRAIN_BATCH, want_mbs: int = 2,
                extra=None) -> tuple:
    """``TRAIN_STEPS`` ``make_train_step`` steps of ``arch`` (or of
    ``cfg``, the arch with its depth cut) at full width in bf16 on weights
    drawn from ``seed``, a batch of ``shape`` from the port's
    ``SyntheticCorpus`` (``embedding_batches`` for a frontend stub) in
    ``default_microbatches`` (``want_mbs``) with remat, each
    with the launch counts reset just before and read just after: finite
    losses and grad norms, ``want`` launches a step (kernel for kernel),
    every param, m and v leaf in its storage after each update, the
    update's peak rise under the largest leaf's f32 bytes or eight
    ``adamw.SLICE`` slices', whichever is larger (step 0);
    step ms (CUDA events), each step's host wall and allocator counts
    (cudaMalloc calls, retries), tokens/s, the device ms a step of the
    kernels named in ``timed`` (``KernelCalls`` with ``extra``, steps 1
    on), the update's ms, the
    step's peak against the state's bytes, and the step's model FLOPs
    (``roofline.model_flops_for``) with their share of the bf16 peak.
    Returns (the record, the last step's ``KernelCalls``)."""
    from repro_torch import roofline as RL
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           embedding_batches, shard_batch)
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cfg = cfg or get_arch(arch)
    b, s = shape
    mbs = TS.default_microbatches(cfg, b, s, 1)
    check(mbs == want_mbs, f"{arch}: default_microbatches gives {mbs}, "
          f"expected {want_mbs}")
    opt = TS.opt_config_for(cfg)
    gen = torch.Generator(device="cuda")
    state = TS.init_state(cfg, gen.manual_seed(seed), opt)
    parts = {"p": state["params"], "m": state["opt"]["m"],
             "v": state["opt"]["v"]}
    ptrs = {k: [t.data_ptr() for t in adamw.tree_leaves(v)]
            for k, v in parts.items()}
    nbytes = {k: _tree_bytes(v) for k, v in parts.items()}
    largest = max(t.numel() for t in adamw.tree_leaves(state["params"]))
    dc = DataConfig(cfg.vocab_size, s, b, seed=seed)
    data = (embedding_batches(dc, cfg.d_model, seed=seed)
            if cfg.frontend != "none"
            else SyntheticCorpus(dc).packed_batches())
    step = TS.make_train_step(cfg, opt, remat=True, microbatches=mbs)
    rec = {"arch": arch, "layers": cfg.num_layers, "batch": b, "seq": s,
           "microbatches": mbs,
           "remat": True, "steps": TRAIN_STEPS, "opt": dataclasses.asdict(
               opt), "state_bytes": nbytes,
           "largest_leaf_elements": largest, "launches_a_step": [],
           "loss": [], "grad_norm": [], "step_ms": [], "step_wall_s": []}
    real_update = adamw.update
    mem = {}

    def measured_update(*args, **kw):
        # step 0 only: the step's peak so far, then the update's own rise
        torch.cuda.synchronize()
        mem["before_update_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = real_update(*args, **kw)
        torch.cuda.synchronize()
        mem["update_peak"] = torch.cuda.max_memory_allocated()
        mem["update_rise"] = mem["update_peak"] - base
        return out

    upd_events = []

    def timed_update(*args, **kw):
        # steps 1 on: CUDA events around the update, no wait
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real_update(*args, **kw)
        ev[1].record()
        upd_events.append(ev)
        return out

    per_step = []
    rec["allocator_a_step"] = []

    def alloc_counts():
        st = torch.cuda.memory_stats()
        return {k: st.get(k, 0) for k in ("num_alloc_retries",
                                          "num_device_alloc")}
    for i in range(TRAIN_STEPS):
        batch = shard_batch(next(data), "cuda")
        TF.reset_launches()
        TW.reset_launches()
        adamw.update = measured_update if i == 0 else timed_update
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        a0 = alloc_counts()
        t0 = time.perf_counter()
        try:
            with KernelCalls(torch, timed=i > 0, extra=extra) as calls:
                ev[0].record()
                state, m = step(state, batch)
                ev[1].record()
                torch.cuda.synchronize()
        finally:
            adamw.update = real_update
        rec["step_wall_s"].append(time.perf_counter() - t0)
        rec["step_ms"].append(ev[0].elapsed_time(ev[1]))
        rec["allocator_a_step"].append({k: v - a0[k] for k, v in
                                        alloc_counts().items()})
        launches = {"flash_attention": TF.LAUNCHES,
                    "flash_attention_bwd": TF.BWD_LAUNCHES,
                    "wkv_chunk": TW.LAUNCHES,
                    "wkv_chunk_bwd": TW.BWD_LAUNCHES}
        rec["launches_a_step"].append(launches)
        check(launches == want,
              f"{arch} train step {i}: launches {launches}, expected {want}")
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        rec["loss"].append(loss)
        rec["grad_norm"].append(gnorm)
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"{arch} train step {i}: loss {loss}, grad norm {gnorm}")
        check({k: [t.data_ptr() for t in adamw.tree_leaves(v)]
               for k, v in parts.items()} == ptrs,
              f"{arch} train step {i}: a param, m or v leaf moved")
        if i > 0:
            per_step.append({name: (calls.device_ms(name), calls.calls(name))
                             for name in timed})
        log(f"[train] {arch} step {i}: loss {loss:.4f}, grad norm "
            f"{gnorm:.4f}, {rec['step_ms'][-1]:.1f} device ms (CUDA "
            f"events), wall {rec['step_wall_s'][-1]:.3f} s, launches "
            f"{json.dumps(launches)}, allocator "
            f"{json.dumps(rec['allocator_a_step'][-1])}"
            + (f", kernels (ms, calls) {json.dumps(per_step[-1])}"
               if i > 0 else ""))
    check(int(state["opt"]["step"]) == TRAIN_STEPS, f"{arch}: step count")
    # the update's float32 temporaries are a few slices of each leaf
    limit = 4 * max(largest, 8 * adamw.SLICE)
    check(mem["update_rise"] < limit,
          f"{arch}: the update's peak memory rose {mem['update_rise']} B, "
          f"over {limit} B (the largest leaf is {4 * largest} B in f32)")
    rec.update(mem)
    rec["step_peak"] = max(mem["before_update_peak"], mem["update_peak"])
    rec["step_peak_over_state"] = rec["step_peak"] / sum(nbytes.values())
    step_ms = statistics.median(rec["step_ms"][1:])
    rec["step_ms_median"] = step_ms
    rec["tokens_s"] = 1e3 * b * s / step_ms
    rec["kernel_ms_in_step"] = {name: statistics.median(
        t[name][0] for t in per_step) for name in timed}
    rec["kernel_calls_a_step"] = {name: per_step[-1][name][1]
                                  for name in timed}
    rec["kernel_ms_each_step"] = per_step
    rec["update_ms"] = statistics.median(a.elapsed_time(z)
                                         for a, z in upd_events)
    flops = RL.model_flops_for(cfg, ShapeConfig(f"{arch} train", s, b,
                                                "train"))
    rec["model_flops"] = flops
    rec["model_flops_share_of_bf16_peak"] = flops / (step_ms * 1e-3) \
        / BF16_OPS_S
    log(f"[train] {arch} bf16 at full width, {cfg.num_layers} layers, "
        f"batch {b} x {s} in {mbs} "
        f"microbatches, remat, {TRAIN_STEPS} steps: losses {rec['loss']}, "
        f"grad norms {rec['grad_norm']}; step {step_ms:.1f} device ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}), {rec['tokens_s']:.0f} "
        f"tokens/s; kernels a step (ms, calls) "
        f"{json.dumps({n: (rec['kernel_ms_in_step'][n], rec['kernel_calls_a_step'][n]) for n in timed})}"
        f", the update {rec['update_ms']:.1f} ms; the update's peak rise "
        f"{mem['update_rise']} B (largest leaf {4 * largest} B in f32), the "
        f"step's peak {rec['step_peak']} B against the state's "
        f"{sum(nbytes.values())} B; p, m, v in place; model FLOPs of the "
        f"step {flops:.4g} (roofline.model_flops_for), "
        f"{100 * rec['model_flops_share_of_bf16_peak']:.1f} % of the bf16 "
        f"peak at the step's ms")
    del state, parts, m, batch
    return rec, calls


def grad_check(torch, arch: str, seed: int, route: tuple) -> dict:
    """Every gradient leaf of a 2-layer float32 ``arch`` at full width over
    4096 tokens (remat), the loss on the kernels against the same loss with
    one kernel's entry point ``route`` = (module, name, plain stand-in,
    launch counter names, launches of the kernel route) swapped for its
    plain versions called directly, within ``TRAIN_GRAD_TOL`` (atol
    scaled by the leaf's largest entry); the kernels' device ms within the
    kernel run (``KernelCalls``). Returns the record, with the names of
    the leaves whose gradient is zero."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           shard_batch)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    mod, name, stand_in, counters, want = route
    layers, cs = TRAIN_CHECK
    cfg = get_arch(arch)
    cfg2 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = T.init_params(cfg2, torch.Generator(device="cuda")
                           .manual_seed(seed))
    batch = shard_batch(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, cs, 1, seed=seed)).packed_batches()), "cuda")
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()

    def grads():
        loss, _ = TS.loss_fn(cfg2, params, batch, remat=True)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def counts():
        return tuple(getattr(m, c) for m, c in counters)
    for m, _ in counters:
        m.reset_launches()
    with KernelCalls(torch, timed=True) as calls:
        kl, kg = grads()
    torch.cuda.synchronize()
    kernel_ms = {n: {"ms": calls.device_ms(n), "calls": calls.calls(n)}
                 for n in calls.events}
    check(counts() == want, f"{arch} gradient check: launches {counts()}, "
          f"expected {want}")
    real = getattr(mod, name)
    setattr(mod, name, stand_in)
    try:
        pl, pg = grads()
    finally:
        setattr(mod, name, real)
    torch.cuda.synchronize()
    check(counts() == want,
          f"{arch} gradient check: the plain run launched a kernel")
    atol, rtol = TRAIN_GRAD_TOL
    errs = [close_err(torch, g, w, (atol * w.abs().max().item(), rtol),
                      f"{arch} gradient check leaf {i}")
            for i, (g, w) in enumerate(zip(kg, pg))]
    names = _leaf_names(params)
    rec = {"layers": layers, "tokens": cs, "loss": float(kl),
           "plain_loss": float(pl), "max_abs_err": max(errs),
           "leaves": len(errs), "tol": TRAIN_GRAD_TOL,
           "zero": [n for n, g in zip(names, kg) if g.abs().max().item()
                    == 0], "names": names, "kernel_ms": kernel_ms}
    log(f"[train] {arch} gradient check, {layers} layers in f32 at {cs} "
        f"tokens: loss {float(kl):.6f} (plain {float(pl):.6f}); "
        f"{len(errs)} gradient leaves within {max(errs):.3g} of the plain "
        f"route's (limit {TRAIN_GRAD_TOL}); the kernels' device ms "
        f"(calls) {json.dumps(kernel_ms)}")
    del params, leaves, kg, pg, batch, calls
    torch.cuda.empty_cache()
    return rec


def flash_train_rows(torch, F, rec: dict, calls: KernelCalls, arch: str,
                     want: dict, label: str) -> list:
    """The ``flash_attention`` and ``flash_attention_bwd`` rows of a bf16
    train step (``train_steps``' record ``rec``): layer 0's forward and
    backward calls of the last step (``calls``) against their plain
    versions (recorded under ``rec["layer0_errors"]``), timed beside
    them, their bounds and SDPA's forward and backward; each row's ``ms``
    the step's device ms of the kernel over its calls."""
    from repro_torch.kernels import flash_attention as TF
    per, ncalls = rec["kernel_ms_in_step"], rec["kernel_calls_a_step"]
    q, k, v = calls.first["flash_attention"][0][:3]
    y = calls.first["flash_attention"][2]
    bargs, _, bout = calls.last["flash_attention_bwd"]
    bargs = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                  for a in bargs)
    with torch.no_grad():
        fwd_err = close_err(torch, y, TF.flash_plain(q, k, v, True, 128,
                                                     128),
                            flash_bf16_tol(v), f"{arch} train layer 0 forward")
        bwd_err = grads_close(torch, bout, TF.flash_backward_plain(*bargs),
                              FLASH_BWD_TOL["bf16"],
                              f"{arch} train layer 0 backward")
    rec["layer0_errors"] = {"flash_attention": fwd_err,
                            "flash_attention_bwd": bwd_err}
    sq, bh, d = q.shape
    fcost = attention_cost(sq, sq, bh, d, True, q.element_size())
    bcost = attention_bwd_cost(sq, sq, bh, d, True, q.element_size())
    q, k, v = (a.detach() for a in (q, k, v))
    qh, kh, vh = (a.permute(1, 0, 2)[None].contiguous() for a in (q, k, v))
    fwd_lib = time_auto(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    del qh, kh, vh
    path = f"{label}: B·H = {bh}, S = T = {sq}, D = {d}"
    n_fwd, n_bwd = (ncalls[n] for n in ("flash_attention",
                                        "flash_attention_bwd"))
    rows = [
        {"name": f"flash_attention [{arch} train]", "route": "cuda",
         "source": KERNELS["flash_attention"][0],
         "replaces": KERNELS["flash_attention"][1],
         "path": path + f"; {n_fwd} calls a step; every time one call's",
         "launches": want["flash_attention"], "max_abs_err": fwd_err,
         "ms": per["flash_attention"] / n_fwd,
         "plain_ms": time_ms(torch, lambda: TF.flash_plain(
             q, k, v, True, 128, 128), 1),
         "bound_ms": cost_ms(fcost), "bound_by": cost_by(fcost),
         "library_ms": fwd_lib, "step_device_ms": per["flash_attention"],
         "model_flops": rec["model_flops"],
         "model_flops_share_of_bf16_peak":
             rec["model_flops_share_of_bf16_peak"]},
        {"name": f"flash_attention_bwd [{arch} train]",
         "route": "cuda", "source": KERNELS["flash_attention_bwd"][0],
         "replaces": KERNELS["flash_attention_bwd"][1],
         "path": path + f"; {n_bwd} calls a step; every time one call's",
         "launches": want["flash_attention_bwd"], "max_abs_err": bwd_err,
         "ms": per["flash_attention_bwd"] / n_bwd,
         "plain_ms": time_ms(torch, lambda: TF.flash_backward_plain(
             *bargs), 1),
         "bound_ms": cost_ms(bcost), "bound_by": cost_by(bcost),
         **sdpa_backward_ms(torch, F, *bargs[:3], bargs[4]),
         "step_device_ms": per["flash_attention_bwd"],
         "model_flops": rec["model_flops"],
         "model_flops_share_of_bf16_peak":
             rec["model_flops_share_of_bf16_peak"]}]
    log(f"[train] {arch}: layer 0 against plain "
        f"{json.dumps(rec['layer0_errors'])}")
    return rows


def train_phase(torch, F) -> tuple:
    """Phase 10d of the module docstring: training at full width. Returns
    the training path's rows of the ``kernels`` line and the ``train``
    section of ``build/chip_smoke.json``."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import wkv_chunk as TW
    cfg = get_arch(TRAIN_ARCH)
    # a step: each microbatch runs every layer's forward twice (remat) and
    # one backward call a layer
    mbs = 2
    want = {"flash_attention": 2 * cfg.num_layers * mbs,
            "flash_attention_bwd": TF.BWD_KERNELS_PER_CALL * cfg.num_layers
            * mbs, "wkv_chunk": 0, "wkv_chunk_bwd": 0}
    rec, calls = train_steps(torch, TRAIN_ARCH, 29,
                             want, ("flash_attention", "flash_attention_bwd"))
    b, s = TRAIN_BATCH
    rows = flash_train_rows(torch, F, rec, calls, TRAIN_ARCH, want, (
        f"{TRAIN_ARCH} bf16 train step, batch {b} x {s} in {mbs} "
        "microbatches, remat"))
    del calls
    torch.cuda.empty_cache()

    # the gradient check: 2 layers in float32, every leaf against the same
    # loss with attention from the plain versions
    layers = TRAIN_CHECK[0]
    gc = grad_check(torch, TRAIN_ARCH, 30, (
        TO, "flash_attention", plain_attention(torch),
        ((TF, "LAUNCHES"), (TF, "BWD_LAUNCHES")), (2 * layers, 2 * layers)))
    attn = [n for n in gc["names"]
            if any(f"attn/{w}/" in n for w in ("wq", "wk", "wv"))]
    check(len(attn) == 6 and not set(attn) & set(gc["zero"]),
          f"gradient check: {attn} get no gradient")
    rec["grad_check"] = {k: v for k, v in gc.items() if k != "names"}

    # RWKV: its gradient check (2 float32 layers, the WKV from its plain
    # versions), then training at full width in bf16
    rwkv = get_arch(RWKV_TRAIN_ARCH)
    layers = RWKV_CHECK[0]
    gc = grad_check(torch, RWKV_TRAIN_ARCH, 31, (
        TW, "wkv_chunk_kernel", plain_wkv(torch),
        ((TW, "LAUNCHES"), (TW, "BWD_LAUNCHES")),
        (2 * TW.KERNELS_PER_CALL * layers,
         TW.BWD_KERNELS_PER_CALL * layers)))
    mixes = [n for n in gc["names"] if any(
        n.endswith(f"rwkv/{w}") for w in ("wr/w", "wk/w", "wv/w", "wd/w",
                                          "u"))]
    check(len(mixes) == 5 and not set(mixes) & set(gc["zero"]),
          f"{RWKV_TRAIN_ARCH} gradient check: {mixes} (zero: {gc['zero']})")
    rwant = {"flash_attention": 0, "flash_attention_bwd": 0,
             "wkv_chunk": 2 * TW.KERNELS_PER_CALL * rwkv.num_layers * mbs,
             "wkv_chunk_bwd": TW.BWD_KERNELS_PER_CALL * rwkv.num_layers
             * mbs}
    rrec, calls = train_steps(torch, RWKV_TRAIN_ARCH, 32, rwant,
                              ("wkv_chunk", "wkv_chunk_bwd"))
    rrec["grad_check"] = {k: v for k, v in gc.items() if k != "names"}
    per, ncalls = rrec["kernel_ms_in_step"], rrec["kernel_calls_a_step"]
    fargs, fkw, fout = calls.first["wkv_chunk"]
    bargs, _, bout = calls.last["wkv_chunk_bwd"]
    fargs = tuple(a.detach() for a in fargs)
    with torch.no_grad():
        y0, st0 = TW.wkv_plain(*fargs, fkw["q"])
        fwd_err = max(close_err(torch, fout[0], y0, STANDALONE_TOL[
            "wkv_chunk"], "rwkv train layer 0 y"), close_err(
            torch, fout[1], st0, STANDALONE_TOL["wkv_chunk"],
            "rwkv train layer 0 state"))
        del y0, st0
        bwd_err = grads_close(torch, bout, TW.wkv_backward_plain(
            *bargs[:8]), WKV_BWD_TOL, "rwkv train layer 0 backward",
            WKV_GRADS)
    rrec["layer0_errors"] = {"wkv_chunk": fwd_err, "wkv_chunk_bwd": bwd_err}
    wb, ws, wh, wd = fargs[0].shape
    wq = fkw["q"]
    fcost = wkv_cost(wb, ws, wh, wd, wq)
    bcost = wkv_bwd_cost(wb, ws, wh, wd, wq, bargs[6] is not None)
    path = (f"{RWKV_TRAIN_ARCH} bf16 train step (f32 inside the WKV), "
            f"batch {b} x {s} in {mbs} microbatches, remat: B {wb}, S {ws}, "
            f"{wh} heads of {wd}, q {wq}")
    n_fwd, n_bwd = ncalls["wkv_chunk"], ncalls["wkv_chunk_bwd"]
    rows += [
        {"name": f"wkv_chunk [{RWKV_TRAIN_ARCH} train]", "route": "cuda",
         "source": KERNELS["wkv_chunk"][0],
         "replaces": KERNELS["wkv_chunk"][1],
         "path": path + f"; {n_fwd} calls a step; every time one call's",
         "launches": rwant["wkv_chunk"], "max_abs_err": fwd_err,
         "ms": per["wkv_chunk"] / n_fwd,
         "plain_ms": time_ms(torch, lambda: TW.wkv_plain(*fargs, wq), 1),
         "bound_ms": cost_ms(fcost), "bound_by": cost_by(fcost),
         "library_ms": None, "step_device_ms": per["wkv_chunk"],
         "model_flops": rrec["model_flops"],
         "model_flops_share_of_bf16_peak":
             rrec["model_flops_share_of_bf16_peak"]},
        {"name": f"wkv_chunk_bwd [{RWKV_TRAIN_ARCH} train]",
         "route": "cuda", "source": KERNELS["wkv_chunk_bwd"][0],
         "replaces": KERNELS["wkv_chunk_bwd"][1],
         "path": path + f"; {n_bwd} calls a step; every time one call's",
         "launches": rwant["wkv_chunk_bwd"], "max_abs_err": bwd_err,
         "ms": per["wkv_chunk_bwd"] / n_bwd,
         "plain_ms": time_ms(torch, lambda: TW.wkv_backward_plain(
             *bargs[:8]), 1),
         "bound_ms": cost_ms(bcost), "bound_by": cost_by(bcost),
         "library_ms": None, "step_device_ms": per["wkv_chunk_bwd"],
         "model_flops": rrec["model_flops"],
         "model_flops_share_of_bf16_peak":
             rrec["model_flops_share_of_bf16_peak"]}]
    log(f"[train] {RWKV_TRAIN_ARCH}: layer 0 against plain "
        f"{json.dumps(rrec['layer0_errors'])}; WKV backward "
        f"{per['wkv_chunk_bwd']:.2f} ms a step ({n_bwd} calls)")
    rec["rwkv"] = rrec
    del calls, fargs, fout, bargs, bout
    torch.cuda.empty_cache()
    return rows, rec


def cut_arch(arch: str, layers) -> tuple:
    """``arch`` at full width with its first ``layers`` layers (None: every
    layer), and the cut as its line prints it."""
    from repro_torch.configs import get_arch
    base = get_arch(arch)
    if layers is None or layers == base.num_layers:
        return base, f"uncut, {base.num_layers} layers"
    return (dataclasses.replace(base, num_layers=layers),
            f"{layers} of {base.num_layers} layers")


def flash_route(cfg, s: int) -> bool:
    """Whether a causal pass of ``s`` tokens takes the flash kernel, as
    ``models/layers.py::_prefill_attention`` decides: past
    ``FLASH_THRESHOLD`` with no window (a hybrid block's attention always
    has ``cfg.sliding_window``)."""
    from repro_torch.models import layers as L
    return s > L.FLASH_THRESHOLD and cfg.attention in ("gqa", "mla")


def arch_serve(torch, F, arch: str, layers, sp: int, seed: int,
               batch: int = ARCH_SERVE_BATCH, cache_len=None,
               tag: str = "prefill") -> tuple:
    """One served arch of the archs phase (or the shapes phase): bf16
    weights drawn from ``seed`` on the card, ``Engine.generate`` at
    ``batch`` x ``sp`` (token ids, or embeddings for a frontend stub) into
    ``cache_len`` slots (None: ``sp`` + the new tokens),
    ``ARCH_SERVE_NEW`` new tokens, greedy, twice on the same prompts: each
    run's flash launches (one a layer where the prefill takes the kernel,
    else none), the tokens equal, the second run timed (CUDA events around
    the prefill and each decode step; the flash calls' and hymba's Mamba
    loop's device ms inside the prefill, ``KernelCalls``); layer 0's
    flash call against its plain version, its row (``flash_attention
    [<arch> <tag>]``); one decode step in place. Returns (rows,
    record)."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    cfg, cut = cut_arch(arch, layers)
    b, new = batch, ARCH_SERVE_NEW
    cache_len = cache_len or sp + new
    check(sp + new <= cache_len, f"{arch}: {sp} + {new} tokens overrun "
          f"{cache_len} cache slots")
    rng = np.random.default_rng(seed)
    if cfg.frontend != "none":
        kind = "embeddings"
        prompts = rng.standard_normal((b, sp, cfg.d_model)).astype(
            np.float32)
    else:
        kind = "tokens"
        prompts = rng.integers(0, cfg.vocab_size, (b, sp)).astype(np.int32)
    want = cfg.num_layers if flash_route(cfg, sp) else 0
    hybrid = cfg.attention == "hybrid"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    wbytes = _tree_bytes(params)
    eng = Engine(cfg, params, ServeConfig(cache_len=cache_len,
                                          max_new_tokens=new))
    marks = {"prefill": [], "decode": []}
    extra = {"mamba_forward": (S, "mamba_forward")} if hybrid else None
    toks, walls = [], []
    for i in range(2):
        if i == 1:
            eng._prefill = event_wrap(torch, eng._prefill, marks["prefill"])
            eng._decode = event_wrap(torch, eng._decode, marks["decode"])
        TF.reset_launches()
        TW.reset_launches()
        with KernelCalls(torch, timed=True, extra=extra) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks.append(eng.generate(prompts))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {"flash_attention": TF.LAUNCHES, "wkv_chunk": TW.LAUNCHES}
        check(launches == {"flash_attention": want, "wkv_chunk": 0},
              f"{arch} generate {i}: launches {launches}, expected {want} "
              "of flash_attention (the prefill's only)")
        if i == 0:
            del calls
    peak = torch.cuda.max_memory_allocated()
    same = bool(np.array_equal(toks[0], toks[1]))
    check(same, f"{arch}: two greedy runs on the same prompts gave "
          f"different tokens: {toks[0].tolist()} and {toks[1].tolist()}")
    check(toks[0].shape == (b, new), f"{arch}: tokens {toks[0].shape}")
    dec = [a.elapsed_time(z) for a, z in marks["decode"]]
    prefill_ms = marks["prefill"][0][0].elapsed_time(marks["prefill"][0][1])
    rec = {"cut": cut, "layers": cfg.num_layers, "batch": b, "prompt": sp,
           "cache_len": cache_len, "prompt_kind": kind, "new_tokens": new,
           "weight_bytes": wbytes,
           "params": cfg.param_count(), "peak_bytes": peak,
           "prefill_ms": prefill_ms, "decode_ms": statistics.median(dec),
           "decode_ms_all": dec, "generate_wall_s": walls,
           "tok_s": b * new / walls[1],
           "decode_tok_s": 1e3 * b / statistics.median(dec),
           "tokens_equal": same, "flash_launches_a_prefill": want,
           "flash_ms_in_prefill": calls.device_ms("flash_attention"),
           "tokens": toks[1].tolist()}
    rows = []
    if want:
        rows.append(flash_prefill_row(torch, F, calls, arch, want,
                                      rec["flash_ms_in_prefill"], tag))
        if cfg.attention == "mla":
            # mla_forward's fold: k_rope expanded over the heads into the
            # keys, v padded from v_head_dim to the folded D
            dr, d = cfg.rope_head_dim, cfg.head_dim + cfg.rope_head_dim
            rec["fold_copy_bytes"] = {
                "k_rope_expand": sp * b * cfg.num_heads * dr * 2,
                "v_pad": sp * b * cfg.num_heads * d * 2}
            copies = (f"the MLA fold's copies (k_rope expanded, v padded to "
                      f"D = {d}) {json.dumps(rec['fold_copy_bytes'])} B")
        else:
            g = cfg.num_heads // cfg.num_kv_heads
            # the k and v copies _flash_prefill makes at q's heads
            rec["gqa_copy_bytes"] = (2 * sp * b * cfg.num_heads
                                     * cfg.head_dim * 2 if g > 1 else 0)
            copies = f"group {g}, the GQA copy {rec['gqa_copy_bytes']} B"
        route = (f"flash {want} launches a prefill (one a layer), "
                 f"{rec['flash_ms_in_prefill']:.3f} device ms of them, "
                 f"{copies}, layer 0 within "
                 f"{rows[-1]['max_abs_err']:.3g} of flash_plain")
    else:
        route = (f"flash 0 launches: the attention's window of "
                 f"{cfg.sliding_window} takes layers._sdpa at S = {sp} "
                 "(_sdpa_blockwise past FLASH_THRESHOLD), as the reference's "
                 "model does; a route, not a fallback")
    if hybrid:
        rec["mamba_ms_in_prefill"] = calls.device_ms("mamba_forward")
        rec["mamba_calls"] = calls.calls("mamba_forward")
        rec["mamba_share_of_prefill"] = rec["mamba_ms_in_prefill"] / \
            prefill_ms
        route += (f"; the Mamba loop {rec['mamba_ms_in_prefill']:.1f} ms "
                  f"of the prefill ({rec['mamba_calls']} calls, "
                  f"{100 * rec['mamba_share_of_prefill']:.1f} %)")
    del calls
    rec.update(decode_in_place(torch, eng, prompts, sp, arch))
    log(f"[{'models' if tag == 'prefill' else 'shapes'}] {arch} ({cut}) "
        f"bf16 serve: batch {b}, prompt {sp} {kind} into {cache_len} cache "
        f"slots, {new} new, greedy, two runs with equal tokens; weights "
        f"{wbytes} B ({cfg.param_count() / 1e9:.2f} B params), peak "
        f"{peak} B; run 2 (CUDA events): prefill {prefill_ms:.3f} ms, "
        f"decode {rec['decode_ms']:.4f} ms a token, {rec['tok_s']:.1f} "
        f"tok/s end to end (wall {walls[1]:.3f} s; run 1 "
        f"{walls[0]:.3f} s); {route}; one decode step in place, its "
        f"peak rise {rec['decode_step_peak_rise_bytes']} B against the "
        f"cache's {rec['cache_bytes']} B")
    del eng, params
    torch.cuda.empty_cache()
    return rows, rec


def grad_repeat(torch, cfg, seed: int, s: int) -> dict:
    """Two forward and backward passes of ``cfg`` (bf16, remat) on one
    batch of 1 x ``s`` tokens and the same weights: the loss and every
    gradient leaf bit-equal (MoE's sums run in a fixed order,
    ``models/moe.py``; MLA's k_rope, expanded over the heads, sums over
    them in its backward)."""
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           shard_batch)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    batch = shard_batch(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, s, 1, seed=seed)).packed_batches()), "cuda")
    (l1, _), g1 = TS.value_and_grad(cfg, params, batch, remat=True)
    (l2, _), g2 = TS.value_and_grad(cfg, params, batch, remat=True)
    names = _leaf_names(params)
    differ = [n for n, a, z in zip(names, adamw.tree_leaves(g1),
                                   adamw.tree_leaves(g2))
              if not torch.equal(a, z)]
    check(bool(torch.equal(l1, l2)) and not differ,
          f"{cfg.name}: two passes on one batch differ: loss {float(l1)!r} "
          f"and {float(l2)!r}, gradient leaves {differ}")
    rec = {"tokens": s, "loss": float(l1), "leaves": len(names),
           "bit_equal": True}
    log(f"[train] {cfg.name} ({cfg.num_layers} layers) bf16: two forward "
        f"and backward passes on one batch of {s} tokens: the loss "
        f"{float(l1)!r} and all {len(names)} gradient leaves bit-equal")
    del params, g1, g2, batch
    torch.cuda.empty_cache()
    return rec


def mamba_backward_ms(torch, calls: KernelCalls) -> dict:
    """Device ms of one layer's ``mamba_forward`` and of its backward
    (``torch.autograd.grad`` to its input and parameters) on layer 0's
    input and parameters of the step ``calls`` recorded: CUDA events
    around each, the second of two runs."""
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    (p, h, cfg), _, _ = calls.first["mamba_forward"]
    p = T.tree_map(lambda t: t.detach().requires_grad_(), p)
    h = h.detach().requires_grad_()
    leaves = [h, *adamw.tree_leaves(p)]
    times = []
    for _ in range(2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.enable_grad():
            ev[0].record()
            y, _ = S.mamba_forward(p, h, cfg)
            ev[1].record()
            torch.autograd.grad(y, leaves, torch.ones_like(y))
            ev[2].record()
        torch.cuda.synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    return {"forward_ms": times[1][0], "backward_ms": times[1][1],
            "shape": list(h.shape)}


def arch_train(torch, F, arch: str, layers, shape, mbs: int,
               seed: int) -> tuple:
    """One trained arch of the archs phase: for MoE and MLA,
    ``grad_repeat`` at one microbatch first; then ``train_steps`` at full
    width with its
    depth cut to ``layers``, ``shape`` in ``mbs`` microbatches, remat,
    each step's flash forward and backward launches (two forwards and one
    backward call a layer a microbatch on the kernel route, else none);
    the flash rows, or for hymba its Mamba loop's device ms in a step
    (forward and recomputation, ``KernelCalls``) and one layer's
    backward; for MLA then the 2-layer float32 gradient check against
    ``plain_attention`` (``grad_check``), every latent projection's
    gradient non-zero. Returns (rows, record)."""
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models import ssm as S
    cfg, cut = cut_arch(arch, layers)
    b, s = shape
    n = cfg.num_layers
    flash = flash_route(cfg, s)
    want = {"flash_attention": 2 * n * mbs if flash else 0,
            "flash_attention_bwd": TF.BWD_KERNELS_PER_CALL * n * mbs
            if flash else 0, "wkv_chunk": 0, "wkv_chunk_bwd": 0}
    mla = cfg.attention == "mla"
    repeat = grad_repeat(torch, cfg, seed, s) if cfg.is_moe or mla else None
    hybrid = cfg.attention == "hybrid"
    extra = {"mamba_forward": (S, "mamba_forward")} if hybrid else None
    timed = (("flash_attention", "flash_attention_bwd") if flash
             else ("mamba_forward",) if hybrid else ())
    rec, calls = train_steps(torch, arch, seed, want, timed, cfg=cfg,
                             shape=shape, want_mbs=mbs, extra=extra)
    rec["cut"] = cut
    if repeat:
        rec["grad_repeat"] = repeat
    label = (f"{arch} ({cut}) bf16 train step, batch {b} x {s} in {mbs} "
             f"microbatches, remat")
    rows = (flash_train_rows(torch, F, rec, calls, arch, want, label)
            if flash else [])
    if hybrid:
        m = mamba_backward_ms(torch, calls)
        step_ms = rec["step_ms_median"]
        fwd = rec["kernel_ms_in_step"]["mamba_forward"]
        bwd = m["backward_ms"] * n * mbs
        m.update({"forward_ms_in_step": fwd,
                  "calls_a_step": rec["kernel_calls_a_step"]["mamba_forward"],
                  "backward_ms_a_step": bwd,
                  "share_of_step": (fwd + bwd) / step_ms})
        rec["mamba"] = m
        log(f"[train] {arch} train: the Mamba loop {fwd:.1f} device ms of "
            f"the step's forwards and recomputations "
            f"({m['calls_a_step']} calls), one layer's backward "
            f"{m['backward_ms']:.1f} ms (forward {m['forward_ms']:.1f}) "
            f"at {m['shape']}, so {bwd:.1f} ms for the step's {n * mbs}: "
            f"{100 * m['share_of_step']:.1f} % of the {step_ms:.1f} ms "
            "step; flash 0 launches (the window's _sdpa at S = "
            f"{s}, a route, not a fallback)")
    del calls
    torch.cuda.empty_cache()
    if mla:
        n2 = TRAIN_CHECK[0]
        gc = grad_check(torch, arch, seed + 1, (
            TO, "flash_attention", plain_attention(torch),
            ((TF, "LAUNCHES"), (TF, "BWD_LAUNCHES")),
            (2 * n2, TF.BWD_KERNELS_PER_CALL * n2)))
        latent = [n for n in gc["names"] if any(
            f"attn/{w}/" in n for w in MLA_PROJECTIONS)]
        check(len(latent) == len(MLA_PROJECTIONS)
              and not set(latent) & set(gc["zero"]),
              f"{arch} gradient check: {latent} (zero: {gc['zero']})")
        rec["grad_check"] = {k: v for k, v in gc.items() if k != "names"}
    return rows, rec


def archs_phase(torch, F) -> tuple:
    """Phase 10e of the module docstring: the eight archs no earlier phase
    runs, the MLA arch first checked in float32 (``ARCH_F32``), served
    (``ARCH_SERVE``) and four of them trained (``ARCH_TRAIN``) on the
    card, each model freed before the next.
    Returns their rows of the ``kernels`` line and the ``archs`` section
    of ``build/chip_smoke.json``."""
    from repro_torch.configs import get_arch
    rows, out = [], {"f32": {}, "serve": {}, "train": {}}
    for i, (arch, s, extra) in enumerate(ARCH_F32):
        out["f32"][arch], _, params = f32_decode_check(
            torch, get_arch(arch), s, extra, np.random.default_rng(350 + i),
            torch.Generator(device="cuda"))
        del params
        torch.cuda.empty_cache()
    for i, (arch, layers, sp) in enumerate(ARCH_SERVE):
        r, out["serve"][arch] = arch_serve(torch, F, arch, layers, sp,
                                           330 + i)
        rows += r
    for i, (arch, layers, shape, mbs) in enumerate(ARCH_TRAIN):
        r, out["train"][arch] = arch_train(torch, F, arch, layers, shape,
                                           mbs, 340 + i)
        rows += r
    return rows, out


def f32_long_step(torch, arch: str, s: int, seed: int) -> dict:
    """``arch`` at full width in float32 (TF32 off) at batch 1 on weights
    drawn from ``seed``: a prefill of ``s`` tokens into
    ``cache_len_for(decode_32k)`` slots and one decode step, whose logits
    must lie within ``MODEL_TOL`` of the last logits of a prefill of the
    ``s + 1`` tokens; one flash launch a layer a prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.launch.specs import cache_len_for
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    clen = cache_len_for(cfg, SHAPES["decode_32k"])
    check(s < clen, f"{arch}: {s} + 1 tokens overrun {clen} slots")
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, s + 1)).astype(np.int32)).cuda()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.inference_mode():
        TF.reset_launches()
        want, _ = T.prefill(cfg, params, toks, s + 1)
        ev[0].record()
        logits, cache = T.prefill(cfg, params, toks[:, :s], clen)
        ev[1].record()
        got, cache = T.decode_step(cfg, params, cache, toks[:, s:], s)
        ev[2].record()
        torch.cuda.synchronize()
    check(TF.LAUNCHES == 2 * cfg.num_layers,
          f"{arch} f32 prefills of {s} and {s + 1} tokens: {TF.LAUNCHES} "
          f"flash launches, expected {2 * cfg.num_layers}")
    err = close_err(torch, got[0, 0], want[0, 0], MODEL_TOL,
                    f"{arch} f32 decode step at {s} against a prefill of "
                    f"{s + 1}")
    rec = {"arch": arch, "batch": 1, "prompt": s, "cache_len": clen,
           "decode_vs_prefill": err, "tol": MODEL_TOL,
           "prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_ms": ev[1].elapsed_time(ev[2]),
           "flash_launches": TF.LAUNCHES}
    log(f"[shapes] {arch} f32, batch 1: prefill {s} tokens into {clen} "
        f"slots ({rec['prefill_ms']:.1f} ms, CUDA events), one decode step "
        f"({rec['decode_ms']:.2f} ms) within {err:.3g} of a prefill of "
        f"{s + 1} (limit {MODEL_TOL}); {TF.LAUNCHES} flash launches over "
        "the two prefills, one a layer")
    del params, cache, logits, got, want
    torch.cuda.empty_cache()
    return rec


def long_rwkv(torch, seed: int) -> tuple:
    """long_500k on ``LONG_ARCH``: bf16 weights drawn from ``seed``,
    ``Engine.generate`` at batch 1 over ``LONG_PROMPT`` tokens,
    ``ARCH_SERVE_NEW`` new, greedy, twice: each run's WKV launches (three
    a layer, the prefill's only) and peak memory; the first run copies
    layer 0's WKV call to the host (its inputs are 16 GiB in float32,
    which on the card beside the prefill's own peak left the allocator
    too little room), then holds it on the card within
    ``STANDALONE_TOL`` of ``wkv_plain`` (output and state) and times it
    beside it; the second timed (CUDA events around the prefill,
    each decode step and each WKV call). Returns (the ``wkv_chunk
    [<arch> 500k prefill]`` row, record)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.launch.specs import cache_len_for, decode_window
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_arch(LONG_ARCH)
    s, new = LONG_PROMPT, ARCH_SERVE_NEW
    shape = SHAPES["long_500k"]
    check(s == shape.seq_len, f"{LONG_ARCH}: prompt {s} against long_500k's "
          f"{shape.seq_len}")
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32)
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    eng = Engine(cfg, params, ServeConfig(
        cache_len=cache_len_for(cfg, shape), window=decode_window(cfg, shape),
        max_new_tokens=new))
    want = {"flash_attention": 0,
            "wkv_chunk": TW.KERNELS_PER_CALL * cfg.num_layers}
    marks = {"prefill": [], "decode": []}
    toks, walls, peaks, reserved = [], [], [], []
    for i in range(2):
        if i == 1:
            eng._prefill = event_wrap(torch, eng._prefill, marks["prefill"])
            eng._decode = event_wrap(torch, eng._decode, marks["decode"])
        TF.reset_launches()
        TW.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with KernelCalls(torch, timed=i == 1, host=True,
                         keep=("first",) if i == 0 else ()) as calls:
            t0 = time.perf_counter()
            toks.append(eng.generate(prompts))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        reserved.append(torch.cuda.max_memory_reserved())
        launches = {"flash_attention": TF.LAUNCHES, "wkv_chunk": TW.LAUNCHES}
        check(launches == want, f"{LONG_ARCH} 500k generate {i}: launches "
              f"{launches}, expected {want} (the prefill's only)")
        if i == 0:
            # layer 0's call back on the card against its plain version,
            # then freed
            args, kw, res = calls.first["wkv_chunk"]
            del calls
            torch.cuda.empty_cache()
            args = tuple(a.to("cuda") for a in args)
            res = tuple(a.to("cuda") for a in res)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            y0, st0 = TW.wkv_plain(*args, kw["q"])
            ev[1].record()
            torch.cuda.synchronize()
            plain_ms = ev[0].elapsed_time(ev[1])
            tol = STANDALONE_TOL["wkv_chunk"]
            err = max(close_err(torch, res[0], y0, tol,
                                f"{LONG_ARCH} 500k layer 0 wkv y"),
                      close_err(torch, res[1], st0, tol,
                                f"{LONG_ARCH} 500k layer 0 wkv state"))
            del y0, st0, res
            call_ms = time_auto(torch, lambda: TW.wkv_chunk_kernel(*args,
                                                                   **kw))
            bb, sw, hh, dd = args[0].shape
            q = kw["q"]
            del args, kw
            torch.cuda.empty_cache()
    same = bool(np.array_equal(toks[0], toks[1]))
    check(same, f"{LONG_ARCH} 500k: two greedy runs gave different tokens: "
          f"{toks[0].tolist()} and {toks[1].tolist()}")
    check(toks[0].shape == (1, new), f"{LONG_ARCH}: tokens {toks[0].shape}")
    kernel_ms = calls.device_ms("wkv_chunk")
    prefill_ms = marks["prefill"][0][0].elapsed_time(marks["prefill"][0][1])
    dec = [a.elapsed_time(z) for a, z in marks["decode"]]
    cost = wkv_cost(bb, sw, hh, dd, q)
    n = cfg.num_layers
    rec = {"arch": LONG_ARCH, "shape": "long_500k", "batch": 1, "prompt": s,
           "new_tokens": new, "layers": n, "weight_bytes": _tree_bytes(params),
           "prefill_ms": prefill_ms, "decode_ms": statistics.median(dec),
           "decode_ms_all": dec, "generate_wall_s": walls,
           "peak_bytes_run1": peaks[0], "peak_bytes": peaks[1],
           "peak_reserved_bytes": reserved,
           "wkv_launches_a_prefill": want["wkv_chunk"],
           "wkv_ms_in_prefill": kernel_ms, "layer0_vs_plain": err,
           "tokens_equal": same, "tokens": toks[1].tolist()}
    row = {"name": f"wkv_chunk [{LONG_ARCH} 500k prefill]", "route": "cuda",
           "source": KERNELS["wkv_chunk"][0],
           "replaces": KERNELS["wkv_chunk"][1],
           "path": (f"{LONG_ARCH} bf16 prefill, long_500k: B {bb}, S {sw}, "
                    f"{hh} heads of {dd}, q {q}, f32 inside, 3 x {n}; "
                    "every time one call's"),
           "launches": want["wkv_chunk"], "max_abs_err": err,
           "ms": kernel_ms / n, "plain_ms": plain_ms,
           "bound_ms": cost_ms(cost), "bound_by": cost_by(cost),
           "library_ms": None, "calls_a_prefill": n,
           "prefill_device_ms": kernel_ms, "layer0_call_ms": call_ms}
    log(f"[shapes] {LONG_ARCH} (uncut, {n} layers) bf16 long_500k: batch 1, "
        f"prompt {s} tokens, {new} new, greedy, two runs with equal tokens; "
        f"run 2 (CUDA events): prefill {prefill_ms:.1f} ms, decode "
        f"{rec['decode_ms']:.3f} ms a token; peak {peaks[1]} B ({peaks[0]} "
        f"B in run 1, which copied layer 0's WKV call to the host; the "
        f"allocator's reserve at most {max(reserved)} B); wkv_chunk "
        f"{want['wkv_chunk']} launches a prefill, {kernel_ms:.2f} device ms of them; layer 0 "
        f"within {err:.3g} of wkv_plain (limit {STANDALONE_TOL['wkv_chunk']})"
        f"; row: " + json.dumps(row))
    del eng, params, calls
    torch.cuda.empty_cache()
    return [row], rec


def ring_wrap(torch, seed: int) -> dict:
    """long_500k on ``RING_ARCH``: bf16 weights drawn from ``seed``, a
    prompt of ``cache_len_for(long_500k)`` tokens into that many ring
    slots with window 0 (``decode_window(long_500k)`` must be 0 or the
    ring's length, which masks the same slots), then ``RING_STEPS`` decode
    steps that wrap the ring, batch 1, twice: the prefill's flash
    launches, the tokens equal across the runs, and every cache tensor in
    the prefill's storage after every step."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.launch.specs import cache_len_for, decode_window
    from repro_torch.models import transformer as T
    from repro_torch.models.config import SHAPES
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_arch(RING_ARCH)
    shape = SHAPES["long_500k"]
    clen, window = cache_len_for(cfg, shape), 0
    spec_window = decode_window(cfg, shape)
    check(spec_window in (0, clen), f"{RING_ARCH}: long_500k's window "
          f"{spec_window} masks slots of the {clen}-slot ring")
    params = T.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed))
    eng = Engine(cfg, params, ServeConfig(cache_len=clen, window=window,
                                          max_new_tokens=RING_STEPS))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, clen)).astype(np.int32)
    ptrs, marks = [], []

    def kept(fn):
        def run(*args):
            logits, cache = fn(*args)
            ptrs[-1].append({n: t.data_ptr() for n, t in cache.items()})
            return logits, cache
        return run
    eng._prefill = kept(eng._prefill)
    eng._decode = event_wrap(torch, kept(eng._decode), marks)
    toks = []
    for i in range(2):
        ptrs.append([])
        TF.reset_launches()
        toks.append(eng.generate(prompts))
        want = cfg.num_layers if flash_route(cfg, clen) else 0
        check(TF.LAUNCHES == want, f"{RING_ARCH} ring run {i}: "
              f"{TF.LAUNCHES} flash launches, expected {want}")
        check(len(ptrs[i]) == RING_STEPS + 1 and all(
            p == ptrs[i][0] for p in ptrs[i]),
            f"{RING_ARCH} ring run {i}: a decode step moved the cache")
    same = bool(np.array_equal(toks[0], toks[1]))
    check(same, f"{RING_ARCH} ring: two greedy runs gave different tokens")
    dec = [a.elapsed_time(z) for a, z in marks[RING_STEPS:]]
    rec = {"arch": RING_ARCH, "shape": "long_500k", "batch": 1,
           "prompt": clen, "cache_len": clen, "window": window,
           "decode_window_long_500k": spec_window,
           "decode_steps": RING_STEPS, "wrapped_slots": RING_STEPS,
           "decode_ms": statistics.median(dec), "decode_ms_all": dec,
           "tokens_equal": same, "cache_in_place": True,
           "tokens": toks[1].tolist()}
    log(f"[shapes] {RING_ARCH} (uncut) bf16 long_500k ring: a {clen}-token "
        f"prompt into {clen} slots, window {window}, {RING_STEPS} decode "
        f"steps that wrap it (positions {clen} to {clen + RING_STEPS - 1}), "
        f"batch 1, two runs with equal tokens; every cache tensor in the "
        f"prefill's storage after every step; decode "
        f"{rec['decode_ms']:.3f} ms a token (run 2, CUDA events)")
    del eng, params
    torch.cuda.empty_cache()
    return rec


def shapes_phase(torch, F) -> tuple:
    """Phase 10f of the module docstring: the reference's shapes past 4,096
    tokens. ``prefill_32k`` and ``decode_32k`` on ``SHAPE_ARCHS`` in bf16
    (``arch_serve`` at ``SHAPE_BATCH`` x ``SHAPE_PROMPT`` into
    ``cache_len_for(decode_32k)`` slots, rows ``flash_attention [<arch>
    32k prefill]``), ``SHAPE_F32_ARCH``'s float32 decode step at 32k
    (``f32_long_step``), then ``long_500k``: ``LONG_ARCH`` over
    ``LONG_PROMPT`` tokens (``long_rwkv``) and ``RING_ARCH``'s wrapped
    ring (``ring_wrap``). Returns the rows of the ``kernels`` line and the
    ``shapes`` section of ``build/chip_smoke.json``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.specs import cache_len_for
    from repro_torch.models.config import SHAPES
    rows, out = [], {"32k": {}}
    for i, arch in enumerate(SHAPE_ARCHS):
        clen = cache_len_for(get_arch(arch), SHAPES["decode_32k"])
        r, out["32k"][arch] = arch_serve(
            torch, F, arch, None, SHAPE_PROMPT, 360 + i, batch=SHAPE_BATCH,
            cache_len=clen, tag="32k prefill")
        out["32k"][arch]["batch_cut"] = (
            f"batch {SHAPE_BATCH}; the reference's prefill_32k and "
            f"decode_32k take {SHAPES['prefill_32k'].global_batch} and "
            f"{SHAPES['decode_32k'].global_batch}")
        log(f"[shapes] {arch} 32k cut: {out['32k'][arch]['batch_cut']}")
        rows += r
    out["32k_f32"] = f32_long_step(torch, SHAPE_F32_ARCH, SHAPE_PROMPT, 362)
    r, out["500k"] = long_rwkv(torch, 363)
    rows += r
    out["ring"] = ring_wrap(torch, 364)
    return rows, out


def _digest(torch, t) -> str:
    """sha1 of a tensor's bytes (compared across ranks)."""
    import hashlib
    return hashlib.sha1(t.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def _mesh_serve(torch, env, seed: int) -> dict:
    """One rank's serve run of the mesh phase: its shard of MESH_ARCH's
    weights (drawn from ``seed``, cut as they are drawn),
    ``Engine.generate`` at MESH_SERVE_SHAPE twice (flash launches, CUDA
    events around the prefill and each decode step, the prefill's logits
    of the rank's rows kept), then at data 1 the prefill's last hidden
    state (``forward_hidden``)."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, ServeConfig
    cfg, cut = cut_arch(MESH_ARCH, None)
    b, sp, new = MESH_SERVE_SHAPE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = specs.rank_init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), env)
    wbytes = _tree_bytes(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, sp)).astype(np.int32)
    eng = Engine(cfg, params, ServeConfig(cache_len=sp + new,
                                          max_new_tokens=new))
    marks = {"prefill": [], "decode": []}
    logits = []
    prefill = event_wrap(torch, eng._prefill, marks["prefill"])

    def kept(*args):
        out = prefill(*args)
        logits.append(out[0])
        return out
    eng._prefill = kept
    eng._decode = event_wrap(torch, eng._decode, marks["decode"])
    toks, launches, walls = [], [], []
    for _ in range(2):
        TF.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(eng.generate(prompts))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(TF.LAUNCHES)
    rec = {"cut": cut, "weight_bytes": wbytes, "tokens": toks,
           "flash_launches": launches, "init_s": init_s, "walls_s": walls,
           "logits_equal": bool(torch.equal(logits[0], logits[1])),
           "logits_digest": _digest(torch, logits[1]),
           "prefill_ms": marks["prefill"][1][0].elapsed_time(
               marks["prefill"][1][1]),
           "decode_ms": statistics.median(
               a.elapsed_time(z) for a, z in marks["decode"][new:]),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "reserved_bytes": torch.cuda.max_memory_reserved()}
    del logits
    if env.mesh.shape["data"] == 1:   # held against the local path
        t0 = time.perf_counter()
        with torch.inference_mode():
            x, _ = T.forward_hidden(cfg, eng.params, torch.as_tensor(
                prompts, device="cuda"), remat=False)
            rec["hidden"] = x[:, -1].float().cpu().numpy()
        rec["hidden_s"] = time.perf_counter() - t0
        del x
    del eng, params
    torch.cuda.empty_cache()
    return rec


def _mesh_train(torch, env, seed: int) -> dict:
    """One rank's train run of the mesh phase: its shard of MESH_TRAIN's
    cut of MESH_ARCH, its rows of a seeded batch, two forward and backward
    passes (loss and every gradient leaf bit-equal; digests of the leaves
    every rank holds whole), then one ``train_step`` (CUDA events; the
    state finite and in place; digests of the whole leaves after it)."""
    from repro_torch import sharding as SH
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           shard_batch)
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.launch import specs
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    _, _, layers, (b, s) = MESH_TRAIN
    cfg, cut = cut_arch(MESH_ARCH, layers)
    torch.cuda.reset_peak_memory_stats()
    params = specs.rank_init_params(
        cfg, torch.Generator(device="cuda").manual_seed(seed), env)
    batch = shard_batch(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, s, b, seed=seed)).packed_batches()), None, env.mesh)
    TF.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (l1, _), g1 = TS.value_and_grad(cfg, params, batch, remat=True)
    launches = (TF.LAUNCHES, TF.BWD_LAUNCHES)
    (l2, _), g2 = TS.value_and_grad(cfg, params, batch, remat=True)
    torch.cuda.synchronize()
    passes_s = time.perf_counter() - t0
    paths = [p for p, _ in SH.tree_paths(params)]
    whole = [p for p in paths if not SH.leaf_axes(p, env)]
    differ = [p for p, a, z in zip(paths, adamw.tree_leaves(g1),
                                   adamw.tree_leaves(g2))
              if not torch.equal(a, z)]
    grads = dict(SH.tree_paths(g1))
    rec = {"cut": cut, "rows": int(batch["inputs"].shape[0]),
           "loss": float(l1), "loss_bits_equal": bool(torch.equal(l1, l2)),
           "passes_s": passes_s,
           "leaves": len(paths), "leaves_differ": differ,
           "flash_launches": launches,
           "grad_digests": {p: _digest(torch, grads[p]) for p in whole}}
    del g1, g2, grads
    opt = TS.opt_config_for(cfg)
    state = {"params": params, "opt": adamw.init(params)}
    ptrs = [t.data_ptr() for t in adamw.tree_leaves(state)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    state, m = TS.train_step(cfg, opt, state, batch, remat=True)
    ev[1].record()
    torch.cuda.synchronize()
    leaves = adamw.tree_leaves(state)
    pdict = dict(SH.tree_paths(state["params"]))
    rec.update({
        "step_ms": ev[0].elapsed_time(ev[1]),
        "step_loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "in_place": [t.data_ptr() for t in leaves] == ptrs,
        "finite": all(bool(torch.isfinite(t).all()) for t in leaves
                      if t.is_floating_point()),
        "param_digests": {p: _digest(torch, pdict[p]) for p in whole},
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "reserved_bytes": torch.cuda.max_memory_reserved()})
    del state, params, leaves, pdict
    torch.cuda.empty_cache()
    return rec


def mesh_rank(mesh, job: dict) -> dict:
    """What each rank of the mesh phase runs (``launch/mesh.py::spawn``,
    one process a rank): ``job["serve"]``'s and ``job["train"]``'s seeds,
    each run under the runtime mesh's env with ``job["fsdp"]``."""
    import torch
    from repro_torch import sharding as SH
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"coords": mesh.coords}
    with SH.axis_env(mesh, ("data",), fsdp=job["fsdp"]) as env:
        if "serve" in job:
            out["serve"] = _mesh_serve(torch, env, job["serve"])
        if "train" in job:
            out["train"] = _mesh_train(torch, env, job["train"])
    return out


def _mesh_serve_checks(ranks: list, shape: tuple, fsdp: bool) -> dict:
    """Across a served mesh's ranks: two runs' tokens equal on every rank
    and equal on every rank, one flash launch a layer a prefill on every
    rank, the prefill's logits bit-equal across the runs and on the model
    ranks of a data row (and so the hidden states, where kept). Logs each
    rank's times and peak."""
    recs = [r["serve"] for r in ranks]
    b, sp, new = MESH_SERVE_SHAPE
    layers = cut_arch(MESH_ARCH, None)[0].num_layers
    for r, rec in zip(ranks, recs):
        t0, t1 = rec["tokens"]
        check(np.array_equal(t0, t1) and t0.shape == (b, new),
              f"mesh {shape} rank {r['coords']}: two runs' tokens differ")
        check(np.array_equal(t0, recs[0]["tokens"][0]),
              f"mesh {shape}: rank {r['coords']}'s tokens differ from rank "
              "(0, 0)'s")
        check(rec["flash_launches"] == [layers, layers],
              f"mesh {shape} rank {r['coords']}: flash launches "
              f"{rec['flash_launches']}, expected {layers} a prefill")
    for r, rec in zip(ranks, recs):
        first = next(q["serve"] for q in ranks
                     if q["coords"][0] == r["coords"][0])
        check(rec["logits_equal"]
              and rec["logits_digest"] == first["logits_digest"]
              and np.array_equal(rec.get("hidden"), first.get("hidden")),
              f"mesh {shape} rank {r['coords']}: the prefill's logits differ "
              "between its runs or from its data row's first model rank's, "
              "or its hidden states do")
    for r, rec in zip(ranks, recs):
        log(f"[mesh] {MESH_ARCH} ({rec['cut']}) bf16 served under mesh "
            f"{shape}{' fsdp' if fsdp else ''}, rank {r['coords']}: batch "
            f"{b} x prompt {sp}, {new} new, two runs' tokens equal and "
            f"equal on every rank, the prefill's logits alike on the data "
            f"row's model ranks, {rec['flash_launches'][1]} flash "
            f"launches a prefill; run 2 (CUDA events on this rank, the "
            f"card shared by {len(ranks)} ranks): prefill "
            f"{rec['prefill_ms']:.3f} ms, decode {rec['decode_ms']:.4f} ms "
            f"a token; walls: weights {rec['init_s']:.1f} s, generates "
            f"{rec['walls_s'][0]:.1f} and {rec['walls_s'][1]:.1f} s; shard "
            f"{rec['weight_bytes']} B, peak {rec['peak_bytes']} B, reserve "
            f"{rec['reserved_bytes']} B")
    return {"mesh": list(shape), "fsdp": fsdp,
            "tokens": recs[0]["tokens"][1].tolist(),
            "ranks": [{"coords": list(r["coords"]),
                       **{k: v for k, v in q.items()
                          if k not in ("tokens", "hidden")}}
                      for r, q in zip(ranks, recs)]}


def mesh_phase(torch) -> dict:
    """Phase 10g of the module docstring: MESH_ARCH on meshes of processes
    sharing the card over gloo (``launch/mesh.py::spawn``, each spawn
    within MESH_LIMIT_S): served under each of MESH_SERVE, the data-1
    mesh's last hidden states against the one-process local path on the
    same weights (MESH_HIDDEN_TOL); the last mesh of MESH_SERVE also
    trains MESH_TRAIN. Checks the ranks' summed reserves against the
    card. Returns the ``mesh`` section of ``build/chip_smoke.json``."""
    from repro_torch.launch import mesh as LM
    from repro_torch.models import transformer as T
    card = torch.cuda.get_device_properties(0).total_memory
    out = {"serve": [], "card_bytes": card}
    tmesh, tfsdp, _, _ = MESH_TRAIN
    for i, (shape, fsdp) in enumerate(MESH_SERVE):
        job = {"fsdp": fsdp, "serve": 370}
        if (shape, fsdp) == (tmesh, tfsdp):
            job["train"] = 371
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = LM.spawn(mesh_rank, *shape, backend="gloo", device="cuda",
                         args=(job,), timeout=MESH_LIMIT_S)
        wall = time.perf_counter() - t0
        rec = _mesh_serve_checks(ranks, shape, fsdp)
        rec["spawn_wall_s"] = wall
        runs = [r["serve"] for r in ranks] + [r["train"] for r in ranks
                                              if "train" in r]
        reserve = sum(q["reserved_bytes"] for q in runs[:len(ranks)])
        check(reserve < card, f"mesh {shape}: the ranks' reserves {reserve} "
              f"B exceed the card's {card} B")
        if shape[0] == 1:
            cfg, _ = cut_arch(MESH_ARCH, None)
            b, sp, _ = MESH_SERVE_SHAPE
            prompts = np.random.default_rng(370).integers(
                0, cfg.vocab_size, (b, sp)).astype(np.int32)
            params = T.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(370))
            with torch.inference_mode():
                x, _ = T.forward_hidden(cfg, params, torch.as_tensor(
                    prompts, device="cuda"), remat=False)
                want = x[:, -1].float().cpu().numpy().astype(np.float64)
            del params, x
            torch.cuda.empty_cache()
            got = ranks[0]["serve"]["hidden"].astype(np.float64)
            rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            rec["hidden_vs_local"] = {
                "rel_err": rel, "max_abs_err": float(np.abs(got - want).max()),
                "max_abs": float(np.abs(want).max()), "tol": MESH_HIDDEN_TOL}
            check(rel <= MESH_HIDDEN_TOL,
                  f"mesh {shape}: the prefill's last hidden state is "
                  f"{rel:.3g} off the one-process local path's (tol "
                  f"{MESH_HIDDEN_TOL})")
            log(f"[mesh] mesh {shape}: the prefill's last hidden state "
                f"(4 x 2048) against the one-process local path on the "
                f"same weights: ||a - b|| / ||b|| {rel:.4g} (tol "
                f"{MESH_HIDDEN_TOL}), max abs err "
                f"{rec['hidden_vs_local']['max_abs_err']:.4g} of max "
                f"{rec['hidden_vs_local']['max_abs']:.4g}")
        log(f"[mesh] mesh {shape}: the ranks' summed peak "
            f"{sum(q['peak_bytes'] for q in runs[:len(ranks)])} B and reserve"
            f" {reserve} B of the card's {card} B; spawn wall {wall:.1f} s")
        out["serve"].append(rec)
        if "train" in job:
            out["train"] = _mesh_train_checks(ranks, card)
    return out


def _mesh_train_checks(ranks: list, card: int) -> dict:
    """Across the trained mesh's ranks: each rank's two passes bit-equal,
    the loss and grad norm equal on every rank, the whole leaves'
    gradients and updated params equal on every rank, the state finite
    and in place. Logs each rank's step ms and peak."""
    shape, fsdp, layers, (b, s) = MESH_TRAIN
    recs = [r["train"] for r in ranks]
    first = recs[0]
    for r, rec in zip(ranks, recs):
        c = r["coords"]
        check(rec["loss_bits_equal"] and not rec["leaves_differ"],
              f"mesh {shape} rank {c}: two passes differ: "
              f"{rec['leaves_differ']}")
        for k in ("loss", "step_loss", "grad_norm", "grad_digests",
                  "param_digests"):
            check(rec[k] == first[k], f"mesh {shape} rank {c}: {k} differs "
                  "from rank (0, 0)'s")
        check(rec["in_place"] and rec["finite"] and np.isfinite(rec["loss"])
              and np.isfinite(rec["grad_norm"]),
              f"mesh {shape} rank {c}: state in place {rec['in_place']}, "
              f"finite {rec['finite']}")
        log(f"[mesh] {MESH_ARCH} ({rec['cut']}) bf16 trained under mesh "
            f"{shape}{' fsdp' if fsdp else ''}, rank {c}: {rec['rows']} x "
            f"{s} of the {b} x {s} batch, remat; two passes bit-equal in "
            f"{rec['passes_s']:.1f} s (loss "
            f"{rec['loss']!r}, {rec['leaves']} leaves), flash launches "
            f"{rec['flash_launches'][0]} forward, {rec['flash_launches'][1]}"
            f" backward a pass; one step {rec['step_ms']:.1f} ms (CUDA "
            f"events, the card shared by {len(ranks)} ranks), grad norm "
            f"{rec['grad_norm']!r}, the state finite and in place; peak "
            f"{rec['peak_bytes']} B, reserve {rec['reserved_bytes']} B")
    reserve = sum(q["reserved_bytes"] for q in recs)
    check(reserve < card, f"mesh train: the ranks' reserves {reserve} B "
          f"exceed the card's {card} B")
    return {"mesh": list(shape), "fsdp": fsdp, "layers": layers,
            "batch": [b, s], "loss": first["loss"],
            "grad_norm": first["grad_norm"],
            "ranks": [{"coords": list(r["coords"]),
                       **{k: v for k, v in q.items()
                          if not k.endswith("digests")}}
                      for r, q in zip(ranks, recs)]}


def standalone_phase(torch, F):
    """Phase 10 of the module docstring: the three standalone kernels.
    Returns their rows of the ``kernels`` line and the ``standalone``
    section of ``build/chip_smoke.json``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import inplace_rmsnorm as TR
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import ref as TREF
    from repro_torch.kernels import wkv_chunk as TW
    rng = np.random.default_rng(15)

    # the WKV phases' resources: no stack frame and no spills in any
    wkv_res = build.ptxas_resources("wkv_chunk")
    check(len(wkv_res) >= TW.KERNELS_PER_CALL,
          f"wkv_chunk: {len(wkv_res)} entry functions in the ptxas report")
    for fn, res in wkv_res.items():
        check(res["stack"] == res["spill_stores"] == res["spill_loads"] == 0
              and res["registers"] > 0, f"wkv_chunk {fn}: {res}")
    log(f"[standalone] wkv_chunk ptxas: {json.dumps(wkv_res)}")
    types = {"f32": torch.float32, "bf16": torch.bfloat16}

    def normal(*shape, dtype=torch.float32):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).cuda().to(dtype)

    def tol(name, dt):
        if dt == "f32":
            return STANDALONE_TOL[name]
        return FLASH_BF16_TOL if name == "flash_attention" else BF16_TOL

    def wkv_inputs(b, s, h, d, shift=0.0):
        r, k, v, z = (normal(b, s, h, d) for _ in range(4))
        logw = -torch.exp(z * 0.5 + shift)
        return r, k, v, logw, torch.exp(logw), normal(h, d) * 0.1

    def one_float_in(t):
        # the same values in a view that starts one float into its storage
        buf = torch.empty(t.numel() + 1, device=t.device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    errs = {(n, dt): 0.0 for n in STANDALONE for dt in types}
    oracle = dict.fromkeys(STANDALONE, 0.0)

    def hold(name, dt, got, want, ref, label):
        errs[name, dt] = max(errs[name, dt], close_err(
            torch, got, want, tol(name, dt), f"{label} against plain"))
        if ref is not None:
            oracle[name] = max(oracle[name], close_err(
                torch, got, ref, tol(name, dt), f"{label} against oracle"))

    # at the reference's test shapes
    for n, d in RMS_CASES:
        for dt, ty in types.items():
            x, g, r = normal(n, d, dtype=ty), normal(d, dtype=ty), \
                normal(n, d, dtype=ty)
            got = TR.rmsnorm_scale_residual_inplace(x.clone(), g, r)
            hold("rmsnorm_inplace", dt, got,
                 TR.rmsnorm_plain(x.clone(), g, r),
                 TREF.rmsnorm_scale_residual(x, g, r),
                 f"rmsnorm ({n}, {d}) {dt}")
    for s, t, h, d, causal, scale in FLASH_CASES:
        for dt, ty in types.items():
            q = (normal(s, h, d) * scale).to(ty)
            k, v = normal(t, h, d, dtype=ty), normal(t, h, d, dtype=ty)
            hold("flash_attention", dt,
                 TF.flash_attention_kernel(q, k, v, causal),
                 TF.flash_plain(q, k, v, causal, 64, 64),
                 TREF.attention(q, k, v, causal),
                 f"flash ({s}, {t}, {h}, {d}, causal={causal}, q x "
                 f"{scale:g}) {dt}")
    for (s, h, d, qc), shift, skew in (
            [(c, 0.0, False) for c in WKV_CASES]
            + [(c, 3.0, False) for c in WKV_STRONG]
            + [(c, 0.0, True) for c in WKV_UNALIGNED]):
        r, k, v, logw, w, u = wkv_inputs(2, s, h, d, shift)
        if skew:
            r, k, v, logw = (one_float_in(t) for t in (r, k, v, logw))
            check(r.data_ptr() % 16 != 0, "wkv: the skewed input is aligned")
        y, st = TW.wkv_chunk_kernel(r, k, v, logw, u, q=qc)
        y0, st0 = TW.wkv_plain(r, k, v, logw, u, qc)
        ys, sts = wkv_sequential(torch, r, k, v, w, u)
        label = (f"wkv (2, {s}, {h}, {d}, q={qc}"
                 f"{', strong decay' if shift else ''}"
                 f"{', one float into storage' if skew else ''})")
        hold("wkv_chunk", "f32", y, y0, ys, label + " y")
        hold("wkv_chunk", "f32", st, st0, sts, label + " state")
    torch.cuda.synchronize()
    log(f"[standalone] reference shapes: kernels against plain versions "
        f"{json.dumps({f'{n} {dt}': e for (n, dt), e in errs.items()})}; "
        f"against the oracles {json.dumps(oracle)}")

    # full width
    n, d = RMS_FULL
    rms_in = {dt: (normal(n, d, dtype=ty), normal(d, dtype=ty),
                   normal(n, d, dtype=ty)) for dt, ty in types.items()}
    fs, ft, fh, fd = FLASH_FULL
    fl_in = {dt: (normal(fs, fh, fd, dtype=ty), normal(ft, fh, fd, dtype=ty),
                  normal(ft, fh, fd, dtype=ty)) for dt, ty in types.items()}
    wb, ws, wh, wd, wq = WKV_FULL
    wkv_in = wkv_inputs(wb, ws, wh, wd)
    wkv_args = wkv_in[:4] + wkv_in[5:]
    xs = {dt: rms_in[dt][0].clone() for dt in types}
    rises, outs = {}, {}
    torch.cuda.synchronize()
    # the main path: each entry point once per type, counts reset before
    for mod in (TR, TF, TW):
        mod.reset_launches()
    for dt in types:
        x = xs[dt]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = TO.rmsnorm_residual(x, *rms_in[dt][1:])
        torch.cuda.synchronize()
        rises[dt] = torch.cuda.max_memory_allocated() - base
        check(out.data_ptr() == x.data_ptr(),
              f"rmsnorm {dt}: the result is not x's storage")
        check(rises[dt] < x.numel() * x.element_size(),
              f"rmsnorm {dt}: peak memory rose {rises[dt]} B, x is "
              f"{x.numel() * x.element_size()} B")
        outs["rmsnorm_inplace", dt] = out
    for dt in types:
        outs["flash_attention", dt] = TO.flash_attention(*fl_in[dt])
    outs["wkv_chunk", "f32"] = TW.wkv_chunk_kernel(*wkv_args, q=wq)
    torch.cuda.synchronize()
    launches = {"rmsnorm_inplace": TR.LAUNCHES,
                "flash_attention": TF.LAUNCHES, "wkv_chunk": TW.LAUNCHES}
    check(launches == {"rmsnorm_inplace": 2, "flash_attention": 2,
                       "wkv_chunk": TW.KERNELS_PER_CALL},
          f"standalone full width: launches {launches}")
    full_err = {}
    for dt in types:
        x0, g, r = rms_in[dt]
        full_err["rmsnorm_inplace", dt] = close_err(
            torch, outs["rmsnorm_inplace", dt],
            TR.rmsnorm_plain(x0.clone(), g, r),
            tol("rmsnorm_inplace", dt), f"rmsnorm full width {dt}")
        full_err["flash_attention", dt] = close_err(
            torch, outs["flash_attention", dt],
            TF.flash_plain(*fl_in[dt], True, 128, 128),
            tol("flash_attention", dt), f"flash full width {dt}")
    y0, st0 = TW.wkv_plain(*wkv_args, wq)
    y, st = outs["wkv_chunk", "f32"]
    full_err["wkv_chunk", "f32"] = max(
        close_err(torch, y, y0, tol("wkv_chunk", "f32"), "wkv full width y"),
        close_err(torch, st, st0, tol("wkv_chunk", "f32"),
                  "wkv full width state"))
    for key, e in full_err.items():
        errs[key] = max(errs[key], e)
    del outs, y0, st0, y, st

    # times at full width
    timing = {}
    for dt, ty in types.items():
        x0, g, r = rms_in[dt]
        esize = x0.element_size()
        xa, xb, gf = x0.clone(), x0.clone(), g.float()
        cost = rmsnorm_cost(n, d, esize)
        timing["rmsnorm_inplace", dt] = {
            # g cast to f32 once, as the wrapper does per call
            "ms": time_auto(torch, lambda: TR.rmsnorm_scale_residual_inplace(
                xa, gf, r)),
            "plain_ms": time_ms(torch, lambda: TR.rmsnorm_plain(xb, g, r), 1),
            # two calls: F.rms_norm, then the residual add
            "library_ms": time_auto(torch, lambda: torch.add(
                r, F.rms_norm(x0, (d,), g, 1e-6))),
            "bound_ms": cost_ms(cost), "bound_by": cost_by(cost)}
        q, k, v = fl_in[dt]
        qh, kh, vh = (a.permute(1, 0, 2)[None].contiguous()
                      for a in (q, k, v))
        cost = attention_cost(fs, ft, fh, fd, True, esize)
        timing["flash_attention", dt] = {
            "ms": time_auto(torch, lambda: TF.flash_attention_kernel(
                q, k, v, True)),
            "plain_ms": time_ms(torch, lambda: TF.flash_plain(
                q, k, v, True, 128, 128), 1),
            # (1, H, S, D) copies made outside the timed call; at S = T
            # is_causal's mask is the reference's
            "library_ms": time_auto(torch, lambda: (
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=True))),
            "bound_ms": cost_ms(cost), "bound_by": cost_by(cost)}
    cost = wkv_cost(wb, ws, wh, wd, wq)
    timing["wkv_chunk", "f32"] = {
        "ms": time_auto(torch, lambda: TW.wkv_chunk_kernel(*wkv_args, q=wq)),
        "plain_ms": time_ms(torch, lambda: TW.wkv_plain(*wkv_args, wq), 1),
        "library_ms": None, "bound_ms": cost_ms(cost),
        "bound_by": cost_by(cost)}

    paths = {"rmsnorm_inplace": f"qwen2.5-3b width: x ({n}, {d}), f32",
             "flash_attention": f"qwen2.5-3b width: causal S = T = {fs}, "
                                f"{fh} heads of {fd}, f32",
             "wkv_chunk": f"rwkv6-1.6b width: B {wb}, S {ws}, {wh} heads "
                          f"of {wd}, q {wq}, f32"}
    rows = []
    for name in STANDALONE:
        source, replaces = KERNELS[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "path": paths[name],
               "launches": launches[name],
               "max_abs_err": errs[name, "f32"],
               **timing[name, "f32"]}
        if (name, "bf16") in timing:
            row["bf16"] = dict(timing[name, "bf16"],
                               max_abs_err=errs[name, "bf16"])
        rows.append(row)
    section = {
        "launches": launches, "errors": {f"{n} {dt}": e for (n, dt), e in
                                         errs.items()},
        "oracle_errors": oracle,
        "full_width_errors": {f"{n} {dt}": e for (n, dt), e in
                              full_err.items()},
        "rmsnorm_peak_rise_bytes": rises,
        "wkv_ptxas": wkv_res,
        "wkv_workspace_bytes": 4 * TW.workspace_floats(wb, ws, wh, wd, wq),
        "times": {f"{n} {dt}": v for (n, dt), v in timing.items()},
        "shapes": {"rmsnorm": RMS_FULL, "flash_attention": FLASH_FULL,
                   "wkv_chunk": WKV_FULL}}
    log(f"[standalone] full width: launches {launches}, rmsnorm result is "
        f"x's storage, peak rise {rises} B; against plain "
        f"{json.dumps(section['full_width_errors'])}; times (ms) "
        f"{json.dumps(section['times'])}")
    del rms_in, fl_in, wkv_in, wkv_args, xs
    row, section["flash_attention_bwd"] = flash_bwd_standalone(torch, F,
                                                               normal)
    rows.append(row)
    row, section["wkv_chunk_bwd"] = wkv_bwd_standalone(
        torch, normal, wkv_inputs, one_float_in)
    rows.append(row)
    return rows, section


def kernel_times(torch, F, K, ex, cp, weights=None, quant=None,
                 plain_too=True, library=False, only=None, kinds=None):
    """Per kernel (of ``only``, default all; its specs of ``kinds``,
    default all) over one forward of ``cp``: device ms (CUDA events), the
    plain version's ms, the bound, the library call's ms (f32, where every
    op has one) and the specs."""
    specs, ws, descs, state = ex.program(cp, None, weights, quant=quant)
    per = {}
    for spec, wt, d in zip(specs, ws, descs):
        name = K.kernel_of(spec)
        if only is not None and name not in only or \
                kinds is not None and spec.kind not in kinds:
            K.apply_op(state, spec, wt, d)
            continue
        row = per.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0, "library_ms": 0.0,
                                    "launches": 0, "specs": []})
        a = state.clone()
        row["ms"] += time_auto(torch, lambda: K.apply_op(a, spec, wt, d))
        if plain_too:
            b = state.clone()
            row["plain_ms"] += time_ms(
                torch, lambda: K.apply_plain(b, spec, wt), 1, warm=False)
        if library and row["library_ms"] is not None:
            call = library_call(torch, F, spec)
            row["library_ms"] = (None if call is None else
                                 row["library_ms"] + time_auto(torch, call))
        K.apply_op(state, spec, wt, d)
        row["bound_ms"] += bound_ms(spec)
        row["launches"] += 1
        row["specs"].append(spec)
    torch.cuda.synchronize()
    for row in per.values():
        row["bound_by"] = bound_by(row["specs"])
        if not plain_too:
            row["plain_ms"] = None
        if not library:
            row["library_ms"] = None
    return per


def launch_floor_ms(torch, build) -> dict:
    """Device ms of one launch of an empty kernel through the arena
    kernels' launcher (``build.entry("launch_floor")``, on the current
    stream, CUDA events over 200 launches): one CTA, a cooperative grid of
    one CTA an SM, and a grid of two CTAs an SM."""
    fn = build.entry("launch_floor")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(grid: int, group: int) -> None:
        build.check(fn(None, None, None, None, 0, grid, group, 0,
                       torch.cuda.current_stream().cuda_stream),
                    "launch_floor")
    return {"one_cta_ms": time_ms(torch, lambda: launch(1, 0), 200),
            "cooperative_grid_ms": time_ms(torch, lambda: launch(sms, sms),
                                           200),
            "two_an_sm_ms": time_ms(torch, lambda: launch(2 * sms, 0), 200),
            "sms": sms}


def softmax_matmul_times(torch, F, K, X, build, ex, compile, flag, cp, fw,
                         fq, compiled):
    """The softmax and matmul grids timed (CUDA events, after a warm-up):
    on the flagship int8 at batch 1, 2 and 8 (one softmax a sample) and
    ``allops`` int8 (``kernel_times``, beside the plain versions); on the
    hand-built specs (``HAND_SOFTMAX``, ``HAND_MATMUL``, and the pads of
    ``HAND_PAD``) beside the plain version, the bound and, f32,
    ``torch.softmax``, ``torch.matmul`` or ``F.pad`` (TF32 off); and the
    launch floor. A ``[softmax]``/``[matmul]`` line per zoo spec timed.
    Returns the numbers."""
    out = {"zoo": {}, "hand_built": {}, "grids": []}
    for batch in (1, 2, 8):
        c, w, q = cp, fw, fq
        if batch > 1:
            c = compile(flag, backend="numpy", batch=batch)
            w = X.synth_weights(c.graph, 0)
            q = X.calibrate(c.graph, 0, w)
        r = kernel_times(torch, F, K, ex, c, w, q,
                         only={"arena_softmax"})["arena_softmax"]
        label = f"flagship int8 batch {batch}"
        out["grids"] += [grid_row(torch, K, sp, f"{label} #{i}")
                         for i, sp in enumerate(r.pop("specs"))]
        out["zoo"][label] = r
    r = kernel_times(torch, F, K, ex, compiled["allops int8"],
                     only={"arena_matmul", "arena_softmax"})
    for name, row in r.items():
        out["grids"] += [grid_row(torch, K, sp, f"allops int8 {name}")
                         for sp in row.pop("specs")]
        out["zoo"][f"allops int8 {name}"] = row
    for label, make, args in HAND_SOFTMAX + HAND_MATMUL + HAND_PAD:
        spec, nbytes = make(*args)
        state = seeded_state(torch, spec, nbytes)
        a, b = state.clone(), state.clone()
        row = {"ms": time_auto(torch, lambda: K.apply_op(a, spec)),
               "plain_ms": time_ms(torch, lambda: K.apply_plain(b, spec), 1,
                                   warm=False),
               "bound_ms": bound_ms(spec), "bound_by": bound_by([spec]),
               "library_ms": None}
        if spec.dtype == "f32":
            row["library_ms"] = time_auto(torch,
                                          library_call(torch, F, spec))
        out["hand_built"][label] = row
    out["launch_floor"] = launch_floor_ms(torch, build)
    log("[time] softmax and matmul (ms): " + json.dumps(
        {k: v for k, v in out.items() if k != "grids"}))
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.core import zoo
    from repro_torch.core import exec as X
    from repro_torch.core.pipeline import compile
    from repro_torch.kernels import arena_ops as K
    from repro_torch.kernels import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    phase_s = {}
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        log(f"[phase] {name}: {phase_s[name]:.1f} s")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}; torch: {kind}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    build.load()
    log(f"[build] {build.LAST_BUILD_S:.1f} s into {build.build_dir()}")
    log(build.ptxas_report())
    phase_done("build")

    # 3. every kernel against its plain version
    be = X.get_backend("cuda")
    errs = {}
    flag = zoo.mobilenet_v1(0.25, 128, 1)
    cp8 = compile(flag, backend="numpy")
    specs8, chains, _ = compare_program(torch, K, be, cp8, "flagship int8",
                                        errs)
    cp32 = compile(zoo.mobilenet_v1(0.25, 128, 4), backend="numpy")
    chains += compare_program(torch, K, be, cp32, "flagship f32", errs)[1]
    chains += compare_program(torch, K, be,
                              compile(flag, backend="numpy", batch=2),
                              "flagship batch 2", errs)[1]
    big = zoo.TABLE3_MODELS["mobilenet_v1_1.0_224_8bit"][0]()
    cpb = compile(big, backend="numpy")
    chains += compare_program(torch, K, be, cpb, "mobilenet_v1_1.0_224_8bit",
                              errs)[1]

    def new_kinds(spec) -> bool:
        return spec.kind in ("pool", "elementwise", "concat", "mean",
                             "matmul", "pad", "fully_connected") or (
                                 spec.kind in K.ROW_KINDS and _el(
                                 spec.out_shape[-2:]) > WIDE_ROW)

    compiled = {}
    for label, graph in (
            ("resnet_50_v2", zoo.resnet50_v2(224, 4)),
            ("resnet_50_v2 int8", zoo.resnet50_v2(224, 1)),
            ("densenet_121", zoo.densenet121(224, 4)),
            ("allops", allops_graph(4)), ("allops int8", allops_graph(1))):
        compiled[label] = c = compile(graph, backend="cuda")
        _, _, n = compare_program(torch, K, be, c, label, errs,
                                  select=new_kinds)
        check(n > 0, f"{label}: nothing compared")
    for dtype in ("f32", "i8"):
        wt = torch.randint(-127, 128, (3, 3, 16, 16), dtype=torch.int8) \
            if dtype == "i8" else torch.randn(3, 3, 16, 16) * 0.2
        for cat in (False, True):
            spec, nbytes = fused_demo_spec(dtype, 28, 28, 16,
                                           arena_cat=cat)
            chains.append(compare_spec(
                torch, K, spec, nbytes, [wt.cuda()], errs,
                f"fused chain with pool and elementwise stages, {dtype}"
                + (", its concat over the chain input it reads (staged "
                   "terminal)" if cat else "")))
    spec, nbytes = deep_chain_spec()
    check(K.buffer_plan(spec).on_global("tile"), "chain footprint not global")
    chains.append(compare_spec(
        torch, K, spec, nbytes, [torch.randn(3, 3, 6_000, 8).cuda() * 0.02],
        errs, "fused chain with a 216,000 B footprint (global slices)"))
    check([r["staged_terminal"] for r in chains].count(True) == 2
          and all(r["grid"] > 1 for r in chains),
          "every chain runs on more than one CTA, and the staged terminal "
          "runs")
    spec, nbytes = wide_row_spec(4_096, 16)
    check(not K.buffer_plan(spec).on_global("tile"),
          "a wide row's tiles must stage in shared memory")
    compare_spec(torch, K, spec, nbytes, [torch.randn(3, 3, 4, 16).cuda()],
                 errs, "conv with a 65,536-output row (column tiles)")
    spec, nbytes = deep_footprint_spec()
    check(K.buffer_plan(spec).on_global("tile"), "footprint not global")
    compare_spec(torch, K, spec, nbytes,
                 [torch.randn(3, 3, 6_000, 8).cuda() * 0.02], errs,
                 "conv with a 216,000 B footprint (global staging slices)")
    # the softmax, matmul and pad grids on hand-built specs where the work
    # shows: a [softmax], [matmul] or [pad] line each, more than one CTA
    # wherever the rows, row blocks, column blocks or units allow
    sm_grids = []
    for label, make, args in (HAND_SOFTMAX + LONG_SOFTMAX + HAND_MATMUL
                              + HAND_PAD):
        spec, nbytes = make(*args)
        compare_spec(torch, K, spec, nbytes, None, errs, label)
        r = grid_row(torch, K, spec, label)
        check(r["grid"] > 1 or spec.in_shape[0][0] == 1,
              f"{label}: one CTA for {r['shape']}")
        sm_grids.append(r)
    check({r["order"] for r in sm_grids if r["kernel"] == "arena_softmax"}
          == {K.EW_ALIGNED, K.EW_OVERLAP, K.EW_DISJOINT}
          and {r["order"] for r in sm_grids
               if r["kernel"] == "arena_matmul"}
          == {K.EW_DISJOINT, K.EW_OVERLAP}
          and {r["order"] for r in sm_grids if r["kernel"] == "arena_pad"}
          == {K.EW_DISJOINT, K.EW_OVERLAP},
          "the hand-built softmaxes, matmuls and pads take every order "
          "word")
    for name in PROGRAM_KERNELS:
        check(name in errs, f"{name} was never held against its plain "
              "version")
    phase_done("kernels vs plain")

    # 4. the flagship slice and its other configurations
    cp = compile(flag, backend="cuda")
    check(cp.verified == "numeric+cuda", f"verified={cp.verified}")
    check(cp.winner == "fuse", f"winner={cp.winner}")
    check(cp.peak_bytes == FLAGSHIP_BYTES, f"peak={cp.peak_bytes}")
    check(len(specs8) == 29, f"{len(specs8)} specs")
    tiers = [ln for ln in cp.log if ln.startswith("verify: cuda")]
    check(tiers and "(flat + row-blocked + streaming)" in tiers[-1],
          f"compile's verify pass skipped a tier: {tiers}")
    log(f"[slice] {tiers[-1]}")
    log(f"[slice] compile(flagship, backend='cuda'): verified={cp.verified} "
        f"winner={cp.winner} peak={cp.peak_bytes} B "
        f"baseline={cp.baseline_bytes} B")
    paths = {}
    paths["mobilenet_v1_0.25_128_8bit"], _, _ = requests(
        torch, K, X, cp, "flagship", 29, FLAGSHIP_BYTES)
    for label, graph, batch, peak, n in (
            ("flagship f32", zoo.mobilenet_v1(0.25, 128, 4), 1, 199_220, 29),
            ("flagship batch 2", flag, 2, 98_957, None),
            ("mobilenet_v1_1.0_224_8bit", big, 1, 517_052, None)):
        c = compile(graph, backend="cuda", batch=batch)
        check(c.peak_bytes == peak, f"{label}: peak {c.peak_bytes} != {peak}")
        n_specs = len(be.program(c)[0])
        check(n is None or n_specs == n, f"{label}: {n_specs} specs")
        log(f"[slice] compile({label}): verified={c.verified} "
            f"winner={c.winner} peak={c.peak_bytes} B")
        requests(torch, K, X, c, label, n_specs, peak, seeds=(0,))
    phase_done("flagship slice")

    # 5. resnet_50_v2 at full width, f32 and int8
    slice_cps = {}
    for label, graph, peak in (
            ("resnet_50_v2", zoo.resnet50_v2(224, 4), RESNET_BYTES),
            ("resnet_50_v2 int8", zoo.resnet50_v2(224, 1), None)):
        t0 = time.perf_counter()
        c = compile(graph, backend="cuda")
        t_compile = time.perf_counter() - t0
        peak = c.peak_bytes if peak is None else peak
        check(c.peak_bytes == peak, f"{label}: peak {c.peak_bytes} != {peak}")
        log(f"[slice] compile({label}, backend='cuda'): verified="
            f"{c.verified} winner={c.winner} peak={c.peak_bytes} B "
            f"baseline={c.baseline_bytes} B ({t_compile:.1f} s)")
        paths[label], _, _ = requests(torch, K, X, c, label,
                                      RESNET_LAUNCHES, peak)
        slice_cps[label] = c
    for name in ("arena_conv", "arena_pool", "arena_elementwise",
                 "arena_mean", "arena_fully_connected", "arena_softmax"):
        check(paths["resnet_50_v2"][name] > 0,
              f"{name} never launched on resnet_50_v2")
    phase_done("resnet_50_v2 slice")

    # 5b. repeated forwards give identical arenas, flat and streaming
    conv_rows, roll_rows = {}, {}
    for label, c, n in (("resnet_50_v2", slice_cps["resnet_50_v2"], 5),
                        ("flagship", cp, 5),
                        ("densenet_121", compiled["densenet_121"], 3)):
        conv_rows[label] = repeat_forwards(torch, K, X, c, label,
                                           X.get_backend("cuda"),
                                           "arena_conv", n)
        roll_rows[label] = repeat_forwards(
            torch, K, X, c, label + " streaming",
            X.get_backend("cuda", mode="streaming"), "arena_stream_roll", n)
    ew_info, head_info = {}, {}
    for label, c in (("resnet_50_v2", slice_cps["resnet_50_v2"]),
                     ("resnet_50_v2 int8", slice_cps["resnet_50_v2 int8"]),
                     ("densenet_121", compiled["densenet_121"])):
        for program, kw in (("flat", {}), ("blocks", {"layout": "blocks"}),
                            ("streaming", {"mode": "streaming"})):
            ex_ = X.get_backend("cuda", **kw)
            if label != "densenet_121":
                ew_info[f"{label} {program}"] = ew_rows(
                    K, ex_, c, f"{label} {program}")
            head_info[f"{label} {program}"] = head_rows(
                K, ex_, c, f"{label} {program}")
    phase_done("repeats")

    # 6. the zoo, and allops
    zoo_rows = {}
    for name, (builder, _, _) in zoo.TABLE3_MODELS.items():
        graph = builder()
        t0 = time.perf_counter()
        c = compile(graph, backend="cuda")
        t_compile = time.perf_counter() - t0
        row = {"winner": c.winner, "arena_bytes": c.peak_bytes,
               "verified": c.verified, "compile_s": t_compile}
        fault = graph_fault(c.graph)
        if fault is not None:
            row["refused"] = {
                "fault": f"{fault[0]} adds {fault[1][0]} and {fault[1][1]}",
                "cuda": refused(lambda: c.execute(), name),
                "numpy": refused(
                    lambda: X.get_backend("numpy").execute(c), name)}
            zoo_rows[name] = row
            log(f"[zoo] {name}: winner={c.winner} arena={c.peak_bytes} B "
                f"compile {t_compile:.1f} s; not executed: "
                f"{row['refused']['fault']} (no backend of either package "
                f"runs it; the cuda and numpy backends both refuse it)")
            continue
        counts, t_cuda, t_np = requests(torch, K, X, c, name, None,
                                        c.peak_bytes, seeds=(0,))
        row.update(launches=sum(counts.values()), execute_s=t_cuda,
                   numpy_s=t_np)
        zoo_rows[name] = row
        if name == "densenet_121":
            paths[name] = counts
        log(f"[zoo] {name}: winner={c.winner} arena={c.peak_bytes} B "
            f"launches={row['launches']} compile {t_compile:.1f} s "
            f"execute {t_cuda:.2f} s (numpy {t_np:.2f} s)")
    run = [n for n, r in zoo_rows.items() if "refused" not in r]
    log(f"[zoo] {len(run)} of {len(zoo_rows)} Table III rows match the "
        f"numpy backend on the card")
    for label in ("allops", "allops int8"):
        c = compiled[label]
        paths[label], _, _ = requests(torch, K, X, c, label, None,
                                      c.peak_bytes)
    for name, path in KERNEL_PATH.items():
        check(paths[path][name] > 0, f"{name} never launched on {path}")
    phase_done("zoo")

    # 7. the row-blocked program on the same plans
    blk = X.get_backend("cuda", layout="blocks")
    blk_errs, blk_paths, blk_rows = {}, {}, {}
    blk_cps = {
        "flagship": cp,
        "flagship f32": compile(zoo.mobilenet_v1(0.25, 128, 4),
                                backend="cuda"),
        "flagship batch 2": compile(flag, backend="cuda", batch=2),
        "resnet_50_v2": slice_cps["resnet_50_v2"],
        "resnet_50_v2 int8": slice_cps["resnet_50_v2 int8"],
        "densenet_121": compile(zoo.densenet121(224, 4), backend="cuda"),
        "mobilenet_v2_1.0_224": compile(
            zoo.TABLE3_MODELS["mobilenet_v2_1.0_224"][0](), backend="cuda"),
        "allops": compiled["allops"], "allops int8": compiled["allops int8"],
    }
    for label, c in blk_cps.items():
        chains += compare_program(torch, K, blk, c, label + " blocks",
                                  blk_errs)[1]
        counts, nbytes, t_b, t_f = blocked_requests(
            torch, K, X, c, label, BLOCK_BYTES.get(label))
        blk_paths[label] = counts
        bp = blk.legalised(c.plan)
        blk_rows[label] = {
            "packing": bp.packing, "rows": bp.total_rows,
            "rowlen": bp.arena_rowlen, "arena_bytes": nbytes,
            "flat_bytes": c.peak_bytes, "launches": sum(counts.values()),
            "execute_s": t_b, "flat_execute_s": t_f}
    for dtype in ("f32", "i8"):
        wt = torch.randint(-127, 128, (3, 3, 16, 16), dtype=torch.int8) \
            if dtype == "i8" else torch.randn(3, 3, 16, 16) * 0.2
        for rowlen in (512, 1024):
            for cat in (False, True):
                spec, rows = fused_demo_spec(dtype, 28, 28, 16, rowlen,
                                             arena_cat=cat)
                chains.append(compare_spec(
                    torch, K, spec, rows, [wt.cuda()], blk_errs,
                    f"blocked fused chain with pool and elementwise "
                    f"stages, {dtype}, rows of {rowlen}"
                    + (", staged terminal" if cat else "")))
    for name, path in BLOCK_KERNEL_PATH.items():
        check(blk_paths[path][name] > 0,
              f"{name} never launched on {path} blocks")
    phase_done("blocks")

    # 8. the streaming program on the same plans
    stm = X.get_backend("cuda", mode="streaming")
    st_errs, st_paths, st_rows = {}, {}, {}
    st_cps = {label: blk_cps[label] for label in (
        "flagship", "flagship f32", "flagship batch 2", "resnet_50_v2",
        "resnet_50_v2 int8", "densenet_121", "mobilenet_v2_1.0_224",
        "allops", "allops int8")}
    for label, c in st_cps.items():
        chains += compare_program(torch, K, stm, c, label + " streaming",
                                  st_errs)[1]
        nbytes, op, where, n_global, n_shared, specs = largest_window(
            K, stm, c)
        # no staged spec takes a window: each runs in place, its stream
        # block only the body's offset (no copy list), its body at its
        # arena offsets
        for sp in specs:
            if K.stream_form(sp) == "stage":
                words = K.descriptor_words(sp)
                check(K.runs_in_place(sp) and words[K.S_BODY] == 32
                      and words[-K.DESC_WORDS + K.D_OUT_OFF]
                      == K.operand_addr(sp, None)[0],
                      f"{label}: staged {sp.kind} takes a window")
        n = {"flagship": 29, "resnet_50_v2": RESNET_LAUNCHES,
             "densenet_121": DENSENET_LAUNCHES}.get(label)
        counts, t_s, t_b = streamed_requests(torch, K, X, c, label, n)
        st_paths[label] = counts
        forms = [K.stream_form(sp) for sp in specs]
        # counts from the specs, not measured: the bytes each form copies
        # beyond its op's own work, in the TPU program (the planner's
        # windows) and in the card's kernels (the rolling tiles'
        # footprints)
        staged = {f: sum(tpu_staging_bytes(K, sp) for sp in specs
                         if K.stream_form(sp) == f)
                  for f in ("roll", "stage", "fused")}
        staged_card = {f: sum(card_staging_bytes(K, sp) for sp in specs
                              if K.stream_form(sp) == f)
                       for f in ("roll", "stage", "fused")}
        st_rows[label] = {
            "specs": len(specs), "roll": forms.count("roll"),
            "stage": forms.count("stage"), "fused": forms.count("fused"),
            "largest_window_bytes": nbytes, "largest_window_op": op,
            "largest_window_in": where, "windows_in_global": n_global,
            "windows_in_shared": n_shared,
            "tpu_staging_bytes": staged, "card_staging_bytes": staged_card,
            "launches": sum(counts.values()), "execute_s": t_s,
            "blocked_execute_s": t_b}
        check(staged_card["stage"] == 0, f"{label}: the card stages "
              f"{staged_card['stage']} B for the staged form")
        log(f"[streaming] {label}: {len(specs)} launches (rolling "
            f"{forms.count('roll')}, staged {forms.count('stage')}, fused "
            f"{forms.count('fused')}), final arena bit-equal to blocked, "
            f"outputs within tolerance of numpy; largest resident window "
            f"{nbytes} B ({op}) "
            + ("run in place, " if where == "in place"
               else f"staged in {where} memory, ") +
            f"{n_global} of {len(specs)} windows in global memory, "
            f"{n_shared} in shared memory; "
            f"staging bytes by form (counts from the specs): TPU program "
            f"{staged}, card {staged_card} "
            f"(execute {t_s:.2f} s, blocked {t_b:.2f} s)")
    # a staged pad whose TPU window (819,200 B) exceeds a CTA's shared
    # memory runs in place too, its chunks over the card
    spec, rows = stream_pad_spec()
    check(K.runs_in_place(spec) and card_staging_bytes(K, spec) == 0
          and K.descriptor_words(spec)[K.S_BODY] == 32
          and K.chunk_grid(spec)[0] > 1,
          "the streaming pad does not run in place over the card")
    compare_spec(torch, K, spec, rows, None, st_errs,
                 "streaming pad (TPU window 819,200 B) in place")
    for name, path in STREAM_KERNEL_PATH.items():
        check(name in st_errs, f"{name} was never held against its plain "
              "version")
        check(st_paths[path][name] > 0, f"{name} never launched on {path} "
              "streaming")
    phase_done("streaming")

    # 9. the standalone DMO depthwise conv through its entry point
    from repro_torch.kernels import dmo_arena_dwconv as D
    from repro_torch.kernels import ops as TO
    gen = torch.Generator().manual_seed(0)
    dmo_in = [(torch.randn(ih, iw, ch, generator=gen),
               torch.randn(k, k, ch, generator=gen))
              for ih, iw, ch, k, _, _ in DMO_CASES]
    K.reset_launches()
    dmo_out = [TO.dmo_dwconv2d(x, wt, st, pd) for (x, wt), (*_, st, pd) in
               zip(dmo_in, DMO_CASES)]
    torch.cuda.synchronize()
    dmo_counts = dict(K.LAUNCHES)
    check(dmo_counts["arena_conv"] == len(DMO_CASES)
          and sum(dmo_counts.values()) == len(DMO_CASES),
          f"dmo_dwconv2d: launches {dmo_counts}")
    dmo = {"launches": len(DMO_CASES), "max_abs_err": 0.0, "ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "oracle_err": 0.0, "cases": []}
    dmo_specs = []
    for (x, wt), out, case in zip(dmo_in, dmo_out, DMO_CASES):
        ih, iw, ch, k, st, pd = case
        d_rows, oh, ow = TO.dwconv_overlap_rows(*case)
        rowlen = max(iw, ow) * ch
        spec = D.dwconv_spec(ih=ih, iw=iw, c=ch, k=k, stride=st, pad=pd,
                             d_rows=d_rows, oh=oh, ow=ow, rowlen=rowlen)
        dmo_specs.append(spec)
        arena = torch.zeros((max(d_rows + ih, oh), rowlen), device="cuda")
        arena[d_rows:d_rows + ih, :iw * ch] = x.reshape(ih, -1).cuda()
        w4 = wt.reshape(k, k, ch, 1).contiguous().cuda()
        got, ref = arena.clone(), arena.clone()
        K.arena_conv(got, spec, w4)
        K.apply_plain(ref, spec, w4)
        err = arena_diff(torch, got, ref, spec)
        check(torch.equal(out, got[:oh, :ow * ch].reshape(oh, ow, ch)),
              f"dmo_dwconv2d {case}: the entry point and its spec differ")
        oracle = F.conv2d(
            F.pad(x.permute(2, 0, 1)[None].cuda(), (pd, pd, pd, pd)),
            wt.permute(2, 0, 1)[:, None].cuda(), stride=st, groups=ch)
        oracle = oracle[0].permute(1, 2, 0)
        o_err = (out - oracle).abs()
        check(bool((o_err <= F32_TOL + F32_TOL * oracle.abs()).all()),
              f"dmo_dwconv2d {case}: {o_err.max().item()} from F.conv2d")
        a, b = arena.clone(), arena.clone()
        ms = time_auto(torch, lambda: K.arena_conv(a, spec, w4))
        plain = time_ms(torch, lambda: K.apply_plain(b, spec, w4), 1,
                        warm=False)
        lib = time_auto(torch, library_call(torch, F, spec))
        dmo["cases"].append({"case": case, "ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound_ms(spec),
                             "max_abs_err": err,
                             "arena_bytes": arena.numel() * 4,
                             "two_buffer_bytes": TO.dmo_dwconv2d_footprint(
                                 *case)[1]})
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound_ms(spec))):
            dmo[key] += v
        dmo["max_abs_err"] = max(dmo["max_abs_err"], err)
        dmo["oracle_err"] = max(dmo["oracle_err"], o_err.max().item())
    dmo["bound_by"] = bound_by(dmo_specs)
    log(f"[dmo_dwconv2d] {len(DMO_CASES)} cases on the card match the plain "
        f"version (max err {dmo['max_abs_err']:g}) and F.conv2d (max err "
        f"{dmo['oracle_err']:g}); {dmo['launches']} launches: "
        + json.dumps(dmo["cases"]))
    phase_done("dmo_dwconv2d")

    # 10. the standalone kernels through their entry points
    st_rows_k, standalone = standalone_phase(torch, F)
    phase_done("standalone")

    # 10b. the plan-routed serving runtime on the card
    serve = serve_phase(torch, K, X, zoo)
    phase_done("serve")

    # 10c. the decoder models and the decode engines at full width
    model_rows, models = models_phase(torch, F)
    torch.cuda.empty_cache()
    phase_done("models")

    # 10d. training at full width
    train_rows, train = train_phase(torch, F)
    phase_done("train")

    # 10e. the eight archs no earlier phase runs, served and trained
    arch_rows, archs = archs_phase(torch, F)
    phase_done("archs")

    # 10f. the reference's 32k and 500k shapes
    shape_rows, shapes = shapes_phase(torch, F)
    phase_done("shapes")

    # 10g. olmoe's expert-parallel body on meshes of processes
    mesh = mesh_phase(torch)
    phase_done("mesh")

    # 11. times
    walls = []
    c = slice_cps["resnet_50_v2"]
    w0 = X.synth_weights(c.graph, 0)
    in0 = X.random_inputs(c.graph, 0)
    c.execute(in0, w0)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.execute(in0, w0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    resnet_exec_ms = statistics.median(walls)
    log(f"[time] resnet_50_v2 execute(): median {resnet_exec_ms:.1f} ms over "
        f"3 (host clock, inputs up and outputs down included)")
    fw = X.synth_weights(cp.graph, 0)
    fq = X.calibrate(cp.graph, 0, fw)
    fin = X.quant_inputs(cp.graph, fq, 0)
    for _ in range(3):
        cp.execute(fin, fw, quant=fq)
    fwalls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp.execute(fin, fw, quant=fq)
        torch.cuda.synchronize()
        fwalls.append(1e3 * (time.perf_counter() - t0))
    flag_exec_ms = statistics.median(fwalls)
    log(f"[time] flagship execute(): median {flag_exec_ms:.3f} ms over 20")

    ex = X.get_backend("cuda")
    per = {
        "resnet_50_v2": kernel_times(torch, F, K, ex, c, library=True),
        "densenet_121": kernel_times(torch, F, K, ex,
                                     compiled["densenet_121"], library=True,
                                     only={"arena_concat"}),
        "allops": kernel_times(torch, F, K, ex, compiled["allops"],
                               library=True),
        "mobilenet_v1_0.25_128_8bit": kernel_times(torch, F, K, ex, cp, fw,
                                                   fq),
        "mobilenet_v1_0.25_128_f32": kernel_times(torch, F, K, ex, cp32,
                                                  library=True),
    }
    ci8 = slice_cps["resnet_50_v2 int8"]
    w8 = X.synth_weights(ci8.graph, 0)
    per["resnet_50_v2 int8"] = kernel_times(
        torch, F, K, ex, ci8, w8, X.calibrate(ci8.graph, 0, w8),
        plain_too=False)
    per_blk = {
        "resnet_50_v2": kernel_times(torch, F, K, blk, c, library=True),
        "densenet_121": kernel_times(torch, F, K, blk,
                                     blk_cps["densenet_121"], library=True,
                                     only={"arena_concat"}),
        "allops": kernel_times(torch, F, K, blk, compiled["allops"],
                               library=True),
        "flagship": kernel_times(torch, F, K, blk, cp, fw, fq),
    }
    per_st = {
        "resnet_50_v2": kernel_times(
            torch, F, K, stm, c, library=True,
            only={"arena_stream_roll", "arena_stream_stage"}),
        "flagship": kernel_times(torch, F, K, stm, cp, fw, fq,
                                 only={"arena_stream_fused"}),
        # the staged concats alone, in place on the arena
        "densenet_121 concat": kernel_times(
            torch, F, K, stm, blk_cps["densenet_121"], library=True,
            only={"arena_stream_stage"}, kinds={"concat"}),
    }
    # the fused chains per forward on every program they run on
    chain_cps = {"flagship": (cp, fw, fq), "flagship f32": (cp32, None, None),
                 "flagship batch 2": (blk_cps["flagship batch 2"], None,
                                      None),
                 "mobilenet_v1_1.0_224_8bit": (cpb, None, None),
                 "mobilenet_v2_1.0_224": (blk_cps["mobilenet_v2_1.0_224"],
                                          None, None)}
    chain_times = {}
    for label, (c_, w_, q_) in chain_cps.items():
        for program, ex_ in (("flat", ex), ("blocks", blk),
                             ("streaming", stm)):
            if label.startswith("mobilenet_v1_1.0") and program != "flat" \
                    or label.startswith("mobilenet_v2") and program == "flat":
                continue
            r = kernel_times(torch, F, K, ex_, c_, w_, q_,
                             only={"arena_fused_chain", "arena_stream_fused"})
            chain_times[f"{label} {program}"] = {
                name: {k: v for k, v in row.items() if k != "specs"}
                for name, row in r.items()}
    log("[time] fused chains per forward (ms): " + json.dumps(chain_times))
    sm_out = softmax_matmul_times(torch, F, K, X, build, ex, compile, flag,
                                  cp, fw, fq, compiled)
    sm_out["grids"] = sm_grids + sm_out["grids"] + [
        grid_row(torch, K, sp, f"{label} {k}")
        for label, path in (("resnet_50_v2", per["resnet_50_v2"]),
                            ("allops", per["allops"]))
        for k in ("arena_softmax", "arena_matmul") if k in path
        for sp in path[k]["specs"]]
    blk_walls, st_walls = {}, {}
    for label, reps, args in (("resnet_50_v2", 3, (in0, w0, None)),
                              ("flagship", 20, (fin, fw, fq))):
        bcp = blk_cps[label]
        for ex_, walls_, name in ((blk, blk_walls, "blocked"),
                                  (stm, st_walls, "streaming"),
                                  (stm, st_walls, "streaming"),
                                  (blk, blk_walls, "blocked")):
            ex_.execute(bcp, args[0], args[1], quant=args[2])
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex_.execute(bcp, args[0], args[1], quant=args[2])
                torch.cuda.synchronize()
                walls_.setdefault(label, []).append(
                    1e3 * (time.perf_counter() - t0))
        for name, walls_ in (("blocked", blk_walls),
                             ("streaming", st_walls)):
            log(f"[time] {label} {name} execute(): median "
                f"{statistics.median(walls_[label]):.3f} ms over "
                f"{len(walls_[label])} (in turns: blocked, streaming, "
                f"streaming, blocked)")
    phase_done("times")

    rows = []
    for name in PROGRAM_KERNELS:
        source, replaces = KERNELS[name]
        path = KERNEL_PATH[name]
        r = per[path][name]
        check(r["launches"] == paths[path][name],
              f"{name}: {r['launches']} specs timed, {paths[path][name]} "
              "launched")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path,
            "launches": paths[path][name],
            "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # int8 has no single PyTorch call (int32 accumulation plus
            # requantisation); the fused chain has none either
            "library_ms": r["library_ms"]})
    for name in PROGRAM_KERNELS:
        source = KERNELS[name][0]
        path = BLOCK_KERNEL_PATH[name]
        r = per_blk[path][name]
        check(r["launches"] == blk_paths[path][name],
              f"{name} blocks: {r['launches']} specs timed, "
              f"{blk_paths[path][name]} launched")
        rows.append({
            "name": f"{name} [blocks]", "route": "cuda", "source": source,
            "replaces": BLOCK_REPLACES[name], "path": f"{path} blocks",
            "launches": blk_paths[path][name],
            "max_abs_err": blk_errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    for name, path in STREAM_KERNEL_PATH.items():
        source, replaces = KERNELS[name]
        r = per_st[path][name]
        check(r["launches"] == st_paths[path][name],
              f"{name}: {r['launches']} specs timed, "
              f"{st_paths[path][name]} launched")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": f"{path} streaming",
            "launches": st_paths[path][name],
            "max_abs_err": st_errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            # the bound is the op's own work (spec_cost without its
            # window); the staging copies are the program's overhead
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    rows.append({
        "name": "dmo_dwconv2d", "route": "cuda",
        "source": KERNELS["arena_conv"][0],
        "replaces": "src/repro/kernels/dmo_arena_dwconv.py:33",
        "path": f"{len(DMO_CASES)} cases", "launches": dmo["launches"],
        "max_abs_err": dmo["max_abs_err"], "ms": dmo["ms"],
        "plain_ms": dmo["plain_ms"], "bound_ms": dmo["bound_ms"],
        "bound_by": dmo["bound_by"], "library_ms": dmo["library_ms"]})
    rows.extend(st_rows_k)
    rows.extend(model_rows)
    rows.extend(train_rows)
    rows.extend(arch_rows)
    rows.extend(shape_rows)
    times = {path: {name: {k: v for k, v in r.items() if k != "specs"}
                    for name, r in p.items()} for path, p in per.items()}
    times_blk = {path: {name: {k: v for k, v in r.items() if k != "specs"}
                        for name, r in p.items()}
                 for path, p in per_blk.items()}
    for path, p in times.items():
        log(f"[time] per {path} forward (ms): " + json.dumps(p))
    times_st = {path: {name: {k: v for k, v in r.items() if k != "specs"}
                       for name, r in p.items()}
                for path, p in per_st.items()}
    for path, p in times_blk.items():
        log(f"[time] per {path} blocked forward (ms): " + json.dumps(p))
    for path, p in times_st.items():
        log(f"[time] per {path} streaming forward (ms): " + json.dumps(p))
    out = ROOT / "build"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kind": kind, "kernels": rows, "times": times,
         "resnet_execute_ms": resnet_exec_ms, "resnet_walls_ms": walls,
         "flagship_execute_ms": flag_exec_ms, "flagship_walls_ms": fwalls,
         "launches": paths, "zoo": zoo_rows, "errors": errs,
         "blocks": {"graphs": blk_rows, "times": times_blk,
                    "launches": blk_paths, "errors": blk_errs,
                    "walls_ms": blk_walls},
         "streaming": {"graphs": st_rows, "times": times_st,
                       "launches": st_paths, "errors": st_errs,
                       "walls_ms": st_walls},
         "dmo_dwconv2d": dmo, "standalone": standalone,
         "arena_conv": conv_rows, "arena_stream_roll": roll_rows,
         "arena_elementwise": ew_info, "pool_and_fc": head_info,
         "chains": {"schedules": chains, "times": chain_times},
         "softmax_matmul": sm_out, "serve": serve, "models": models,
         "train": train, "archs": archs, "shapes": shapes, "mesh": mesh,
         "build_s": build.LAST_BUILD_S, "ptxas": build.ptxas_report(),
         "phase_s": phase_s, "wall_s": time.perf_counter() - t_start},
        indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
