"""Loss and train step, the state updated in place.

The counterpart of the reference's ``src/repro/train/steps.py``. Where the
reference jits its step with the state donated (XLA writes the new params
and moments over the old: the ``O_s = |out|`` case), the callable of
:func:`make_train_step` writes them into the state's own tensors
(:func:`repro_torch.optim.adamw.update`), so every leaf keeps its
``data_ptr`` across steps.

Gradients come from ``torch.autograd.grad`` on aliases of the params that
require grad (the params themselves never do). Under a runtime mesh
(``launch/mesh.py``) every rank runs the step on its rows and its shard,
and the gradient and the clip's norm are those of the global batch. On
the card the long causal attention of a forward runs the flash kernel
and its backward (``kernels/flash_attention.py::FlashAttention``), and
RWKV's chunked WKV runs the WKV kernel and its backward
(``kernels/wkv_chunk.py::WkvChunk``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw

TrainState = Dict[str, Any]       # {"params", "opt"}
Batch = Dict[str, torch.Tensor]   # {"inputs": (B,S) or (B,S,d), "targets": (B,S)}

MOE_AUX_WEIGHT = 0.01

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in float32: logsumexp minus the gold logit."""
    lf = logits.to(torch.float32)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL, float32 logsumexp."""
    return torch.mean(_nll(logits, targets))


#: sequence-chunked loss kicks in above this vocab size: the (S, V) logits
#: are never materialised whole — the head matmul and softmax run one seq
#: chunk at a time (the reference's values)
CHUNKED_CE_VOCAB = 32768
CE_CHUNK = 512


def chunked_cross_entropy(cfg: ArchConfig, params, x: torch.Tensor,
                          targets: torch.Tensor, chunk: int = CE_CHUNK
                          ) -> torch.Tensor:
    """x: (B,S,d) final hidden states; head+CE applied per seq chunk, the
    chunks' sums added in order."""
    b, s, d = x.shape
    if s % chunk or s <= chunk:
        return cross_entropy(T.unembed(cfg, params, x), targets)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        logits = T.unembed(cfg, params, x[:, c0:c0 + chunk])
        tot = tot + torch.sum(_nll(logits, targets[:, c0:c0 + chunk]))
    return tot / (b * s)


def loss_fn(cfg: ArchConfig, params, batch: Batch, remat: bool = True):
    """(loss, {"ce", "moe_aux"}), as the reference's."""
    if cfg.vocab_size >= CHUNKED_CE_VOCAB:
        x, aux = T.forward_hidden(cfg, params, batch["inputs"], remat=remat)
        ce = chunked_cross_entropy(cfg, params, x, batch["targets"])
    else:
        logits, aux = T.forward_train(cfg, params, batch["inputs"],
                                      remat=remat)
        ce = cross_entropy(logits, batch["targets"])
    loss = ce + MOE_AUX_WEIGHT * aux if cfg.is_moe else ce
    return loss, {"ce": ce, "moe_aux": aux}


def opt_config_for(cfg: ArchConfig) -> adamw.OptConfig:
    """bf16 moments for >100B-param configs."""
    mdt = "bfloat16" if cfg.param_count() > 1e11 else "float32"
    return adamw.OptConfig(moment_dtype=mdt)


def accum_dtype_for(cfg: ArchConfig) -> str:
    """bf16 gradient accumulation for >100B configs."""
    return "bfloat16" if cfg.param_count() > 1e11 else "float32"


def init_state(cfg: ArchConfig, generator: torch.Generator,
               opt_cfg: Optional[adamw.OptConfig] = None,
               device=None) -> TrainState:
    """Random params drawn from ``generator`` (``transformer.init_params``)
    and zero optimiser state, on ``device`` (None: the card; ``"cpu"``)."""
    params = T.init_params(cfg, generator, device)
    mdt = opt_cfg.moment_dtype if opt_cfg else "float32"
    return {"params": params, "opt": adamw.init(params, mdt)}


def _like(tree, leaves):
    """``leaves`` (in :func:`adamw.tree_leaves` order) as a tree of
    ``tree``'s shape."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def value_and_grad(cfg: ArchConfig, params, batch: Batch,
                   remat: bool = True):
    """((loss, parts), grads): the loss on aliases of the params that
    require grad, and its gradient as a tree of the params' shape (zeros
    for a leaf the loss does not use, as ``jax.grad`` gives).

    Under a runtime mesh ``params`` is this rank's shard and ``batch`` its
    rows (``data/pipeline.py::shard_batch``): the loss and its parts are
    the means over the data group of the ranks' own (the mean over the
    global batch), and each leaf's gradient that of that mean
    (``sharding.data_mean``), every sum in ascending data index."""
    paths, leaves = zip(*SH.tree_paths(params))
    alias = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, _like(params, alias), batch, remat)
        grads = torch.autograd.grad(loss, alias, allow_unused=True,
                                    materialize_grads=True)
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    env = SH.runtime_env()
    if env is not None and env.mesh.shape["data"] > 1:
        grads = SH.data_mean(list(paths), list(grads), env)
        nd = env.mesh.shape["data"]
        loss, parts["ce"] = (SH.ordered_sum(SH.gather(v, env.mesh, "data"))
                             / nd for v in (loss, parts["ce"]))
    return (loss, parts), _like(params, grads)


def train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig, state: TrainState,
               batch: Batch, remat: bool = True, microbatches: int = 1,
               accum_dtype: str = "float32",
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step, optionally with gradient accumulation over
    ``microbatches`` slices of the global batch (bounds the activations
    and logits held at once) in ``accum_dtype``. Updates ``state`` in
    place and returns it with the metrics (device tensors). Under a
    runtime mesh each slice is this rank's part of a global microbatch,
    as ``shard_batch(..., microbatches=...)`` lays the rows out."""
    params = state["params"]
    if microbatches <= 1:
        (loss, parts), grads = value_and_grad(cfg, params, batch, remat)
    else:
        adt = _TYPES[accum_dtype]
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"train_step: batch {n} is not a multiple of "
                             f"{microbatches} microbatches")
        mb = n // microbatches
        grads = T.tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                 device=p.device), params)
        acc = adamw.tree_leaves(grads)
        dev = acc[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(microbatches):
            b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            (l, parts), g = value_and_grad(cfg, params, b, remat)
            for a, x in zip(acc, adamw.tree_leaves(g)):
                a.add_(x.to(adt))
            del g
            loss = loss + l
            aux = aux + parts["moe_aux"]
        inv = 1.0 / microbatches
        for a in acc:
            a.mul_(inv)
        loss, parts = loss * inv, {"ce": loss * inv, "moe_aux": aux * inv}
    _, _, om = adamw.update(opt_cfg, grads, state["opt"], params)
    del grads
    return state, {"loss": loss, **parts, **om}


def default_microbatches(cfg: ArchConfig, global_batch: int, seq_len: int,
                         data_shards: int, token_budget: int = 4096) -> int:
    """Pick the accumulation factor so each device sees <= token_budget
    tokens per microbatch (keeps logits/activations inside memory)."""
    per_device_tokens = global_batch * seq_len // max(1, data_shards)
    m = max(1, per_device_tokens // token_budget)
    # must divide the *global* batch
    while global_batch % m:
        m -= 1
    return m


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                    remat: bool = True, microbatches: int = 1) -> Callable:
    """The counterpart of the reference's ``jit_train_step``: a callable
    ``step(state, batch) -> (state, metrics)`` that updates ``state`` in
    place (the reference donates it)."""
    def step(state: TrainState, batch: Batch):
        return train_step(cfg, opt_cfg, state, batch, remat=remat,
                          microbatches=microbatches)
    return step
