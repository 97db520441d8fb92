"""KV-cache serving engine: batched prefill + decode with caches updated in
place.

The counterpart of the reference's ``src/repro/serve/engine.py``. Where the
reference jits the decode step with the cache donated, the port's decode
step writes each layer's new entries into the stacked cache's own storage
(:func:`repro_torch.models.transformer.decode_step`): the KV ring buffer,
SSM states and token-shift states are updated in place every step, the
serving-side realisation of the paper's ``O_s = |out|`` overlap.

Everything runs under ``torch.inference_mode()`` on ``device`` (None: the
card, raising without one; ``"cpu"``: the kernels' plain versions).

Under a runtime mesh (``launch/mesh.py``) ``params`` is the rank's shard:
each data rank prefills and decodes its rows (every rank all of them
where the data axis does not divide the batch, as the reference's MoE
body replicates such tokens) and the tokens are gathered in ascending
data order, so every rank returns the whole batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import sharding as SH
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ServeConfig:
    cache_len: int = 2048
    window: int = 0            # sliding window for the sub-quadratic variant
    temperature: float = 0.0   # 0 = greedy
    max_new_tokens: int = 32


def _on(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(dev)


def make_prefill(cfg: ArchConfig, scfg: ServeConfig, device=None):
    """``fn(params, inputs) -> (logits, cache)`` on ``device``."""
    dev = resolve_device(device)

    def fn(params, inputs):
        with torch.inference_mode():
            return T.prefill(cfg, params, _on(inputs, dev),
                             cache_len=scfg.cache_len, window=scfg.window)
    return fn


def make_decode(cfg: ArchConfig, scfg: ServeConfig, device=None):
    """``fn(params, cache, tokens, pos) -> (logits, cache)`` on ``device``;
    the cache is updated in place."""
    dev = resolve_device(device)

    def fn(params, cache, tokens, pos):
        with torch.inference_mode():
            return T.decode_step(cfg, params, cache, _on(tokens, dev), pos,
                                 window=scfg.window)
    return fn


class Engine:
    """Minimal batched engine: same-length prompts, synchronous decode.
    ``params`` are moved to ``device`` where they lie elsewhere."""

    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.scfg = cfg, scfg
        self.params = T.tree_map(lambda t: t.to(self.device), params)
        self._prefill = make_prefill(cfg, scfg, self.device)
        self._decode = make_decode(cfg, scfg, self.device)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator
                ) -> torch.Tensor:
        last = logits[:, -1].float()
        if self.scfg.temperature <= 0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: np.ndarray, seed: int = 0) -> np.ndarray:
        """prompts: (B, S) int32 (or (B,S,d) embeddings for stub frontends).
        Returns (B, max_new_tokens) int32. ``temperature > 0`` samples from
        a generator on the engine's device seeded by ``seed`` (under a
        mesh, each data rank's rows from its own, seeded alike)."""
        env = SH.runtime_env()
        if env is None:
            return self._generate(prompts, seed).cpu().numpy()
        b, n, i = prompts.shape[0], env.mesh.shape["data"], \
            env.mesh.index("data")
        if b % n:
            with SH.replicated_rows():
                return self._generate(prompts, seed).cpu().numpy()
        mine = self._generate(prompts[i * b // n:(i + 1) * b // n], seed)
        return torch.cat(SH.gather(mine, env.mesh, "data")).cpu().numpy()

    def _generate(self, prompts: np.ndarray, seed: int) -> torch.Tensor:
        s = prompts.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self._prefill(self.params, prompts)
        toks = []
        tok = self._sample(logits, gen)
        pos = s
        for _ in range(self.scfg.max_new_tokens):
            toks.append(tok)
            logits, cache = self._decode(self.params, cache, tok[:, None],
                                         pos)
            tok = self._sample(logits, gen)
            pos += 1
        return torch.stack(toks, dim=1).to(torch.int32)
