"""Synthetic-corpus data pipeline: deterministic document stream, packing,
host-side batching, and the move of a batch to the device.

The counterpart of the reference's ``src/repro/data/pipeline.py``, numpy
only and copied: the same seed gives the same batches, bit for bit. There
is no dataset on disk, so the corpus is a seeded "hash stream" of
variable-length documents over the arch's vocabulary, enough to drive
real training steps and show the loss fall on learnable structure
(documents are n-gram-ish: each token depends on the previous one).

The reference's ``shard_batch`` places a batch on a mesh, split over
``data``; :func:`shard_batch` gives a rank of a runtime mesh its rows
(without a mesh, the whole batch), moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 0


class SyntheticCorpus:
    """Deterministic bigram-flavoured documents (learnable structure)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse "bigram" successor table: token t -> a small candidate set
        self._succ = rng.integers(1, v, size=(min(v, 4096), 4), dtype=np.int64)

    def documents(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.cfg.seed + 1)
        v = self.cfg.vocab_size
        while True:
            n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
            toks = np.empty(n, np.int64)
            toks[0] = rng.integers(1, v)
            for i in range(1, n):
                cands = self._succ[toks[i - 1] % len(self._succ)]
                toks[i] = cands[rng.integers(0, len(cands))]
            yield toks

    def packed_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Packs documents (EOS-delimited) into (B, S+1) windows, yielding
        {"inputs": (B,S), "targets": (B,S)}."""
        cfg = self.cfg
        docs = self.documents()
        buf = np.empty(0, np.int64)
        need = cfg.global_batch * (cfg.seq_len + 1)
        while True:
            while buf.size < need:
                d = next(docs)
                buf = np.concatenate([buf, d, [cfg.eos_id]])
            chunk = buf[:need].reshape(cfg.global_batch, cfg.seq_len + 1)
            buf = buf[need:]
            yield {
                "inputs": chunk[:, :-1].astype(np.int32),
                "targets": chunk[:, 1:].astype(np.int32),
            }


def shard_batch(batch: Dict[str, np.ndarray], device=None, mesh=None,
                microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (None: the card, raising
    without one; ``"cpu"``), one copy each. With a runtime ``mesh``, only
    this rank's rows, as ``device_put`` with ``P("data", ...)`` splits
    them: data rank i of n takes the i-th n-th of each of the
    ``microbatches`` blocks of rows (the whole i-th n-th for one), so
    that ``train_step``'s microbatch slices are its part of the global
    microbatches. Raises where the rows do not split."""
    dev = resolve_device(device)
    if mesh is not None:
        n, i = mesh.shape["data"], mesh.index("data")
        rows = next(iter(batch.values())).shape[0]
        if rows % (n * microbatches):
            raise ValueError(f"shard_batch: {rows} rows do not split into "
                             f"{microbatches} microbatch(es) over {n} data "
                             "ranks")
        mb = rows // microbatches
        mine = np.concatenate([np.arange(j * mb + i * mb // n,
                                         j * mb + (i + 1) * mb // n)
                               for j in range(microbatches)])
        batch = {k: np.asarray(v)[mine] for k, v in batch.items()}
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def embedding_batches(cfg: DataConfig, d_model: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Frontend-stub stream for audio/VLM archs: precomputed frame/patch
    embeddings plus next-token targets."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "inputs": rng.standard_normal(
                (cfg.global_batch, cfg.seq_len, d_model)).astype(np.float32),
            "targets": rng.integers(
                0, cfg.vocab_size,
                (cfg.global_batch, cfg.seq_len)).astype(np.int32),
        }
