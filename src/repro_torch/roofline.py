"""Roofline terms of a step from the port's dry-run cost record.

Three terms per (arch × shape × mesh), all in seconds:

  compute    = FLOPs / (chips × peak FLOP/s)
  memory     = bytes / (chips × memory bytes/s)
  collective = collective bytes / (chips × link bytes/s)

The counterpart of the reference's ``src/repro/roofline.py``. The reference
reads FLOPs, bytes and collectives from XLA's compiled HLO; the port has no
compiler, so :func:`analyse` takes the dry run's own record
(``launch/dryrun.py``: FLOPs counted by ``FlopCounterMode`` over a whole
step, bytes from the abstract state and the specs, and a collective term
only where the port knows it). :func:`collective_bytes` still parses HLO
text, for a reference module.

Peaks: the port's default is :data:`H100` (NVIDIA's data sheet, SXM: 989
TFLOP/s dense bf16, 3.35 TB/s of HBM, NVLink 450 GB/s each way), the same
peaks as ``chip_smoke.py``'s bounds; :data:`TPU_V5E` keeps the reference's
per-chip numbers as a named option.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Peak:
    """One chip's peaks: dense bf16 FLOP/s, memory bytes/s, bytes/s of one
    link each way."""
    name: str
    flops: float
    hbm_bw: float
    link_bw: float


#: the port's card: NVIDIA H100 SXM (data sheet)
H100 = Peak("h100", 989e12, 3.35e12, 450e9)
#: the reference's chip, TPU v5e (``src/repro/roofline.py``)
TPU_V5E = Peak("tpu_v5e", 197e12, 819e9, 50e9)

#: the default peaks, the port's card
PEAK_FLOPS = H100.flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.link_bw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "tuple": 0, "token": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# e.g.:  %ar = bf16[16,4096]{1,0} all-reduce(%x), replica_groups=...
_OP_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tuple_bytes(inner: str) -> int:
    total = 0
    for part in inner.split(","):
        part = part.strip()
        m = re.match(r"(\w+)\[([\d,]*)\]", part)
        if m:
            total += _shape_bytes(m.group(1), m.group(2))
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-collective result bytes summed over an HLO module ('-start'
    variants counted once, '-done' skipped)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for m in _OP_RE.finditer(hlo_text):
        tup, dtype, dims, kind = m.groups()
        if m.group(0).rstrip("(").endswith("-done("):
            continue
        size = _tuple_bytes(tup) if tup else _shape_bytes(dtype, dims)
        out[kind] += size
    return out


@dataclasses.dataclass
class Roofline:
    """A step's three terms. ``coll_bytes`` None: the collective term is
    unknown (the port's dry run on a mesh of more than one device: it has
    no SPMD compiler to say what the collectives move)."""
    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: Optional[float]
    coll_breakdown: Dict[str, int]
    model_flops: float
    per_device_hbm: Optional[float] = None
    peak: Peak = H100

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.peak.flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.peak.hbm_bw)

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / (self.chips * self.peak.link_bw)

    @property
    def bottleneck(self) -> str:
        """The largest known term."""
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        known = {k: v for k, v in terms.items() if v is not None}
        return max(known, key=known.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> str:
        coll = ("     null" if self.t_collective is None
                else f"{self.t_collective * 1e3:9.2f}ms")
        return (f"{self.name:40s} comp={self.t_compute * 1e3:9.2f}ms "
                f"mem={self.t_memory * 1e3:9.2f}ms coll={coll} "
                f"[{self.bottleneck:10s}] useful={self.useful_flops_ratio:5.2f}"
                + (f" hbm/dev={self.per_device_hbm / 2**30:6.2f}GiB"
                   if self.per_device_hbm else "") + f" ({self.peak.name})")


def analyse(name: str, cost: Dict, model_flops: float, chips: int,
            peak: Peak = H100) -> Roofline:
    """The roofline of one dry-run record: ``cost`` holds the step's global
    ``flops`` and ``bytes``, ``collectives`` (bytes by kind, or None when
    unknown) and ``per_device_bytes`` (a dict of byte counts, the known
    ones summed)."""
    coll = cost.get("collectives")
    per_dev = cost.get("per_device_bytes")
    return Roofline(name, chips, float(cost["flops"]), float(cost["bytes"]),
                    None if coll is None else float(sum(coll.values())),
                    dict(coll or {}), model_flops,
                    float(sum(v for v in per_dev.values() if v is not None))
                    if per_dev else None, peak)


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference steps."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence
