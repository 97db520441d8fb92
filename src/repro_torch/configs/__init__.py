"""Assigned architecture registry: one module per arch, each holding its
``CONFIG``. Every config cites its source; smoke variants via
``.reduced()``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig, ShapeConfig, SHAPES

_ARCH_MODULES = [
    "qwen3_moe_235b_a22b",
    "musicgen_medium",
    "nemotron_4_15b",
    "hymba_1_5b",
    "minicpm3_4b",
    "rwkv6_1_6b",
    "internvl2_1b",
    "yi_6b",
    "qwen2_5_3b",
    "olmoe_1b_7b",
]


def registry() -> Dict[str, ArchConfig]:
    out = {}
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        cfg = mod.CONFIG
        out[cfg.name] = cfg
    return out


def get_arch(name: str) -> ArchConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(reg)}")
    return reg[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def arch_names() -> List[str]:
    return list(registry())
