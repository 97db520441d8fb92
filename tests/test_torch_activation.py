"""The port's transformer activation plans against the JAX package's:
``repro_torch.configs`` and ``repro_torch.models.config`` (the ten
assigned archs, their smoke variants and the four shapes),
``repro_torch.core.activation_planner`` (one decoder block as a tensor-op
graph, planned original and DMO) and ``repro_torch.kernels.runtime`` (the
port's device switch).

Configs must be equal field by field; block graphs op for op and tensor
for tensor; plans in peak, offsets, order and overlaps. Each arch is a
case of its own.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from test_torch_core import _graph_fields

from repro import configs as rconfigs
from repro.core import activation_planner as rap
from repro.models import config as rmc

from repro_torch import configs as tconfigs
from repro_torch.core import activation_planner as tap
from repro_torch.kernels import runtime
from repro_torch.models import config as tmc

ARCHS = list(rconfigs.registry())
#: archs also planned at (batch 2, seq 128)
WIDER = ["qwen2.5-3b", "rwkv6-1.6b"]


def _plan_fields(plan):
    return (plan.peak_bytes, plan.strategy,
            [op.name for op in plan.order],
            sorted((t.name, off) for t, off in plan.offsets.items()),
            sorted(plan.overlaps.items()))


def test_registry_names_equal():
    assert tconfigs.arch_names() == rconfigs.arch_names() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_config_equal(arch):
    t, r = tconfigs.get_arch(arch), rconfigs.get_arch(arch)
    assert type(t).__name__ == type(r).__name__ == "ArchConfig"
    assert dataclasses.astuple(t) == dataclasses.astuple(r)
    assert dataclasses.astuple(t.reduced()) == \
        dataclasses.astuple(r.reduced())
    for prop in ("attn_free", "is_moe", "q_dim", "kv_dim", "sub_quadratic"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("shape", sorted(rmc.SHAPES))
def test_shape_config_equal(shape):
    t, r = tconfigs.get_shape(shape), rconfigs.get_shape(shape)
    assert dataclasses.astuple(t) == dataclasses.astuple(r)
    assert t.is_decode == r.is_decode
    assert sorted(tmc.SHAPES) == sorted(rmc.SHAPES)


def test_unknown_arch_raises_the_same_error():
    with pytest.raises(KeyError) as want:
        rconfigs.get_arch("no-such-arch")
    with pytest.raises(KeyError) as got:
        tconfigs.get_arch("no-such-arch")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_graph_equal(arch):
    t = tap.block_graph(tconfigs.get_arch(arch), 1, 64)
    r = rap.block_graph(rconfigs.get_arch(arch), 1, 64)
    assert _graph_fields(t) == _graph_fields(r)
    assert any(op.kind == "custom" for op in t.ops)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_block_equal(arch):
    t_orig, t_dmo = tap.plan_block(tconfigs.get_arch(arch), 1, 64)
    r_orig, r_dmo = rap.plan_block(rconfigs.get_arch(arch), 1, 64)
    assert _plan_fields(t_orig) == _plan_fields(r_orig)
    assert _plan_fields(t_dmo) == _plan_fields(r_dmo)
    t_orig.validate()
    t_dmo.validate()
    # every family has elementwise chains: DMO must find real savings
    assert t_dmo.peak_bytes < t_orig.peak_bytes, arch


@pytest.mark.parametrize("arch", WIDER)
def test_plan_block_equal_wider(arch):
    t = tap.plan_block(tconfigs.get_arch(arch), 2, 128)
    r = rap.plan_block(rconfigs.get_arch(arch), 2, 128)
    for tp, rp in zip(t, r):
        assert _plan_fields(tp) == _plan_fields(rp)
    assert t[1].peak_bytes < t[0].peak_bytes


def test_compile_block_report():
    cfg = tconfigs.get_arch("qwen2.5-3b")
    t = tap.compile_block(cfg, 1, 64)
    r = rap.compile_block(rconfigs.get_arch("qwen2.5-3b"), 1, 64)
    assert (t.peak_bytes, t.baseline_bytes, t.winner) == \
        (r.peak_bytes, r.baseline_bytes, r.winner)
    assert t.peak_bytes == tap.plan_block(cfg, 1, 64)[1].peak_bytes


def test_runtime_resolves_the_cpu():
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_runtime_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)


def test_modules_import_with_jax_blocked():
    """The serving runtime, configs, models, activation planner and
    runtime import and run with JAX made unimportable, and load nothing of
    the JAX package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.core.activation_planner import plan_block\n"
        "from repro_torch.kernels import runtime\n"
        "from repro_torch.models.config import SHAPES\n"
        "from repro_torch.serve import PlanServer, throughput_demo\n"
        "from repro_torch.core import zoo\n"
        "o, d = plan_block(registry()['rwkv6-1.6b'], 1, 64)\n"
        "st = throughput_demo(zoo.mobilenet_v1(0.25, 32, 1), n_requests=3,\n"
        "                     batches=(1, 2), device='cpu')\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print(o.peak_bytes, d.peak_bytes, st['requests_served'])\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["2097152", "1314814", "3"]
