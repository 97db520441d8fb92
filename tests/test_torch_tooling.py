"""The port's tooling modules against the reference's: the HLO cost parser
(``hlocost``), the roofline terms (``roofline``), the axis environment and
``constrain`` (``sharding``), the meshes (``launch/mesh.py``), the abstract
inputs and sharding rules (``launch/specs.py``) and the dry run
(``launch/dryrun.py``).

The reference's specs run on ``jax.sharding.AbstractMesh`` (no devices):
(16, 16) ("data", "model"), (2, 16, 16) ("pod", "data", "model") and (1,
1); the port's on its own ``launch.mesh.Mesh`` of the same axes. Its
PartitionSpecs are compared as tuples of axis names. The dry run's FLOPs
(``FlopCounterMode`` over the step on the meta device) are held within 10 %
of ``repro.hlocost.module_cost`` of the reference's single-device compiled
HLO for a train step and a prefill of every reduced arch.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import hlocost as R_HC
from repro import roofline as R_RL
from repro import sharding as R_SH
from repro.configs import arch_names
from repro.configs import get_arch as r_arch
from repro.launch import mesh as R_M
from repro.launch import specs as R_SP
from repro.models import transformer as R_T
from repro.models.config import SHAPES as R_SHAPES
from repro.train import steps as R_TS
from repro_torch import hlocost as HC
from repro_torch import roofline as RL
from repro_torch import sharding as SH
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, ShapeConfig

ARCHS = arch_names()
#: (reference mesh, the port's) of the same axes
MESHES = {
    "16x16": (AbstractMesh((16, 16), ("data", "model")),
              M.Mesh(("data", "model"), (16, 16))),
    "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                M.Mesh(("pod", "data", "model"), (2, 16, 16))),
    "1x1": (AbstractMesh((1, 1), ("data", "model")),
            M.Mesh(("data", "model"), (1, 1))),
}
#: the dry run's FLOPs against the reference's HLO count
FLOP_TOL = 0.10


def _specs(tree):
    """A tree of NamedShardings as the same tree of tuples of axis names."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree.spec)


def _leaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: (tuple(tree.shape),
                          str(tree.dtype).replace("torch.", ""))}


# --- hlocost -------------------------------------------------------------

def _scan_hlo():
    def g(a, b):
        def body(x, _):
            return x @ b, None
        y, _ = jax.lax.scan(body, a, None, length=10)
        return y
    a = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    return jax.jit(g).lower(a, a).compile().as_text()


def _collective_hlo():
    f = jax.pmap(lambda x: jax.lax.psum(x @ x, "i"), axis_name="i")
    return f.lower(jnp.ones((1, 32, 32))).compile().as_text()


def _fusion_hlo():
    return jax.jit(lambda a, b: jnp.tanh(a @ b) * 2 + 1).lower(
        jnp.ones((64, 48)), jnp.ones((48, 32))).compile().as_text()


@pytest.mark.parametrize("make,needle", [(_scan_hlo, "while"),
                                         (_collective_hlo, "all-reduce"),
                                         (_fusion_hlo, "fusion")])
def test_hlocost_module_cost_equals_the_reference(make, needle):
    text = make()
    assert needle in text
    got, want = HC.module_cost(text), R_HC.module_cost(text)
    assert (got.flops, got.bytes, got.coll) == (want.flops, want.bytes,
                                                want.coll)
    assert got.flops > 0
    if needle == "while":
        assert got.flops == pytest.approx(10 * 2 * 128 ** 3, rel=0.01)
    if needle == "all-reduce":
        assert got.coll["all-reduce"] > 0
        assert RL.collective_bytes(text) == R_RL.collective_bytes(text)


# --- roofline ------------------------------------------------------------

def test_roofline_terms_under_the_tpu_option():
    """test_system.py::test_roofline_terms' numbers, with the reference's
    TPU v5e peaks named; the port's default is the H100's."""
    r = RL.Roofline("x", 256, hlo_flops=1e15, hlo_bytes=1e12,
                    coll_bytes=1e11, coll_breakdown={}, model_flops=5e14,
                    peak=RL.TPU_V5E)
    assert r.t_compute == pytest.approx(1e15 / (256 * 197e12))
    assert r.bottleneck in ("compute", "memory", "collective")
    assert r.useful_flops_ratio == pytest.approx(0.5)
    ref = R_RL.Roofline("x", 256, hlo_flops=1e15, hlo_bytes=1e12,
                        coll_bytes=1e11, coll_breakdown={},
                        model_flops=5e14)
    for term in ("t_compute", "t_memory", "t_collective", "bottleneck"):
        assert getattr(r, term) == getattr(ref, term)
    h = RL.Roofline("x", 1, 989e12, 3.35e12, None, {}, 1.0)
    assert (h.peak, RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (
        RL.H100, 989e12, 3.35e12, 450e9)
    assert h.t_compute == pytest.approx(1.0) and h.t_collective is None
    assert h.bottleneck == "compute"


def test_analyse_reads_the_dry_run_record():
    cost = {"flops": 2e15, "bytes": 1e12, "collectives": None,
            "per_device_bytes": {"arguments": 3.0, "outputs": None}}
    r = RL.analyse("x", cost, 1e15, 4)
    assert (r.chips, r.hlo_flops, r.coll_bytes, r.per_device_hbm) == (
        4, 2e15, None, 3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    r = RL.analyse("x", dict(cost, collectives={"all-reduce": 8}), 1e15, 4)
    assert r.coll_bytes == 8.0 and r.coll_breakdown == {"all-reduce": 8}
    assert "coll=" in r.row()


@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_reference(shape):
    for a in ARCHS:
        assert RL.model_flops_for(get_arch(a), SHAPES[shape]) == \
            R_RL.model_flops_for(r_arch(a), R_SHAPES[shape])


# --- sharding and meshes -------------------------------------------------

def test_axis_env_resolves_as_the_reference():
    for name, (rm, tm) in MESHES.items():
        ba = R_M.batch_axes(rm)
        assert M.batch_axes(tm) == ba
        renv, tenv = R_SH.AxisEnv(rm, ba), SH.AxisEnv(tm, ba)
        for dims in (("batch", None, None), ("batch", None, "model"),
                     (None, "model")):
            assert tenv.spec(*dims) == tuple(renv.spec(*dims)), name
        with pytest.raises(ValueError):
            tenv.resolve("seq")


def test_constrain_is_the_identity():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert SH.constrain(x, "batch", None, None) is x
    assert SH.current_env() is None
    with SH.axis_env(M.make_host_mesh()) as env:
        assert env.mesh.size == 1 and SH.current_env() is env
        assert SH.constrain(x, "batch", None, "model") is x
    _, pod = MESHES["2x16x16"]
    with SH.axis_env(pod, batch=("pod", "data")):
        assert SH.constrain(x, "batch", None, "model") is x
        assert SH.current_env().spec("batch", None, "model") == \
            (("pod", "data"), None, "model")
        with pytest.raises(ValueError, match="unknown logical axis"):
            SH.current_env().spec("seq")
    assert SH.current_env() is None


def test_transformer_constrains_where_the_reference_does():
    """The four call sites: the embedding, each block's two residual sums,
    the logits; a forward under a 16 x 16 env equals one without."""
    cfg = get_arch("qwen2.5-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    seen = []
    real = T.constrain

    def record(x, *dims):
        seen.append(dims)
        return real(x, *dims)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "constrain", record)
        want, _ = T.forward_train(cfg, params, toks, remat=False)
    assert seen == ([("batch", None, None)] * (1 + 2 * cfg.num_layers)
                    + [("batch", None, "model")])
    with SH.axis_env(MESHES["16x16"][1]):
        got, _ = T.forward_train(cfg, params, toks, remat=False)
    assert torch.equal(got, want)


def test_meshes():
    pod, multi = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert (pod.axis_names, pod.axis_sizes, pod.size, pod.devices) == (
        ("data", "model"), (16, 16), 256, ())
    assert (multi.axis_names, dict(multi.shape)) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    for name, (rm, tm) in MESHES.items():
        assert dict(tm.shape) == dict(rm.shape) and tm.size == rm.size
    host = M.make_host_mesh(4, 4)
    assert host.axis_sizes == (1, 1) and len(host.devices) == 1


# --- specs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_the_reference(arch):
    rc, tc = r_arch(arch), get_arch(arch)
    assert _leaves(SP.abstract_params(tc)) == _leaves(
        R_SP.abstract_params(rc))
    assert _leaves(SP.abstract_state(tc)) == _leaves(
        R_SP.abstract_state(rc))
    for name, (rm, tm) in MESHES.items():
        assert SP.parallel_policy(tc, tm) == R_SP.parallel_policy(rc, rm)
        assert SP.needs_fsdp(tc, tm) == R_SP.needs_fsdp(rc, rm)
        assert SP.param_shardings(tc, tm) == _specs(
            R_SP.param_shardings(rc, rm)), name
        for policy in ("dp", "tp"):
            assert SP.state_shardings(tc, tm, policy=policy) == _specs(
                R_SP.state_shardings(rc, rm, policy=policy)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_batch_and_cache_specs_equal_the_reference(arch):
    rc, tc = r_arch(arch), get_arch(arch)
    for sname, shape in SHAPES.items():
        rs = R_SHAPES[sname]
        assert SP.cache_len_for(tc, shape) == R_SP.cache_len_for(rc, rs)
        assert SP.decode_window(tc, shape) == R_SP.decode_window(rc, rs)
        got, want = SP.input_specs(tc, shape), R_SP.input_specs(rc, rs)
        assert _leaves(got) == _leaves(want), sname
        assert all(t.device.type == "meta" for t in
                   (v for v in _flat(got)))
        for name, (rm, tm) in MESHES.items():
            if shape.kind == "train":
                assert SP.batch_shardings(tc, shape, tm) == _specs(
                    R_SP.batch_shardings(rc, rs, rm)), (sname, name)
            else:
                assert SP.cache_shardings(tc, shape, tm) == _specs(
                    R_SP.cache_shardings(rc, rs, rm)), (sname, name)


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    else:
        yield tree


# --- the dry run -------------------------------------------------------------

def _reference_flops(cfg, kind, b, s):
    if cfg.frontend != "none":
        inp = jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.float32)
    else:
        inp = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if kind == "train":
        st = jax.eval_shape(lambda: R_TS.init_state(
            cfg, jax.random.PRNGKey(0), R_TS.opt_config_for(cfg)))
        batch = {"inputs": inp,
                 "targets": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        fn = functools.partial(
            R_TS.train_step, cfg, R_TS.opt_config_for(cfg), remat=True,
            microbatches=R_TS.default_microbatches(cfg, b, s, 1),
            accum_dtype=R_TS.accum_dtype_for(cfg))
        lowered = jax.jit(fn).lower(st, batch)
    else:
        p = jax.eval_shape(lambda: R_T.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
        lowered = jax.jit(functools.partial(R_T.prefill, cfg,
                                            cache_len=s)).lower(p, inp)
    return R_HC.module_cost(lowered.compile().as_text()).flops


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_flops_match_the_reference_hlo(arch):
    """A train step (remat, the default microbatches) and a prefill of the
    reduced arch at batch 2 x 64 tokens: the port's count on the meta
    device within 10 % of the reference's HLO dots."""
    rc, tc = r_arch(arch).reduced(), get_arch(arch).reduced()
    host = M.Mesh(("data", "model"), (1, 1))
    for kind in ("train", "prefill"):
        shape = ShapeConfig(f"{kind}_64", 64, 2, kind)
        got, _ = D.count_step(tc, shape, host, SP.input_specs(tc, shape))
        want = _reference_flops(rc, kind, 2, 64)
        assert want > 0 and abs(got - want) <= FLOP_TOL * want, (
            kind, got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_dry_run_of_a_full_width_arch(shape):
    """qwen2.5-3b at full size on the (16, 16) mesh: the step built on the
    meta device, FLOPs counted, the collective term null (no SPMD
    compiler), per-device argument bytes from the specs."""
    rec = D.run_one("qwen2.5-3b", shape, "pod")
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["hlo_flops"] > 0 and rec["model_flops"] > 0
    assert rec["collective_bytes"] is None and rec["t_collective_s"] is None
    assert rec["per_device_bytes"]["arguments"] > 0
    assert 0.3 < rec["useful_flops_ratio"] <= 1.0
    if shape == "train_4k":
        assert (rec["microbatches"], rec["policy"]) == (16, "tp")


def test_dry_run_cli_on_one_card(tmp_path):
    out = tmp_path / "dry.jsonl"
    D.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--out",
            str(out)])
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["ok"] and rec["chips"] == 1 and rec["mesh"] == "1x1"
    assert rec["collective_bytes"] == 0.0 and rec["t_collective_s"] == 0.0
    assert rec["cache_len"] == 32768 and rec["bottleneck"] == "memory"


def test_tooling_runs_with_jax_blocked():
    """The six modules import, and a dry run runs, with JAX blocked."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import repro_torch.hlocost, repro_torch.roofline\n"
        "import repro_torch.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.run_one('rwkv6-1.6b', 'long_500k', 'multi-pod')\n"
        "assert rec['chips'] == 512 and rec['collective_bytes'] is None\n"
        "assert not any(m == 'repro' or m.startswith('repro.')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"
