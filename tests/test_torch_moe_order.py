"""MoE's sums in a fixed order, and the card runs reckoned before they run.

``repro_torch.models.moe._moe_ffn_local`` against an explicit loop that
sums each token's kept copies in top-k order: its output bit for bit, and
its gradient with respect to x bit for bit (the router's part plus each
token's copies' gradients summed in top-k order), with ample capacity and
with drops; and it calls no floating-point ``index_add_``, whose atomic
adds on the card fall in no fixed order.

Then every model run of ``chip_smoke.py`` reckoned on the meta device: a
served model's weights, a shapes-phase run's weights with its cache at its
batch, and a trained model's state at ``STATE_BYTES`` a parameter stay
under ``SERVE_LIMIT`` and ``TRAIN_LIMIT`` (room on one 80 GB card for the
activations, the cache and the gradients beside them), and every
configured arch has a card run and a card test
(``tests/test_torch_cuda.py``).
"""
import dataclasses
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, registry
from repro_torch.launch.specs import cache_len_for
from repro_torch.models import moe as TM
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES
from repro_torch.optim import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

#: a served model's weights, and a trained model's state at STATE_BYTES a
#: parameter (bf16 params, f32 m and v), on one 80 GB card
SERVE_LIMIT = 60e9
TRAIN_LIMIT = 40e9
STATE_BYTES = 10

#: (capacity factor, experts, top k): the reduced olmoe's 4 and 2, and 16
#: and 8, where the order of a token's copies matters; 8.0 keeps every
#: copy, 1.0 drops some
CASES = [(cf, e, k) for cf in (8.0, 1.0) for e, k in ((4, 2), (16, 8))]


def _cfg(cf, e, k):
    return dataclasses.replace(get_arch("olmoe-1b-7b").reduced(),
                               capacity_factor=cf, num_experts=e,
                               experts_per_token=k)


def _inputs(cfg, seed):
    params = TM.moe_init(cfg, torch.Generator().manual_seed(seed), "cpu")
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    return params, x


def _loop(p, x, cfg, grads=None):
    """The MoE layer with its dispatch and combine as loops over the copies:
    each kept copy written to its expert slot, each token's weighted kept
    copies summed in top-k order. With ``grads`` = (d out, d aux), the
    gradient with respect to x: the router's part (autograd, the expert
    inputs held apart) plus, for each token, its kept copies' gradients at
    the expert inputs summed in top-k order. Returns (out, aux) or dx."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d).detach().requires_grad_()
    gate_w, _, aux, keep, dest, cap = TM._route(p, xf, cfg)
    keep_l, dest_l = keep.tolist(), dest.tolist()
    buf = torch.zeros((e * cap, d))
    for i in range(t * k):
        if keep_l[i]:
            buf[dest_l[i]] = xf.detach()[i // k]
    buf.requires_grad_()
    y_flat = TM._experts(p, buf.reshape(e, cap, d)).reshape(e * cap, d)
    y_copy = torch.where(keep[:, None],
                         y_flat[torch.clamp(dest, max=e * cap - 1)],
                         torch.zeros(()))
    yw = y_copy * (gate_w.reshape(t * k) * keep)[:, None]
    rows = []
    for ti in range(t):
        acc = torch.zeros(d)
        for j in range(k):
            if keep_l[ti * k + j]:
                acc = acc + yw[ti * k + j]
        rows.append(acc)
    out = torch.stack(rows).reshape(b, s, d)
    if grads is None:
        return out.detach(), aux.detach()
    g_router, g_buf = torch.autograd.grad((out, aux), (xf, buf), grads)
    dx = []
    for ti in range(t):
        acc = torch.zeros(d)
        for j in range(k):
            if keep_l[ti * k + j]:
                acc = acc + g_buf[dest_l[ti * k + j]]
        dx.append(g_router[ti] + acc)
    return torch.stack(dx).reshape(b, s, d)


@pytest.mark.parametrize("cf,e,k", CASES)
def test_moe_output_sums_copies_in_topk_order(cf, e, k):
    """The output and aux equal the loop's bit for bit."""
    cfg = _cfg(cf, e, k)
    p, x = _inputs(cfg, 1)
    got, gaux = TM._moe_ffn_local(p, x, cfg)
    want, waux = _loop(p, x, cfg)
    if cf == 1.0:   # the case drops copies
        keep = TM._route(p, x.reshape(-1, cfg.d_model), cfg)[3]
        assert not bool(keep.all())
    assert torch.equal(got, want)
    assert torch.equal(gaux, waux)


@pytest.mark.parametrize("cf,e,k", CASES)
def test_moe_gradient_sums_copies_in_topk_order(cf, e, k):
    """The gradient with respect to x equals the loop's bit for bit: the
    k copies of a token are one expanded row, whose backward sums the
    copies' gradients in top-k order."""
    cfg = _cfg(cf, e, k)
    p, x = _inputs(cfg, 2)
    rng = np.random.default_rng(3)
    g_out = torch.as_tensor(rng.standard_normal(x.shape).astype(np.float32))
    g_aux = torch.tensor(0.7)
    xg = x.clone().requires_grad_()
    out, aux = TM._moe_ffn_local(p, xg, cfg)
    got, = torch.autograd.grad((out, aux), xg, (g_out, g_aux))
    want = _loop(p, x, cfg, (g_out, g_aux))
    assert torch.equal(got, want)


def test_moe_calls_no_float_index_add(monkeypatch):
    """Neither the forward nor the backward calls a floating-point
    ``index_add_`` (whose adds on the card fall in no fixed order); the
    weights get gradients."""
    real = {n: getattr(torch.Tensor, n) for n in ("index_add_", "index_add")}
    real_fn = torch.index_add

    def refuse(name, fn):
        def run(self, *a, **kw):
            if self.is_floating_point():
                raise AssertionError(f"a floating-point {name}")
            return fn(self, *a, **kw)
        return run
    for n, fn in real.items():
        monkeypatch.setattr(torch.Tensor, n, refuse(n, fn))
    monkeypatch.setattr(torch, "index_add", refuse("index_add", real_fn))
    cfg = _cfg(1.0, 16, 8)
    p, x = _inputs(cfg, 4)
    leaves = adamw.tree_leaves(p)
    for t in leaves:
        t.requires_grad_()
    out, aux = TM._moe_ffn_local(p, x.requires_grad_(), cfg)
    grads = torch.autograd.grad(out.sum() + aux, [x, *leaves])
    assert all(bool(g.abs().sum() > 0) for g in grads)


# ---------------------------------------------------------------------------
# the card runs, reckoned on the meta device
# ---------------------------------------------------------------------------


def _meta_params(cfg):
    return T.init_params(cfg, torch.Generator(), "meta")


def _count(tree) -> int:
    return sum(t.numel() for t in adamw.tree_leaves(tree))


#: every served model of chip_smoke.py: (label, arch, layers kept, dtype)
SERVED = ([(f"{a} f32", a, None, "float32") for a, _, _ in CS.MODEL_RUNS]
          + [(f"{a} bf16", a, None, "bfloat16") for a, _, _ in CS.MODEL_RUNS]
          + [(f"{a} f32", a, None, "float32") for a, _, _ in CS.ARCH_F32]
          + [(a, a, n, "bfloat16") for a, n, _ in CS.ARCH_SERVE])
#: every run of the shapes phase with its cache: (label, arch, dtype,
#: batch, shape whose cache_len_for sizes the cache)
SHAPE_RUNS = ([(f"{a} 32k", a, "bfloat16", CS.SHAPE_BATCH, "decode_32k")
               for a in CS.SHAPE_ARCHS]
              + [(f"{CS.SHAPE_F32_ARCH} 32k f32", CS.SHAPE_F32_ARCH,
                  "float32", 1, "decode_32k"),
                 (f"{CS.LONG_ARCH} 500k", CS.LONG_ARCH, "bfloat16", 1,
                  "long_500k"),
                 (f"{CS.RING_ARCH} ring", CS.RING_ARCH, "bfloat16", 1,
                  "long_500k")])
#: every trained model: (label, arch, layers kept)
TRAINED = ([(CS.TRAIN_ARCH, CS.TRAIN_ARCH, None),
            (CS.RWKV_TRAIN_ARCH, CS.RWKV_TRAIN_ARCH, None)]
           + [(a, a, n) for a, n, _, _ in CS.ARCH_TRAIN])


@pytest.mark.parametrize("label,arch,layers,dtype", SERVED,
                         ids=[s[0] for s in SERVED])
def test_served_weights_fit_the_card(label, arch, layers, dtype):
    """A served model's weights (meta tensors of its dtype) under
    ``SERVE_LIMIT``; the archs phase's cuts are depth only."""
    cfg, cut = CS.cut_arch(arch, layers)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    base = get_arch(arch)
    assert (cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.vocab_size) == (
        base.d_model, base.num_heads, base.d_ff, base.vocab_size)
    assert (layers is None) == cut.startswith("uncut")
    nbytes = CS._tree_bytes(_meta_params(cfg))
    assert nbytes < SERVE_LIMIT, (label, nbytes)


@pytest.mark.parametrize("label,arch,dtype,batch,shape", SHAPE_RUNS,
                         ids=[r[0] for r in SHAPE_RUNS])
def test_shape_runs_fit_the_card(label, arch, dtype, batch, shape):
    """A shapes-phase run's weights and its decode cache at its batch and
    ``cache_len_for`` slots (meta tensors) under ``SERVE_LIMIT``; the
    32k prompt and its new tokens fill the 32k cache exactly."""
    cfg = dataclasses.replace(get_arch(arch), dtype=dtype)
    clen = cache_len_for(cfg, SHAPES[shape])
    if shape == "decode_32k":
        assert CS.SHAPE_PROMPT + CS.ARCH_SERVE_NEW == clen == 32768
    nbytes = (CS._tree_bytes(_meta_params(cfg))
              + CS._tree_bytes(T.init_cache(cfg, batch, clen, "meta")))
    assert nbytes < SERVE_LIMIT, (label, nbytes)


def test_the_long_prompt_takes_the_wkv_kernel():
    """long_500k's prompt is the reference's 524,288 tokens, a multiple of
    the WKV chunk past one chunk, so RWKV's prefill runs the kernel."""
    s = CS.LONG_PROMPT
    assert s == SHAPES["long_500k"].seq_len
    assert s % S.WKV_CHUNK == 0 and s > S.WKV_CHUNK


@pytest.mark.parametrize("keep", [("first",), ("last",), ()])
def test_kernel_calls_keep_only_what_they_name(keep):
    """``chip_smoke.KernelCalls`` with ``host`` (the 500k run's layer 0,
    whose inputs beside the prefill's peak left the card too little
    room): it keeps the first call, the last or none as ``keep`` names,
    each kept tensor on the host and equal to the call's."""
    from repro_torch.kernels import wkv_chunk as TW
    rng = np.random.default_rng(0)
    calls_in = []
    for _ in range(3):
        r, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 8))
                                    .astype(np.float32)) for _ in range(3))
        logw = -torch.rand(1, 64, 2, 8)
        u = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
        calls_in.append((r, k, v, logw, u))
    with CS.KernelCalls(torch, keep=keep, host=True) as calls:
        outs = [TW.wkv_chunk_kernel(*a, q=16, device="cpu")
                for a in calls_in]
    assert TW.wkv_chunk_kernel is calls.real["wkv_chunk"]
    for name, i in (("first", 0), ("last", 2)):
        got = getattr(calls, name)
        if name not in keep:
            assert got == {}
            continue
        args, kw, out = got["wkv_chunk"]
        assert kw["q"] == 16
        for a, b in zip(args + out, calls_in[i] + outs[i]):
            assert a.device.type == "cpu" and torch.equal(a, b)


@pytest.mark.parametrize("label,arch,layers", TRAINED,
                         ids=[t[0] for t in TRAINED])
def test_trained_state_fits_the_card(label, arch, layers):
    """A trained model's state, ``STATE_BYTES`` a parameter (bf16 params,
    f32 m and v), under ``TRAIN_LIMIT``."""
    cfg, _ = CS.cut_arch(arch, layers)
    n = _count(_meta_params(cfg))
    assert n * STATE_BYTES < TRAIN_LIMIT, (label, n)


def test_every_arch_runs_on_the_card():
    """Every configured arch has a run in ``chip_smoke.py`` or a card test
    in ``tests/test_torch_cuda.py``; the archs phase serves every arch no
    earlier phase runs."""
    card = importlib.import_module("test_torch_cuda")
    runs = ({a for a, _, _ in CS.MODEL_RUNS}
            | {CS.TRAIN_ARCH, CS.RWKV_TRAIN_ARCH}
            | {a for a, _, _ in CS.ARCH_SERVE}
            | {a for a, _, _, _ in CS.ARCH_TRAIN})
    tested = {a for a, _ in card.MODEL_CASES}
    assert set(registry()) <= runs | tested
    assert set(registry()) <= tested
    assert {a for a, _, _, _ in CS.ARCH_TRAIN} <= {
        a for a, _, _ in CS.ARCH_SERVE}
    earlier = {a for a, _, _ in CS.MODEL_RUNS}
    assert set(registry()) - earlier == {a for a, _, _ in CS.ARCH_SERVE}
