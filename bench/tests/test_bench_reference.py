"""The plain references (bench/reference) against the port at tiny widths
on the CPU, float32 on both sides: the served logits through the port's
prefill and ring decode, the training loss and every gradient leaf."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import fp8, leaves, qwen2, rwkv6

from . import _tiny

TOL = 2e-5


def _port(c):
    return harness.port_config(c)


@pytest.mark.parametrize("prompt", [40, 2112])
def test_qwen2_reference_matches_prefill_and_decode(prompt):
    """Prefill logits and four decode steps through the ring cache; 2112
    tokens take the flash route (its plain version on the CPU)."""
    from repro_torch.models import transformer as T
    c = _tiny.qwen2()
    cfg = _port(c)
    w = qwen2.make_weights(c, 2**31 + 3, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, c["vocab_size"], prompt + 4))
    with torch.inference_mode():
        lg, cache = T.prefill(cfg, w, toks[None, :prompt],
                              cache_len=prompt + 8)
        got = [lg[0, -1]]
        for i in range(4):
            lg, cache = T.decode_step(cfg, w, cache,
                                      toks[None, prompt + i:prompt + i + 1],
                                      prompt + i)
            got.append(lg[0, -1])
    got = torch.stack(got)
    want = qwen2.logits_at(c, w, toks, torch.arange(prompt - 1, prompt + 4))
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_rwkv6_reference_matches_loss_and_gradients():
    from repro_torch.train import steps as TS
    c = _tiny.rwkv6()
    cfg = _port(c)
    w = rwkv6.make_weights(c, 2**31 + 5, "cpu")
    ids = torch.randint(0, c["vocab_size"], (2, 129),
                        generator=torch.Generator().manual_seed(1))
    batch = {"inputs": ids[:, :-1], "targets": ids[:, 1:]}
    (loss, _), grads = TS.value_and_grad(cfg, w, batch, remat=True)
    alias = {p: t.detach().requires_grad_() for p, t in leaves(w)}
    tree = rwkv6._like(w, alias)
    want = rwkv6.loss(c, tree, batch["inputs"], batch["targets"])
    gw = torch.autograd.grad(want, list(alias.values()))
    want_f = float(want.detach())
    assert abs(float(loss) - want_f) <= TOL * abs(want_f)
    for (p, g), r in zip(leaves(grads), gw):
        assert float((g - r).abs().max()) <= TOL * float(r.abs().max()), p


@pytest.mark.parametrize("scale", [0.3, 1.0])
def test_rwkv6_reference_wkv_matches_the_port(scale):
    """The closed-form chunks against the port's plain WKV, log decays
    -exp(scale * N(0, 1)) (the cell's are -exp(N(0, 0.09^2)) or so; at
    scale 3 both float32 forms are 2e-3 off float64)."""
    from repro_torch.kernels import wkv_chunk as W
    g = torch.Generator().manual_seed(2)
    r, k, v = (torch.randn(2, 256, 3, 64, generator=g) for _ in range(3))
    logw = -torch.exp(scale * torch.randn(2, 256, 3, 64, generator=g))
    u = torch.randn(3, 64, generator=g)
    y, st = rwkv6.wkv(r, k, v, logw, u)
    y2, st2 = W.wkv_chunk_kernel(r, k, v, logw, u, device="cpu")
    assert float((y - y2).abs().max()) <= TOL * float(y2.abs().max())
    assert float((st - st2).abs().max()) <= TOL * float(st2.abs().max())


def test_fp8_rounds_through_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0, 1e-3]])
    y = fp8(x, -1)
    assert y[0, 2] == -448.0
    assert 0 < abs(float(y[0, 1]) - 0.3) <= 0.3 * 2 ** -4
    assert torch.equal(fp8(y, -1), y)
