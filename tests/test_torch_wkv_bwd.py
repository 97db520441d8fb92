"""The chunked WKV's backward (row 15's backward) on the CPU.

``csrc/wkv_chunk_bwd.cu`` differentiates the forward kernel in four
phases; ``wkv_chunk.wkv_backward_plain`` gives the same gradients from
explicit formulas and ``wkv_chunk.wkv_backward_phases_plain`` mirrors the
kernel's phases. Here:

- ``wkv_backward_plain``, reached through the port's
  ``models/ssm.py::_wkv_chunked`` under autograd (the ``WkvChunk``
  Function's CPU backward), against ``jax.vjp`` of the reference's
  ``repro.models.ssm._wkv_chunked``, dw included, with a random output
  gradient and the final state's gradient random and zero, on the chip
  script's ``WKV_CASES`` at batch 2 (ragged q = 24 and 5, D = 40 and 7).
  The reference is evaluated with 64-bit floats: its own float32
  gradient of w sits 2e-5 to 6e-5 of the leaf's largest entry from its
  float64 value on these inputs (dw = dlogw / w magnifies rounding where
  w is small), beyond the limit;
- ``wkv_backward_phases_plain`` (the kernel's phases: pairwise decays
  inside 16-step sub-chunks, factored products below them, k's decay
  once) against ``wkv_backward_plain``, and every exp2 it takes with an
  argument <= 0;
- the Function's gradients against autograd through ``wkv_plain``.

The limit is atol 1e-5 x the leaf's largest entry and rtol 1e-4 on
float32 results; on strong decays (logw = -exp(z / 2 + 3)) the phases'
float32 dlogw, a sum of differences of large terms, is held at the card
kernel's limit (3e-4 scaled by the leaf's largest entry, rtol 3e-4).
Inputs come from numpy seeds: r, k, v, z standard normal, u 0.1 x
normal, logw = -exp(z / 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM
from repro_torch.kernels import wkv_chunk as TW
from repro_torch.models import ssm as TSSM

#: (s, h, d, q): chip_smoke.WKV_CASES, each at batch 2
CASES = [(128, 2, 64, 32), (256, 4, 64, 64), (192, 1, 64, 64),
         (192, 1, 40, 24), (64, 3, 64, 64), (35, 1, 7, 5)]
#: (b, s, h, d, q, strong) for the phases: the cases, strong decays and
#: shapes the decomposition pads (q of 3 sub-chunks, q = 40 with D = 12)
PHASE_CASES = ([(2, *c, False) for c in CASES]
               + [(2, 256, 4, 64, 64, True), (1, 96, 2, 64, 48, False),
                  (1, 80, 3, 12, 40, True)])
ATOL, RTOL = 1e-5, 1e-4
CARD_TOL = 3e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du")


def _inputs(b, s, h, d, strong, seed):
    rng = np.random.default_rng(seed)
    r, k, v, z, dy = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                      for _ in range(5))
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    logw = (-np.exp(z * np.float32(0.5) + np.float32(3 if strong else 0))
            ).astype(np.float32)
    ds = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, logw, u, dy, ds


def _hold(got, want, name, atol=ATOL, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("s,h,d,q", CASES)
def test_backward_matches_the_reference_vjp(s, h, d, q, zero_state):
    b = 2
    r, k, v, logw, u, dy, ds = _inputs(b, s, h, d, False, s + d + q)
    if zero_state:
        ds = np.zeros_like(ds)
    w = np.exp(logw)
    with jax.enable_x64(True):
        st0 = jnp.zeros((b, h, d, d), jnp.float64)
        (st, y), vjp = jax.vjp(
            lambda *a: RSSM._wkv_chunked(*a, st0, q),
            *(jnp.asarray(a, jnp.float64) for a in (r, k, v, w, u)))
        want = [np.asarray(g) for g in vjp((jnp.asarray(ds, st.dtype),
                                            jnp.asarray(dy, y.dtype)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u)]
    calls = []
    real = TW.wkv_backward_plain

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "wkv_backward_plain", counted)
        tst, ty = TSSM._wkv_chunked(*leaves, q)
        got = torch.autograd.grad(
            (ty, tst), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    assert calls == [1] and ty.grad_fn is not None
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        _hold(g.numpy(), wv, name)


@pytest.mark.parametrize("b,s,h,d,q,strong", PHASE_CASES)
def test_backward_phases_match_plain(b, s, h, d, q, strong):
    r, k, v, logw, u, dy, ds = (torch.from_numpy(a) for a in _inputs(
        b, s, h, d, strong, 3 * s + d))
    want = TW.wkv_backward_plain(r, k, v, logw, u, dy, ds, q)
    got = TW.wkv_backward_phases_plain(r, k, v, logw, u, dy, ds, q)
    for name, g, wv in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        if strong and name == "dlogw":
            _hold(g, wv, name, CARD_TOL, CARD_TOL)
        else:
            _hold(g, wv, name)
    # no state gradient: the same as a zero one
    none = TW.wkv_backward_phases_plain(r, k, v, logw, u, dy, None, q)
    zero = TW.wkv_backward_phases_plain(r, k, v, logw, u, dy,
                                        torch.zeros_like(ds), q)
    assert all(bool(torch.equal(a, c)) for a, c in zip(none, zero))


@pytest.mark.parametrize("b,s,h,d,q,strong", PHASE_CASES)
def test_backward_phases_take_no_exp_above_zero(b, s, h, d, q, strong):
    """Every exp2 of the mirror (the forward's states, A', B', C') takes
    arguments <= 0, so every factor lies in [0, 1]: ragged sub-chunks,
    padded D and strong decays included. No natural exp is taken."""
    r, k, v, logw, u, dy, ds = (torch.from_numpy(a) for a in _inputs(
        b, s, h, d, strong, 3 * s + d))
    tops = []
    real = torch.exp2

    def exp2(x, *a, **kw):
        tops.append(float(x.max()) if x.numel() else float("-inf"))
        return real(x, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a natural exp in the mirror")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "exp2", exp2)
        mp.setattr(torch, "exp", refuse)
        got = TW.wkv_backward_phases_plain(r, k, v, logw, u, dy, ds, q)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert len(tops) > 5 and max(tops) <= 0.0, max(tops)


@pytest.mark.parametrize("zero_state", [False, True])
@pytest.mark.parametrize("s,h,d,q", [CASES[0], CASES[3], CASES[5]])
def test_function_matches_autograd_of_the_plain_forward(s, h, d, q,
                                                        zero_state):
    """``wkv_chunk_kernel`` under grad goes through ``WkvChunk``; its
    gradients of r, k, v, logw and u against autograd through
    ``wkv_plain``, with the state's output unused when its gradient is
    zero (the Function then gets None for it)."""
    arrays = _inputs(2, s, h, d, False, 5 * s + d)
    dy, ds = (torch.from_numpy(a) for a in arrays[5:])
    want_in = [torch.tensor(a, requires_grad=True) for a in arrays[:5]]
    got_in = [torch.tensor(a, requires_grad=True) for a in arrays[:5]]
    y0, st0 = TW.wkv_plain(*want_in, q)
    y, st = TW.wkv_chunk_kernel(*got_in, q=q, device="cpu")
    assert type(y.grad_fn).__name__ == "WkvChunkBackward"
    outs, gouts = ((y0,), (y,)), (dy,)
    if not zero_state:
        outs, gouts = ((y0, st0), (y, st)), (dy, ds)
    want = torch.autograd.grad(outs[0], want_in, gouts)
    got = torch.autograd.grad(outs[1], got_in, gouts)
    for name, g, wv in zip(NAMES, got, want):
        _hold(g, wv, name)


def test_no_function_without_grad():
    """Under no_grad, and with no input that requires grad, the call
    records no graph and returns the plain forward."""
    r, k, v, logw, u, _, _ = (torch.from_numpy(a)
                              for a in _inputs(1, 64, 2, 16, False, 1))
    y, st = TW.wkv_chunk_kernel(r, k, v, logw, u, q=32, device="cpu")
    assert y.grad_fn is None and st.grad_fn is None
    with torch.no_grad():
        y2, _ = TW.wkv_chunk_kernel(r.requires_grad_(), k, v, logw, u, q=32,
                                    device="cpu")
    assert y2.grad_fn is None and torch.equal(y, y2)
