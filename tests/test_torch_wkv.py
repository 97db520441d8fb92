"""The chunked WKV kernel's decomposition (row 15) on the CPU.

``csrc/wkv_chunk.cu`` splits the recurrence into three phases over every
chunk at once and factors the decays below each 16-step sub-chunk at the
sub-chunk's first step. ``wkv_chunk.wkv_phases_plain`` mirrors that
decomposition (phases A-C, the segmented scan, the sub-chunk factors and a
ragged last sub-chunk) in plain PyTorch; here it is held against the
reference's Pallas kernel in interpret mode, the reference's sequential
``_rwkv_step`` scan and the port's plain version, at the reference's
tolerance, 3e-4 (atol = rtol) on y and the state.

Inputs are made with numpy from seeds: r, k, v, z standard normal, u
0.1 x normal, logw = -exp(z / 2) as the reference's tests make it, or
-exp(z / 2 + 3) for strong decays, where a chunk's cumulative log-decay
falls far past -88.7 and exp(-lwc) leaves f32's range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv_chunk import wkv_chunk_kernel as r_wkv
from repro.models import ssm as RSSM

from repro_torch.kernels import wkv_chunk as TW

#: (b, s, h, d, q, strong): the reference's test shapes at batch 2, a
#: ragged D and q (rows of 160 B, a sub-chunk of 8 steps), a single chunk,
#: and strong decays
CASES = [
    (2, 128, 2, 64, 32, False), (2, 256, 4, 64, 64, False),
    (2, 192, 1, 64, 64, False), (2, 192, 1, 40, 24, False),
    (2, 64, 3, 64, 64, False), (2, 256, 4, 64, 64, True),
]
#: shapes the decomposition pads: q of 3 sub-chunks, q = 5 with D = 7,
#: q = 40 with D = 12
PLAIN_CASES = [(1, 96, 2, 64, 48, False), (2, 35, 1, 7, 5, False),
               (1, 80, 3, 12, 40, True)]
TOL = 3e-4


def _inputs(b, s, h, d, strong, seed):
    rng = np.random.default_rng(seed)
    r, k, v, z = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    u = (rng.standard_normal((h, d)) * 0.1).astype(np.float32)
    logw = (-np.exp(z * np.float32(0.5) + np.float32(3 if strong else 0))
            ).astype(np.float32)
    return r, k, v, logw, np.exp(logw), u


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _phases(r, k, v, logw, u, q):
    y, st = TW.wkv_phases_plain(*(torch.from_numpy(a.copy())
                                  for a in (r, k, v, logw, u)), q)
    assert y.dtype == st.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    return y.numpy(), st.numpy()


@pytest.mark.parametrize("b,s,h,d,q,strong", CASES)
def test_wkv_phases_match_pallas_and_sequential(b, s, h, d, q, strong):
    r, k, v, logw, w, u = _inputs(b, s, h, d, strong, s + h + d)
    y, st = _phases(r, k, v, logw, u, q)
    assert y.shape == (b, s, h, d) and st.shape == (b, h, d, d)
    y_k, st_k = r_wkv(*(jnp.asarray(a) for a in (r, k, v, logw, u)), q=q,
                      interpret=True)
    _close(y, y_k)
    _close(st, st_k)

    ju = jnp.asarray(u)
    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, w))
    st_seq, outs = jax.lax.scan(lambda c, x: RSSM._rwkv_step(c, x, ju),
                                jnp.zeros((b, h, d, d), jnp.float32), xs)
    _close(y, jnp.moveaxis(outs, 0, 1))
    _close(st, st_seq)


@pytest.mark.parametrize("b,s,h,d,q,strong", CASES[3:] + PLAIN_CASES)
def test_wkv_phases_match_plain(b, s, h, d, q, strong):
    r, k, v, logw, _, u = _inputs(b, s, h, d, strong, 7 * s + d)
    y, st = _phases(r, k, v, logw, u, q)
    y0, st0 = TW.wkv_plain(*(torch.from_numpy(a) for a in (r, k, v, logw,
                                                           u)), q)
    _close(y, y0.numpy())
    _close(st, st0.numpy())


def test_strong_decay_overflows_the_naive_factorisation():
    """exp(lwp[t] - lwc[j]) = exp(lwp[t]) * exp(-lwc[j]) is exact in real
    numbers, but exp(-lwc) leaves f32's range on the strong-decay input,
    so y computed that way is not finite; the sub-chunk factors (each <= 1)
    keep every output finite and within tolerance."""
    b, s, h, d, q, strong = CASES[-1]
    r, k, v, logw, _, u = _inputs(b, s, h, d, strong, s + h + d)
    lwc = logw.reshape(b, s // q, q, h, d).cumsum(2, dtype=np.float32)
    assert lwc.min() < -1000
    with np.errstate(over="ignore", invalid="ignore"):
        assert np.isinf(np.exp(-lwc)).any()
        # the att of chunk 0, (b, h) = (0, 0), through the naive split
        c0 = lwc[0, 0, :, 0]
        lwp = np.concatenate([np.zeros((1, d), np.float32), c0[:-1]])
        rt = r[0, :q, 0] * np.exp(lwp)
        kt = k[0, :q, 0] * np.exp(-c0)
        naive = np.tril(rt @ kt.T, -1)
    assert not np.isfinite(naive).all()
    y, st = _phases(r, k, v, logw, u, q)
    y0, st0 = TW.wkv_plain(*(torch.from_numpy(a) for a in (r, k, v, logw,
                                                           u)), q)
    _close(y, y0.numpy())
    _close(st, st0.numpy())
