"""The port's three standalone kernels (in-place RMSNorm, flash attention,
chunked WKV) against the JAX package's: each plain PyTorch version against
the reference's Pallas kernel in interpret mode, at the shapes of the
reference's own tests (tests/test_kernels.py), and the port's oracles
(``kernels/ref.py``) against the reference's.

Inputs are made with numpy from seeds; each package gets its own copy (the
RMSNorm writes into x, and ``torch.as_tensor`` of an array shares its
memory). bfloat16 inputs are the same float32 arrays cast in each
framework (both round to nearest even). Tolerances are the reference's:
RMSNorm 2e-5 (float32) and 5e-2 (bfloat16), attention 2e-4, WKV 3e-4 on
y and on the state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import ref as RREF
from repro.kernels.wkv_chunk import wkv_chunk_kernel as r_wkv
from repro.models import ssm as RSSM
from repro.models.layers import _sdpa_blockwise

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import inplace_rmsnorm as TR
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import wkv_chunk as TW

RMS_SHAPES = [(64, 32), (256, 64), (128, 200), (8, 8)]
#: (s, t, h, d, causal, block_q, block_k): the reference's
#: test_flash_attention_matches_ref shapes (blocks 64), its non-causal
#: case (blocks 32), a causal call with T < S, and other block choices
FLASH_CASES = [
    (128, 128, 4, 64, True, 64, 64), (256, 256, 2, 32, True, 64, 64),
    (64, 256, 3, 16, True, 64, 64), (32, 32, 1, 128, True, 64, 64),
    (64, 128, 2, 32, False, 32, 32), (64, 32, 2, 32, True, 64, 64),
    (128, 128, 4, 64, True, 32, 128), (64, 256, 3, 16, True, 128, 32),
] + [
    # the kernel's padded reduction depths (D = 96 and a ragged D = 40) and
    # a length that is no multiple of its tiles; f32 and bf16 below
    (1000, 1000, 2, 96, True, 128, 128), (300, 200, 2, 40, True, 64, 64),
    (120, 250, 3, 40, False, 64, 64),
]
#: the cases of FLASH_CASES the bfloat16 test runs too
FLASH_BF16_CASES = FLASH_CASES[-3:]
#: (s, h, d, q) of test_wkv_chunk_kernel_matches_sequential, batch 2
WKV_CASES = [(128, 2, 64, 32), (256, 4, 64, 64), (192, 1, 64, 64)]
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _normal(seed: int, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# in-place RMSNorm (row 13)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", RMS_SHAPES)
def test_rmsnorm_plain_matches_pallas_and_writes_into_x(n, d, dt):
    x, g, r = _normal(n * 1000 + d, (n, d), (d,), (n, d))
    jx, jg, jr = (jnp.asarray(a.copy()).astype(JAX_DT[dt]) for a in (x, g, r))
    want = RO.rmsnorm_residual(jx, jg, jr, interpret=True)
    tx, tg, tr = (torch.tensor(a.copy()).to(TORCH_DT[dt]) for a in (x, g, r))
    ptr = tx.data_ptr()
    got = TO.rmsnorm_residual(tx, tg, tr, device="cpu")
    assert got is tx and got.data_ptr() == ptr and got.dtype == TORCH_DT[dt]
    tol = 5e-2 if dt == "bf16" else 2e-5
    _close(_np(got), want, tol)
    oracle = TREF.rmsnorm_scale_residual(
        *(torch.tensor(a).to(TORCH_DT[dt]) for a in (x, g, r)))
    _close(_np(got), _np(oracle), tol)


def test_rmsnorm_plain_walks_the_reference_blocks():
    """The plain version's blocks (a divisor of N) do not change the
    result, and a numpy x on the CPU is written in place."""
    x, g, r = _normal(7, (96, 40), (40,), (96, 40))
    want = TREF.rmsnorm_scale_residual(torch.tensor(x), torch.tensor(g),
                                       torch.tensor(r))
    for block in (128, 40, 7):
        xt = torch.tensor(x)
        TR.rmsnorm_scale_residual_inplace(xt, torch.tensor(g),
                                          torch.tensor(r), block=block)
        torch.testing.assert_close(xt, want, rtol=0, atol=0)
    xa = x.copy()
    TO.rmsnorm_residual(xa, g, r, device="cpu")
    np.testing.assert_array_equal(xa, want.numpy())


# ---------------------------------------------------------------------------
# flash attention (row 14)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,t,h,d,causal,bq,bk", FLASH_CASES)
def test_flash_plain_matches_pallas(s, t, h, d, causal, bq, bk):
    q, k, v = _normal(s + t + h + d, (s, h, d), (t, h, d), (t, h, d))
    want = RO.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=bq, block_k=bk,
                              interpret=True)
    got = TO.flash_attention(q.copy(), k.copy(), v.copy(), causal=causal,
                             block_q=bq, block_k=bk, device="cpu")
    assert got.shape == (s, h, d) and got.dtype == torch.float32
    _close(_np(got), want, 2e-4)
    oracle = TREF.attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), causal=causal)
    _close(_np(got), _np(oracle), 2e-4)


def test_flash_rows_that_see_no_key_average_v():
    """Causal with T < S: the first S - T rows see no key and, as in the
    reference (finite -1e30 mask), average v over all T keys."""
    s, t, h, d = 64, 32, 2, 32
    q, k, v = _normal(3, (s, h, d), (t, h, d), (t, h, d))
    got = TO.flash_attention(q, k, v, block_q=16, block_k=8, device="cpu")
    mean = v.mean(axis=0)
    np.testing.assert_allclose(_np(got)[:s - t], np.broadcast_to(
        mean, (s - t, h, d)), rtol=2e-4, atol=2e-4)


def test_flash_bf16_plain_matches_pallas():
    q, k, v = _normal(11, (128, 2, 64), (128, 2, 64), (128, 2, 64))
    want = RO.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)), block_q=64, block_k=64,
                              interpret=True)
    got = TO.flash_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)),
                             block_q=64, block_k=64, device="cpu")
    assert got.dtype == torch.bfloat16
    _close(_np(got), want, 5e-2)


@pytest.mark.parametrize("s,t,h,d,causal,bq,bk", FLASH_BF16_CASES)
def test_flash_bf16_plain_matches_pallas_and_oracle(s, t, h, d, causal, bq,
                                                    bk):
    q, k, v = _normal(s + t + h + d, (s, h, d), (t, h, d), (t, h, d))
    want = RO.flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in (q, k, v)), causal=causal,
                              block_q=bq, block_k=bk, interpret=True)
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in (q, k, v))
    got = TO.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_k=bk, device="cpu")
    assert got.shape == (s, h, d) and got.dtype == torch.bfloat16
    _close(_np(got), want, 5e-2)
    _close(_np(got), _np(TREF.attention(tq, tk, tv, causal=causal)), 5e-2)


#: (s, t, causal): square, T > S, T < S (rows that see no key), lengths
#: that are no multiple of either tile, a single query row, the full
#: width, a query tile and one key more than its keys, a chunk of queries
#: at the end of a long prompt, one key
WALK_CASES = [(256, 256, True), (128, 320, True), (300, 200, True),
              (1000, 1000, True), (1, 4096, False), (70, 129, False),
              (65, 65, True), (200, 70, True), (1, 1, True),
              (4096, 4096, True), (1000, 1000, False), (128, 64, True),
              (127, 128, True), (257, 257, True), (2, 4097, True),
              (129, 4096, True), (64, 4096, True), (4096, 1, False)]


def _visible(s, t, causal):
    """(row, key) -> takes part: causal sees kpos <= qpos + T - S, and a
    row that sees no key averages them all."""
    rows = np.arange(s)[:, None]
    keys = np.arange(t)[None, :]
    if not causal:
        return np.ones((s, t), bool)
    vis = keys <= rows + (t - s)
    vis[~vis.any(axis=1)] = True
    return vis


@pytest.mark.parametrize("s,t,causal", WALK_CASES)
def test_flash_tile_walk_covers_every_visible_pair(s, t, causal):
    """The kernel's CTAs, through their plain-Python mirror (one walk for
    both types): every query row of every head in exactly one CTA, every
    visible (row, key) pair in a walked key tile, no visible pair in a
    skipped one, launch order never rising in work (key tiles), and with
    T < S every tile walked. The kernel's own walk is held by the card
    tests (tests/test_torch_cuda.py, f32 within 2e-4 of the plain
    version)."""
    h = 3
    walk = TF.tile_walk(s, t, h, causal)
    bq, bk = TF.TILE_Q, TF.TILE_K
    assert len(walk) == h * -(-s // bq)
    seen = np.zeros((h, s), int)
    vis = _visible(s, t, causal)
    ntiles = -(-t // bk)
    for head, q0, q1, tiles in walk:
        assert q0 % bq == 0 and q1 == min(q0 + bq, s)
        assert 1 <= tiles <= ntiles
        seen[head, q0:q1] += 1
        walked = np.zeros(t, bool)
        walked[:tiles * bk] = True
        rows = vis[q0:q1]
        assert not (rows & ~walked).any(), (q0, q1, tiles)
        # no skipped tile holds a visible pair of these rows
        assert not rows[:, tiles * bk:].any()
        if causal and t < s:
            assert tiles == ntiles
    assert (seen == 1).all()
    work = [tiles for _, _, _, tiles in walk]
    assert all(a >= b for a, b in zip(work, work[1:]))
    # heads are the fastest grid dimension: a query tile's heads in a row
    assert [w[0] for w in walk[:h]] == list(range(h))


def test_flash_tile_walk_mirrors_the_kernel_tiles():
    """The mirror's tiles are the kernel source's constants: bf16 warps of
    16 query rows, the f32 query tile, the key tile."""
    import re
    src = (build.CSRC / "flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert TF.TILE_Q == 16 * const("WARPS16") == const("BQ32")
    assert TF.TILE_K == const("BK")


def test_flash_tile_walk_skips_what_the_causal_mask_hides():
    """Causal S = T: the query tile of rows [q0, q1) walks key tiles up to
    q1 - 1 only, so the walk does about half the square's work."""
    s = t = 4096
    walk = TF.tile_walk(s, t, 1, True)
    for _, q0, q1, tiles in walk:
        assert tiles == -(-q1 // TF.TILE_K)
    total = sum(w[3] for w in walk) * TF.TILE_Q * TF.TILE_K
    assert total / (s * t) < 0.52
    assert TF.tile_walk(s, t, 1, False)[0][3] == t // 64


def test_flash_card_inputs_must_be_aligned():
    """The kernel copies 16 bytes at a time: a contiguous view that does
    not start on a 16-byte boundary is refused with ValueError, as is a
    strided one; aligned contiguous tensors pass."""
    for ty in (torch.float32, torch.bfloat16):
        buf = torch.zeros(64 * 2 * 16 + 16, dtype=ty)
        n = 64 * 2 * 16
        good = buf[:n].view(64, 2, 16)
        assert good.data_ptr() % 16 == 0
        TF.check_card_inputs(good, good, good)
        for off in (1, 2, 4):
            bad = buf[off:off + n].view(64, 2, 16)
            if bad.data_ptr() % 16 == 0:
                continue
            for args, name in (((bad, good, good), "q"),
                               ((good, bad, good), "k"),
                               ((good, good, bad), "v")):
                with pytest.raises(ValueError, match=f"{name} must start "
                                   "on a 16-byte"):
                    TF.check_card_inputs(*args)
        strided = torch.zeros(64, 2, 32, dtype=ty)[..., :16]
        with pytest.raises(ValueError, match="contiguous"):
            TF.check_card_inputs(strided, good, good)


def test_flash_matches_model_sdpa_blockwise():
    """The reference's jaxpr-level blockwise attention is the same
    algorithm: the port's plain version against it."""
    s, h, d = 96, 2, 32
    q, k, v = _normal(96, (1, s, h, d), (1, s, h, d), (1, s, h, d))
    want = _sdpa_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           offset=0, window=0, block=32)[0]
    got = TO.flash_attention(q[0].copy(), k[0].copy(), v[0].copy(),
                             block_q=32, block_k=32, device="cpu")
    _close(_np(got), want, 2e-4)


# ---------------------------------------------------------------------------
# chunked WKV (row 15)
# ---------------------------------------------------------------------------


def _wkv_inputs(s, h, d):
    b = 2
    r, k, v, z = _normal(s + h, *([(b, s, h, d)] * 4))
    u = _normal(s + h + 1, (h, d))[0] * np.float32(0.1)
    w = np.exp(-np.exp(z * np.float32(0.5)))
    return r, k, v, np.log(w).astype(np.float32), w, u


@pytest.mark.parametrize("s,h,d,q", WKV_CASES)
def test_wkv_plain_matches_pallas_and_sequential(s, h, d, q):
    r, k, v, logw, w, u = _wkv_inputs(s, h, d)
    y_k, st_k = r_wkv(*(jnp.asarray(a) for a in (r, k, v, logw, u)), q=q,
                      interpret=True)
    y, st = TW.wkv_chunk_kernel(r.copy(), k.copy(), v.copy(), logw.copy(),
                                u.copy(), q=q, device="cpu")
    assert y.shape == (2, s, h, d) and st.shape == (2, h, d, d)
    assert y.dtype == st.dtype == torch.float32
    _close(_np(y), y_k, 3e-4)
    _close(_np(st), st_k, 3e-4)

    ju = jnp.asarray(u)
    xs = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (r, k, v, w))
    st_seq, outs = jax.lax.scan(lambda c, x: RSSM._rwkv_step(c, x, ju),
                                jnp.zeros((2, h, d, d), jnp.float32), xs)
    _close(_np(y), jnp.moveaxis(outs, 0, 1), 3e-4)
    _close(_np(st), st_seq, 3e-4)


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ih,iw,c,k,stride,pad", [
    (16, 16, 8, 3, 1, 1), (17, 13, 4, 3, 2, 0), (12, 12, 8, 5, 1, 2)])
def test_ref_dwconv2d_matches_reference(ih, iw, c, k, stride, pad):
    x, w = _normal(ih * iw + c, (ih, iw, c), (k, k, c))
    want = RREF.dwconv2d(jnp.asarray(x), jnp.asarray(w), stride, pad)
    got = TREF.dwconv2d(torch.tensor(x), torch.tensor(w), stride, pad)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ref_rmsnorm_matches_reference(dt):
    x, g, r = _normal(5, (32, 48), (48,), (32, 48))
    want = RREF.rmsnorm_scale_residual(
        *(jnp.asarray(a).astype(JAX_DT[dt]) for a in (x, g, r)))
    got = TREF.rmsnorm_scale_residual(
        *(torch.tensor(a).to(TORCH_DT[dt]) for a in (x, g, r)))
    _close(_np(got), want, 5e-2 if dt == "bf16" else 2e-5)


@pytest.mark.parametrize("s,t,causal", [(48, 48, True), (64, 32, True),
                                        (32, 80, True), (40, 24, False)])
def test_ref_attention_matches_reference(s, t, causal):
    q, k, v = _normal(s * t, (s, 3, 16), (t, 3, 16), (t, 3, 16))
    want = RREF.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    got = TREF.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         causal=causal)
    _close(_np(got), want, 2e-4)


# ---------------------------------------------------------------------------
# entry points: no fallback, what the kernels refuse, the counters
# ---------------------------------------------------------------------------


def test_entry_points_raise_without_a_card(monkeypatch):
    """device=None means the card: without one each entry point raises
    rather than run the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, g = _normal(1, (8, 16), (16,))
    q = _normal(2, (16, 1, 16))[0]
    r4 = _normal(3, (1, 64, 1, 8))[0]
    for call in (lambda: TO.rmsnorm_residual(x, g, x.copy()),
                 lambda: TO.flash_attention(q, q, q),
                 lambda: TW.wkv_chunk_kernel(r4, r4, r4, -np.abs(r4),
                                             np.zeros((1, 8), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="g"):
        TR.rmsnorm_scale_residual_inplace(x, torch.zeros(7), torch.zeros(4, 8))
    with pytest.raises(ValueError, match="bfloat16"):
        TR.rmsnorm_scale_residual_inplace(x.double(), torch.zeros(8),
                                          torch.zeros(4, 8))
    q = torch.zeros(8, 2, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        TF.flash_attention_kernel(torch.zeros(8, 2, 12),
                                  torch.zeros(8, 2, 12),
                                  torch.zeros(8, 2, 12))
    with pytest.raises(ValueError, match="heads"):
        TF.flash_attention_kernel(q, torch.zeros(8, 1, 16),
                                  torch.zeros(8, 1, 16))
    with pytest.raises(ValueError, match="one type"):
        TF.flash_attention_kernel(q, q.bfloat16(), q)
    r = np.zeros((1, 48, 2, 8), np.float32)
    with pytest.raises(ValueError, match="multiple of q"):
        TW.wkv_chunk_kernel(r, r, r, r, np.zeros((2, 8), np.float32), q=32,
                            device="cpu")
    with pytest.raises(ValueError, match="u must be"):
        TW.wkv_chunk_kernel(r, r, r, r, np.zeros((8,), np.float32), q=16,
                            device="cpu")


def test_each_standalone_kernel_has_a_source_a_counter_and_a_plain_version():
    """Every entry with a signature of its own is a source in csrc/ and a
    module with a launch counter and a plain version; on the CPU the
    wrappers run the plain version and count nothing (the flash and WKV
    backwards too, under autograd)."""
    modules = {"rmsnorm_inplace": (TR, "LAUNCHES", TR.rmsnorm_plain),
               "flash_attention": (TF, "LAUNCHES", TF.flash_plain),
               "flash_attention_bwd": (TF, "BWD_LAUNCHES",
                                       TF.flash_backward_plain),
               "wkv_chunk": (TW, "LAUNCHES", TW.wkv_plain),
               "wkv_chunk_bwd": (TW, "BWD_LAUNCHES",
                                 TW.wkv_backward_plain)}
    assert set(build.ARGTYPES_OF) == set(modules) <= set(build.KERNELS)
    for mod, counter, plain in modules.values():
        mod.reset_launches()
        assert getattr(mod, counter) == 0 and callable(plain)
    TO.rmsnorm_residual(np.ones((2, 8), np.float32), np.ones(8, np.float32),
                        np.ones((2, 8), np.float32), device="cpu")
    q = np.ones((16, 1, 16), np.float32)
    TO.flash_attention(q, q, q, device="cpu")
    qg = torch.ones((16, 1, 16), requires_grad=True)
    TO.flash_attention(qg, qg, qg, device="cpu").sum().backward()
    assert qg.grad is not None
    r = np.ones((1, 16, 1, 8), np.float32)
    TW.wkv_chunk_kernel(r, r, r, -r, np.ones((1, 8), np.float32), q=16,
                        device="cpu")
    rg = torch.ones((1, 16, 1, 8), requires_grad=True)
    y, _ = TW.wkv_chunk_kernel(rg, rg, rg, -rg, torch.ones((1, 8)), q=16,
                               device="cpu")
    y.sum().backward()
    assert rg.grad is not None
    assert [getattr(m, c) for m, c, _ in modules.values()] == [0] * 5
