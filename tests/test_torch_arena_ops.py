"""Each kernel's plain PyTorch version (the CPU route of its wrapper)
against the JAX package's Pallas kernel in interpret mode, on the same
seeded flat byte arena and the same spec; the whole arena is compared.

Tolerances: int8 bit-exact, except softmax (<= 1 LSB: exp differs by an
ulp between the two libraries); f32 1e-4 absolute plus 1e-4 relative
(summation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arena_ops as R

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec import ops as TX
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.kernels import arena_ops as K

ARENA = 1024      # elements of every synthetic arena


def _ref_spec(spec: K.OpSpec) -> R.OpSpec:
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(K.OpSpec)}
    fields["stages"] = tuple(_ref_spec(s) for s in spec.stages)
    return R.OpSpec(**fields)


def _arena(dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "i8":
        return rng.integers(0, 256, ARENA, dtype=np.uint8)
    return rng.standard_normal(ARENA).astype(np.float32).view(np.uint8)


def _weight(shape, dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 100)
    if dtype == "i8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _compare(spec: K.OpSpec, got: np.ndarray, want: np.ndarray) -> None:
    n = 1
    for s in spec.out_shape:
        n *= s
    isz = 1 if spec.dtype == "i8" else 4
    lo, hi = spec.out_off, spec.out_off + n * isz
    outside = np.ones(got.size, bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    if spec.dtype == "i8":
        g = got[lo:hi].view(np.int8).astype(np.int32)
        w = want[lo:hi].view(np.int8).astype(np.int32)
        atol = 1 if spec.kind == "softmax" else 0
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    else:
        np.testing.assert_allclose(got[lo:hi].view(np.float32),
                                   want[lo:hi].view(np.float32),
                                   rtol=1e-4, atol=1e-4)


def _run_both(spec: K.OpSpec, arena: np.ndarray, weights) -> None:
    want = np.asarray(R.apply_op(
        jnp.asarray(arena), _ref_spec(spec),
        tuple(jnp.asarray(w) for w in weights), interpret=True))
    t = torch.from_numpy(arena.copy())
    tw = [torch.from_numpy(w) for w in weights]
    if spec.kind == "fused":
        w = K.pack_weights(spec, tw)
    else:
        w = tw[0] if tw else None
    before = dict(K.LAUNCHES)
    K.apply_op(t, spec, w)
    assert K.LAUNCHES == before     # the CPU route launches nothing
    _compare(spec, t.numpy(), want)


QM = (-3, float(np.float32(0.0123)), 5)

#: (id, kind, in_shape, out_shape, meta, in_off, out_off) in elements
CONV_CASES = [
    ("conv_same_s1", "conv2d", (6, 7, 3), (6, 7, 5),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), 0, 40),
    ("conv_valid_s2", "conv2d", (9, 9, 4), (4, 4, 3),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 300, 0),
    ("conv_same_s2_edge", "conv2d", (8, 8, 3), (4, 4, 4),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 10, 0),
    ("conv_band_neg_pad", "conv2d", (12, 6, 2), (3, 6, 4),
     (3, 3, 1, 1, 1, 1, -4, 1, 1), 0, 150),
    ("conv_1x1_band", "conv2d", (16, 5, 4), (3, 5, 6),
     (1, 1, 1, 1, 1, 1, -8, 0, 1), 0, 300),
    ("conv_dilated", "conv2d", (8, 8, 2), (4, 4, 3),
     (3, 3, 1, 1, 2, 2, 2, 2, 1), 0, 128),
    ("dw_in_place", "depthwise_conv2d", (6, 6, 4), (6, 6, 4),
     (3, 3, 1, 1, 1, 1, 1, 1, 1), 8, 8),
    ("dw_mult2_overlap", "depthwise_conv2d", (5, 5, 3), (5, 5, 6),
     (3, 3, 1, 1, 1, 1, 1, 1, 2), 0, 30),
    ("dw_s2_in_place", "depthwise_conv2d", (8, 8, 4), (4, 4, 4),
     (3, 3, 2, 2, 1, 1, 0, 0, 1), 20, 20),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_plain_matches_pallas(case, dtype):
    _, kind, ishp, oshp, meta, ioff, ooff = case
    isz = 1 if dtype == "i8" else 4
    spec = K.OpSpec(kind=kind, in_off=(ioff * isz,), in_shape=(ishp,),
                    out_off=ooff * isz, out_shape=oshp, dtype=dtype,
                    meta=meta, qmeta=QM if dtype == "i8" else ())
    w = _weight(K._weight_shape(spec), dtype, 1)
    _run_both(spec, _arena(dtype, 2), [w])


HEAD_CASES = [
    ("mean", K.OpSpec(kind="mean", in_off=(10,), in_shape=((4, 4, 16),),
                      out_off=10, out_shape=(16,), meta=((0, 1),))),
    ("mean_last_axes", K.OpSpec(kind="mean", in_off=(0,),
                                in_shape=((3, 5, 8),), out_off=200,
                                out_shape=(3,), meta=((1, 2),))),
    ("fc_overlap", K.OpSpec(kind="fully_connected", in_off=(25,),
                            in_shape=((32,),), out_off=20,
                            out_shape=(20,))),
    ("fc_rows", K.OpSpec(kind="fully_connected", in_off=(0,),
                         in_shape=((3, 16),), out_off=100,
                         out_shape=(3, 10))),
    ("softmax_in_place", K.OpSpec(kind="softmax", in_off=(3,),
                                  in_shape=((50,),), out_off=3,
                                  out_shape=(50,))),
    ("softmax_rows", K.OpSpec(kind="softmax", in_off=(0,),
                              in_shape=((4, 25),), out_off=40,
                              out_shape=(4, 25))),
]


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("case", HEAD_CASES, ids=[c[0] for c in HEAD_CASES])
def test_head_plain_matches_pallas(case, dtype):
    _, spec = case
    isz = 1 if dtype == "i8" else 4
    if spec.kind == "softmax":
        qm = ((float(np.float32(0.05)), 3), (float(np.float32(1 / 256)),
                                              -128))
    elif spec.kind == "mean":
        qm = (-3, float(np.float32(1.7)), 2)
    else:
        qm = (4, float(np.float32(0.0021)), -1)
    spec = dataclasses.replace(
        spec, dtype=dtype, qmeta=qm if dtype == "i8" else (),
        in_off=tuple(o * isz for o in spec.in_off),
        out_off=spec.out_off * isz)
    ws = ([_weight(K._weight_shape(spec), dtype, 3)]
          if spec.kind == "fully_connected" else [])
    _run_both(spec, _arena(dtype, 4), ws)


def _flagship_fused(bits: int):
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off")
    g = cp.graph
    w = TX.synth_weights(g, 0)
    q = TX.calibrate(g, 0, w) if bits == 1 else None
    specs = CudaExecutor(device="cpu").lower(cp.plan, q)
    (spec,) = [s for s in specs if s.kind == "fused"]
    members = [op for op in cp.plan.order if op.params.get("fuse_chain")]
    ws = [q.weights_q[id(op)]["filter"] if q is not None
          else w[id(op)]["filter"]
          for op in members if op.kind in K.WEIGHTED_KINDS]
    return spec, ws


@pytest.mark.parametrize("bits", [1, 4])
def test_fused_chain_plain_matches_pallas(bits):
    spec, ws = _flagship_fused(bits)
    assert len(spec.stages) == 17 and spec.stages[-1].kind == "concat"
    dtype = "i8" if bits == 1 else "f32"
    isz = 1 if bits == 1 else 4
    n = max([spec.out_off + 32 * 32 * 16 * isz]
            + [off + 64 * 64 * 8 * isz for off in spec.in_off])
    rng = np.random.default_rng(5)
    if dtype == "i8":
        arena = rng.integers(0, 256, n, dtype=np.uint8)
    else:
        arena = rng.standard_normal(-(-n // 4)).astype(np.float32).view(
            np.uint8)
    _run_both(spec, arena, ws)


# ---------------------------------------------------------------------------
# descriptors and wrapper checks
# ---------------------------------------------------------------------------


def test_descriptor_words_conv_and_fused():
    spec = K.OpSpec(kind="depthwise_conv2d", in_off=(8,),
                    in_shape=((5, 5, 3),), out_off=30, out_shape=(5, 5, 6),
                    dtype="i8", meta=(3, 3, 1, 1, 1, 1, 1, 1, 2), qmeta=QM)
    w = K.descriptor_words(spec)
    assert w.dtype == np.int32 and w.size == K.DESC_WORDS
    assert (w[K.D_KIND], w[K.D_QUANT], w[K.D_IN_OFF], w[K.D_OUT_OFF]) == \
        (K.K_DEPTHWISE, 1, 8, 30)
    assert tuple(w[K.D_IH:K.D_OC + 1]) == (5, 5, 3, 5, 5, 6)
    assert tuple(w[K.D_KH:K.D_MULT + 1]) == spec.meta
    assert w[K.D_AMULT:K.D_AMULT + 1].view(np.float32)[0] == \
        np.float32(QM[1])
    fused, _ = _flagship_fused(1)
    fw = K.descriptor_words(fused)
    assert fw.size == K.DESC_WORDS * 18 and fw[0] == 17
    cat = fw[17 * K.DESC_WORDS:]
    assert (cat[K.D_KIND], cat[K.D_NIN], cat[K.D_OUTER],
            cat[K.D_INNER_OUT]) == (K.K_CONCAT, 8, 1, 32 * 32 * 16)
    offs, total = K.weight_offsets(fused)
    assert all(o % 16 == 0 for o in offs if o is not None)
    assert total == K.pack_weights(
        fused, [torch.from_numpy(x) for x in _flagship_fused(1)[1]]).numel()


def test_fused_scratch_branches():
    spec, _ = _flagship_fused(1)
    assert K.fused_smem_plan(spec)[:2] == (True, True)
    big = dataclasses.replace(spec, scratch_rows=308_224)
    scr_smem, stage_smem, scr_bytes, smem = K.fused_smem_plan(big)
    assert (scr_smem, stage_smem, scr_bytes) == (False, True, 0)
    assert smem == 32 * 32 * 16


def test_wrappers_refuse_what_the_kernels_do_not_take():
    spec = K.OpSpec(kind="conv2d", in_off=(0,), in_shape=((4, 4, 2),),
                    out_off=0, out_shape=(4, 4, 3), dtype="f32",
                    meta=(1, 1, 1, 1, 1, 1, 0, 0, 1))
    arena = torch.zeros(256, dtype=torch.uint8)
    with pytest.raises(ValueError):          # int8 filter on an f32 op
        K.arena_conv(arena, spec, torch.zeros((1, 1, 2, 3), dtype=torch.int8))
    with pytest.raises(ValueError):          # not a byte arena
        K.arena_conv(arena.view(torch.int8), spec,
                     torch.zeros((1, 1, 2, 3)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.arena_conv(arena, dataclasses.replace(spec, rowlen=16),
                     torch.zeros((1, 1, 2, 3)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.apply_op(arena, dataclasses.replace(spec, kind="pool"))
    wide = dataclasses.replace(spec, in_shape=((1, 128, 2),),
                               out_shape=(1, 128, 65))
    with pytest.raises(ValueError, match="row"):
        K.arena_conv(torch.zeros(40_000, dtype=torch.uint8), wide,
                     torch.zeros((1, 1, 2, 65)))
