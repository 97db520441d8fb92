"""The grid layouts of ``arena_pool`` (arena_conv's row tiles) and of
``arena_fully_connected`` and the staged FC body of ``arena_stream_stage``
(W's column blocks x K slices), through their Python mirrors: every pool
spec of the Table III zoo, flat and row-blocked, through the row-tile
checks; the FC specs of the main paths and hand-built ones through the
brute-force byte check of their order word, tiling and buffers; the FC
grid's fixed summation order against the plain version (int8 bit for bit,
f32 within the ``compare_outputs`` tolerance, 1e-4).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import CS, check_fc_spec, check_tile_spec, fc_items

ROUTES = {"flat": {}, "blocks": {"layout": "blocks"},
          "streaming": {"mode": "streaming"}}


def _specs(graph, route: str, **kw):
    cp = t_compile(graph, backend="numpy", **kw)
    return CudaExecutor(device="cpu", **ROUTES[route]).program(cp)[0]


#: the Table III rows with pools, and how many each lowers (max and
#: average; inception's 3x3/1 SAME averages divide by the valid taps)
POOL_MODELS = {"inception_v4": 18, "inception_resnet_v2": 5,
               "nasnet_mobile": 52, "densenet_121": 4, "resnet_50_v2": 1}


@pytest.mark.parametrize("layout", ["flat", "blocks"])
@pytest.mark.parametrize("model", sorted(POOL_MODELS))
def test_zoo_pool_tiles_keep_the_row_order(model, layout):
    """Every pool spec of a Table III row runs arena_conv's row tiles: a
    tiling whose tiles cover every output once in row order, an order word
    from the byte ranges (no planner spec needs its rows one after
    another), footprints within the shared memory budget
    (``_torch_block_cases.check_tile_spec``)."""
    specs = _specs(tzoo.TABLE3_MODELS[model][0](), layout)
    pools = [s for s in specs if s.kind == "pool"]
    assert len(pools) == POOL_MODELS[model]
    assert all(K.kernel_of(s) == "arena_pool" for s in pools)
    orders = [check_tile_spec(s) for s in pools]
    for s in pools:
        assert K.conv_tiling(s).ch == 0 and K.conv_tiling(s).vo == 1
    if model.startswith("inception"):   # SAME averages: leading pads
        assert any(s.meta[-1] == "avg" and s.meta[4] > 0 for s in pools)
    if model in ("resnet_50_v2", "densenet_121"):
        assert set(orders) == {K.ORDER_STAGED}


#: graphs whose FC specs the byte check covers on each route (the flagship
#: at batch 2 lowers one FC a sample)
FC_GRAPHS = {
    "flagship": (lambda: tzoo.mobilenet_v1(0.25, 128, 1), {}),
    "flagship_f32": (lambda: tzoo.mobilenet_v1(0.25, 128, 4), {}),
    "flagship_batch2": (lambda: tzoo.mobilenet_v1(0.25, 128, 1),
                        {"batch": 2}),
    "resnet50_v2_f32": (lambda: tzoo.resnet50_v2(32, 4), {}),
    "resnet50_v2_int8": (lambda: tzoo.resnet50_v2(32, 1), {}),
    "stream_allops_f32": (lambda: CS.stream_allops_graph(4), {}),
}

#: hand-built flat FC specs (offsets in elements): over its input, rows of
#: x (m = 3), apart from x, and wider than the card's SMs in column blocks
FC_CASES = [
    ("fc_overlap", (32,), (20,), 25, 20),
    ("fc_rows", (3, 16), (3, 10), 0, 100),
    ("fc_disjoint", (2048,), (1000,), 0, 2048),
    ("fc_wide_disjoint", (16,), (20_000,), 0, 64),
]


def _fc_case(case, dtype: str) -> K.OpSpec:
    _, ishp, oshp, ioff, ooff = case
    isz = 1 if dtype == "i8" else 4
    return K.OpSpec(kind="fully_connected", in_off=(ioff * isz,),
                    in_shape=(ishp,), out_off=ooff * isz, out_shape=oshp,
                    dtype=dtype, qmeta=(4, float(np.float32(0.0021)), -1)
                    if dtype == "i8" else ())


@pytest.mark.parametrize("source", [
    f"{g}-{r}" for g in sorted(FC_GRAPHS) for r in ROUTES] + [
    f"{c[0]}-{dt}" for c in FC_CASES for dt in ("i8", "f32")])
def test_fc_order_word_matches_the_byte_ranges(source):
    """Every FC spec of a route (or a hand-built one) through
    ``_torch_block_cases.check_fc_spec``: its order word is overlap exactly
    when a byte of x lies in the output's block; its items read every W
    element once; its descriptor and buffers. The flagship's and
    resnet_50_v2's flat FCs write over their input (order word 2)."""
    name, kind = source.rsplit("-", 1)
    if name in FC_GRAPHS:
        build, kw = FC_GRAPHS[name]
        fcs = [s for s in _specs(build(), kind, **kw)
               if s.kind == "fully_connected"]
        assert len(fcs) == kw.get("batch", 1)
        assert {K.kernel_of(s) for s in fcs} == {
            "arena_stream_stage" if kind == "streaming" else
            "arena_fully_connected"}
    else:
        fcs = [_fc_case(next(c for c in FC_CASES if c[0] == name), kind)]
    orders = [check_fc_spec(s) for s in fcs]
    if kind == "flat" and name in ("flagship", "flagship_f32",
                                   "resnet50_v2_f32", "resnet50_v2_int8"):
        assert orders == [K.EW_OVERLAP]


def test_fc_cases_take_both_order_words():
    """The hand-built FC cases reach both order words in both tiers."""
    for dtype in ("i8", "f32"):
        words = {c[0]: K.fc_order(_fc_case(c, dtype)) for c in FC_CASES}
        assert (words["fc_overlap"], words["fc_disjoint"]) == (
            K.EW_OVERLAP, K.EW_DISJOINT)
        assert set(words.values()) == {K.EW_OVERLAP, K.EW_DISJOINT}


@pytest.mark.parametrize("m,idim,odim", [
    (1, 2048, 1000), (1, 256, 1000), (2, 256, 1000), (1, 1024, 1000),
    (3, 16, 10), (1, 32, 20), (4, 3000, 130), (1, 16, 20_000)])
def test_fc_tiling_covers_every_weight_once(m, idim, odim):
    """Each W element is read by exactly one (column block, K slice) item,
    lanes four columns apart (coalesced along odim), within one CTA an SM
    wherever W has the rows for it; resnet_50_v2's 2048 x 1000 is 8 x 16
    items of 128 columns x 128 rows."""
    spec = K.OpSpec(kind="fully_connected", in_off=(0,),
                    in_shape=((m, idim),), out_off=4 * m * idim,
                    out_shape=(m, odim))
    t = K.fc_tiling(spec)
    count = fc_items(t)
    assert (count[:idim, :odim] == 1).all()
    assert t.bk == K.FC_WARPS * t.rpt and (t.nks - 1) * t.bk < idim
    assert t.ctas <= max(K.FC_GRID, t.ncb)
    if (m, idim, odim) == (1, 2048, 1000):
        assert (t.bo, t.bk, t.ncb, t.nks, t.ctas) == (128, 128, 8, 16, 128)


def test_fc_tiling_depends_on_the_shape_alone():
    """The tiling is a function of (m, idim, odim): the dtype, the offsets
    and the program's layout never enter it, so the flat, blocked and
    streaming programs' FCs of one graph sum in one order (their final
    arenas stay bit-equal)."""
    base = K.OpSpec(kind="fully_connected", in_off=(0,),
                    in_shape=((1, 2048),), out_off=9000, out_shape=(1, 1000))
    variants = [dataclasses.replace(base, dtype="i8", qmeta=(1, 0.5, 0)),
                dataclasses.replace(base, in_off=(4000,), out_off=0),
                dataclasses.replace(base, in_shape=((2048,),),
                                    out_shape=(1000,))]
    assert {K.fc_tiling(s) for s in [base] + variants} == {
        K.fc_tiling(base)}
    for name in ("flagship", "resnet50_v2_f32", "resnet50_v2_int8"):
        build, kw = FC_GRAPHS[name]
        tilings = {K.fc_tiling(s) for r in ROUTES
                   for s in _specs(build(), r, **kw)
                   if s.kind == "fully_connected"}
        assert len(tilings) == 1, name


def _fc_in_grid_order(x: np.ndarray, w: np.ndarray, t, q: bool):
    """y = x . W summed as the grid kernel sums it: per K slice, each warp
    its rows ascending, the warps ascending, then the slices ascending
    (int8: exact int32 of (x - x_zp) * w, the caller requantises)."""
    m, idim = x.shape
    acc_t = np.int32 if q else np.float32
    x, w = x.astype(acc_t), w.astype(acc_t)
    y = None
    for ks in range(t.nks):
        part = None
        for wp in range(K.FC_WARPS):
            k0 = ks * t.bk + wp * t.rpt
            s = np.zeros((m, w.shape[1]), acc_t)
            for k in range(k0, min(k0 + t.rpt, idim)):
                s = s + x[:, k:k + 1] * w[k]
            part = s if part is None else part + s
        y = part if y is None else y + part
    return y


@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("m,idim,odim", [
    (1, 2048, 1000), (1, 256, 1000), (2, 1024, 1000), (3, 16, 10)])
def test_fc_grid_order_matches_the_plain_version(m, idim, odim, dtype):
    """The grid's summation order on seeded x and W (resnet_50_v2's,
    the flagship's and densenet_121's head shapes, a small batched one)
    against ``fully_connected_plain`` on a flat arena: int8 bit for bit
    (exact int32 sums, the shared requantisation), f32 within 1e-4
    (another summation order than torch's matmul)."""
    rng = np.random.default_rng(idim + odim)
    q = dtype == "i8"
    isz = 1 if q else 4
    spec = K.OpSpec(kind="fully_connected", in_off=(0,),
                    in_shape=((m, idim),), out_off=m * idim * isz,
                    out_shape=(m, odim), dtype=dtype,
                    qmeta=(3, float(np.float32(0.0007)), -2) if q else ())
    if q:
        x = rng.integers(-128, 128, (m, idim), dtype=np.int8)
        w = rng.integers(-127, 128, (idim, odim), dtype=np.int8)
        arena = np.concatenate([x.reshape(-1).view(np.uint8),
                                np.zeros(m * odim, np.uint8)])
    else:
        x = rng.standard_normal((m, idim)).astype(np.float32)
        w = (rng.standard_normal((idim, odim)) / np.sqrt(idim)).astype(
            np.float32)
        arena = np.concatenate([x.reshape(-1), np.zeros(m * odim,
                                                        np.float32)]
                               ).view(np.uint8)
    t = torch.from_numpy(arena.copy())
    K.fully_connected_plain(t, spec, torch.from_numpy(w))
    got = t.numpy()[m * idim * isz:]
    if q:
        x_zp, amult, y_zp = spec.qmeta
        acc = _fc_in_grid_order(x.astype(np.int32) - x_zp, w, K.fc_tiling(
            spec), True)
        want = K._requant(torch.from_numpy(acc), amult, y_zp).numpy()
        np.testing.assert_array_equal(got.view(np.int8).reshape(m, odim),
                                      want)
    else:
        want = _fc_in_grid_order(x, w, K.fc_tiling(spec), False)
        np.testing.assert_allclose(got.view(np.float32).reshape(m, odim),
                                   want, rtol=1e-4, atol=1e-4)
