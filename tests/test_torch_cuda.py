"""Card-only tests of the PyTorch/CUDA port (marker ``gpu``): the CUDA
kernels against their plain versions, and the slice end to end on the card.
Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Without a card each test skips with its reason (decided in the fixture).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_serve_cases import alone, band_graph
from repro_torch.core import zoo
from repro_torch.core.exec import compare_outputs, get_backend, random_inputs
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile
from repro_torch.kernels import arena_ops as K
from repro_torch.serve import PlanServer

pytestmark = pytest.mark.gpu

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _hold_against_plain(card, cp, layout=None, mode=None):
    """Every spec's kernel against its plain version, on copies of the
    arena as the program reaches it."""
    specs, ws, descs, state = CudaExecutor(device=card, layout=layout,
                                           mode=mode).program(cp)
    for spec, w, d in zip(specs, ws, descs):
        got, ref = state.clone(), state.clone()
        K.apply_op(got, spec, w, d)
        K.apply_plain(ref, spec, w)
        torch.cuda.synchronize()
        if spec.dtype == "i8":
            err = (got.view(torch.int8).int() - ref.view(torch.int8).int())
            limit = int(spec.kind == "softmax" or (
                spec.kind == "elementwise" and spec.meta[0] == "sigmoid"))
            assert err.abs().max().item() <= limit, spec.kind
        else:
            g, r = got.view(torch.float32), ref.view(torch.float32)
            assert torch.allclose(g, r, rtol=1e-4, atol=1e-4), spec.kind
        state = ref


@pytest.mark.parametrize("bits", [1, 4])
def test_kernels_match_plain_versions_on_the_card(card, bits):
    _hold_against_plain(card, compile(zoo.mobilenet_v1(0.25, 128, bits)))


@pytest.mark.parametrize("bits", [1, 4])
def test_zoo_kernels_match_plain_versions_on_the_card(card, bits):
    """pool, elementwise, standalone concat and wide rows: resnet50_v2 and
    densenet121 at 64x64 (resnet's 16x16x1024 rows are 16,384 outputs)."""
    for graph in (zoo.resnet50_v2(64, bits), zoo.densenet121(64, bits)):
        _hold_against_plain(card, compile(graph))


def test_slice_on_the_card(card):
    cp = compile(zoo.mobilenet_v1(0.25, 128, 1), backend="cuda")
    assert (cp.verified, cp.winner, cp.peak_bytes) == \
        ("numeric+cuda", "fuse", 49_805)
    K.reset_launches()
    got = cp.execute()
    assert sum(K.LAUNCHES.values()) == 29
    assert all(K.LAUNCHES[k] > 0 for k in (
        "arena_conv", "arena_mean", "arena_fully_connected", "arena_softmax",
        "arena_fused_chain"))
    compare_outputs(get_backend("numpy").execute(cp), got, exact=False,
                    label="cuda vs numpy")
    assert np.isfinite(got["prob_out"].astype(np.float64)).all()


def test_global_scratch_branch_on_the_card(card):
    """mobilenet_v1_1.0_224_8bit's chain (1,053,696 B of regions, its
    stages' outputs, in the global workspace) on a grid of every SM."""
    g = zoo.TABLE3_MODELS["mobilenet_v1_1.0_224_8bit"][0]()
    cp = compile(g, backend="cuda")
    assert cp.peak_bytes == 517_052
    fused = [s for s in CudaExecutor(device=card).program(cp)[0]
             if s.kind == "fused"]
    assert fused and K.buffer_plan(fused[0]).on_global("regions")
    assert K.chain_schedule(fused[0]).region_bytes == 1_053_696
    assert K.chain_grid(fused[0])[0] > 132
    compare_outputs(get_backend("numpy").execute(cp), cp.execute(),
                    exact=False, label="1.0_224_8bit")


@pytest.mark.parametrize("bits", [1, 4])
def test_blocked_kernels_match_plain_versions_on_the_card(card, bits):
    """The row-blocked program: packed, spanning and plain operands."""
    _hold_against_plain(card, compile(zoo.mobilenet_v1(0.25, 128, bits)),
                        "blocks")
    _hold_against_plain(card, compile(zoo.resnet50_v2(64, bits)), "blocks")


@pytest.mark.parametrize("bits", [1, 4])
def test_blocked_outputs_bit_equal_flat_on_the_card(card, bits):
    cp = compile(zoo.mobilenet_v1(0.25, 128, bits))
    be = CudaExecutor(device=card, layout="blocks")
    arena = be.program(cp)[3]
    assert arena.is_cuda and arena.numel() * arena.element_size() == \
        (73_728 if bits == 1 else 327_680)
    got = be.execute(cp)
    want = CudaExecutor(device=card).execute(cp)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("ih,iw,c,k,stride,pad", [
    (16, 16, 8, 3, 1, 1), (17, 13, 4, 3, 2, 0), (15, 15, 1, 3, 3, 1),
    (64, 64, 8, 3, 1, 1)])
def test_dmo_dwconv_on_the_card(card, ih, iw, c, k, stride, pad):
    from repro_torch.kernels import ops as TO
    g = torch.Generator().manual_seed(ih * 100 + iw)
    x, w = torch.randn(ih, iw, c, generator=g), torch.randn(k, k, c,
                                                             generator=g)
    K.reset_launches()
    got = TO.dmo_dwconv2d(x, w, stride, pad)
    assert got.is_cuda and K.LAUNCHES["arena_conv"] == 1
    want = TO.dmo_dwconv2d(x, w, stride, pad, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _race_picks(specs, bits):
    """Spec indices of resnet50_v2(224)'s stem (7x7/2 over its input), its
    1x1 conv whose output starts closest below its input (252 B in f32)
    and a 3x3 conv whose operands are disjoint."""
    convs = [(i, s) for i, s in enumerate(specs)
             if K.kernel_of(s) == "arena_conv"]
    stem = next(i for i, s in convs if s.meta[0] == 7)
    below = [(s.in_off[0] - s.out_off, i) for i, s in convs
             if s.meta[0] == 1 and K.conv_order(s) == K.ORDER_STAGED
             and 0 < s.in_off[0] - s.out_off]
    gap, one = min(below)
    assert bits == 1 or gap == 252
    three = next(i for i, s in convs if s.meta[0] == 3
                 and K.conv_order(s) == K.ORDER_DISJOINT)
    assert K.conv_order(specs[stem]) == K.ORDER_STAGED
    return {"stem": stem, "1x1 overlap": one, "3x3 disjoint": three}


@pytest.mark.parametrize("bits", [4, 1])
def test_conv_tiles_do_not_race_on_the_card(card, bits):
    """Three convs of resnet50_v2(224) (``_race_picks``), 50 launches each
    on copies of the arena the program reaches: every launch bit-equal to
    the first, and the first equal to conv_plain (int8 bit for bit, f32
    within 1e-4: the plain version's torch matmul sums in another
    order)."""
    cp = compile(zoo.resnet50_v2(224, bits), backend="numpy")
    specs, ws, descs, state = CudaExecutor(device=card).program(cp)
    picks = _race_picks(specs, bits)
    checked = 0
    for i, (spec, w, d) in enumerate(zip(specs, ws, descs)):
        if i in picks.values():
            ref = state.clone()
            K.conv_plain(ref, spec, w)
            first = None
            for _ in range(50):
                got = state.clone()
                K.apply_op(got, spec, w, d)
                torch.cuda.synchronize()
                if first is None:
                    first = got
                    if bits == 1:
                        assert torch.equal(got, ref), spec
                    else:
                        assert torch.allclose(got.view(torch.float32),
                                              ref.view(torch.float32),
                                              rtol=1e-4, atol=1e-4), spec
                assert torch.equal(got, first), spec
            checked += 1
        K.apply_op(state, spec, w, d)
    assert checked == 3


def _hold_50(spec, w, d, state):
    """50 launches of a spec's kernel on copies of ``state``: each bit-equal
    to the first, the first equal to the plain version (int8 bit for bit,
    f32 within 1e-4: the plain conv's torch matmul sums in another
    order)."""
    ref = state.clone()
    K.apply_plain(ref, spec, w)
    first = None
    for _ in range(50):
        got = state.clone()
        K.apply_op(got, spec, w, d)
        torch.cuda.synchronize()
        if first is None:
            first = got
            if spec.dtype == "i8":
                assert torch.equal(got, ref), spec
            else:
                assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4), spec
        assert torch.equal(got, first), spec


#: hand-built rolling specs (tests/test_torch_stream.py builds the same):
#: the clamped-stray case (a start table leaving valid taps outside the
#: 24-row window) and an in-place depthwise conv whose streaming tiles run
#: one after another (order word 2)
_STRAY = K.OpSpec(
    kind="conv2d", in_off=(0,), in_shape=((40, 6, 3),), out_off=40,
    out_shape=(40, 6, 5), dtype="f32", meta=(3, 3, 1, 1, 1, 1, 1, 1, 1),
    rowlen=32, in_rows=((40, 18),), out_rows=(40, 30), win_rows=32,
    win_starts=(0,) * 5, in_addr=((1, 1, 18),), out_addr=(1, 1, 30),
    out_tile=8)
_IN_PLACE = {
    "f32": K.OpSpec(
        kind="depthwise_conv2d", in_off=(0,), in_shape=((20, 6, 4),),
        out_off=0, out_shape=(20, 6, 4), dtype="f32",
        meta=(3, 3, 1, 1, 1, 1, 1, 1, 1), rowlen=32, in_rows=((20, 24),),
        out_rows=(20, 24), win_rows=32, win_starts=(0, 0, 0),
        in_addr=((1, 1, 24),), out_addr=(1, 1, 24), out_tile=8),
    "i8": K.OpSpec(
        kind="depthwise_conv2d", in_off=(0,), in_shape=((20, 6, 4),),
        out_off=0, out_shape=(20, 6, 4), dtype="i8",
        meta=(3, 3, 1, 1, 1, 1, 1, 1, 1), qmeta=(-3, 0.0123, 5), rowlen=32,
        in_rows=((20, 24),), out_rows=(20, 24), win_rows=64,
        win_starts=(0,), in_addr=((1, 1, 24),), out_addr=(1, 1, 24),
        out_tile=32),
}


def _hand_built(card, spec, rows, seed):
    rng = np.random.default_rng(seed)
    kh, kw = spec.meta[:2]
    ic, oc = spec.in_shape[0][-1], spec.out_shape[-1]
    wshape = (kh, kw, ic, spec.meta[8] if spec.kind == "depthwise_conv2d"
              else oc)
    if spec.dtype == "i8":
        arena = rng.integers(-128, 128, (rows, spec.rowlen), dtype=np.int8)
        w = rng.integers(-127, 128, wshape, dtype=np.int8)
    else:
        arena = rng.standard_normal((rows, spec.rowlen), dtype=np.float32)
        w = rng.standard_normal(wshape, dtype=np.float32) * np.float32(0.3)
    return torch.from_numpy(arena).to(card), torch.from_numpy(w).to(card)


@pytest.mark.parametrize("bits", [4, 1])
def test_roll_tiles_do_not_race_on_the_card(card, bits):
    """Rolling specs of resnet50_v2(224)'s streaming route (the stem, the
    max pool and a 1x1 conv whose output overlaps its input, all with
    staged waits), the clamped-stray case and the in-place depthwise of
    order word 2: 50 launches each on copies of the arena, each bit-equal
    to the first, the first equal to stream_roll_plain."""
    cp = compile(zoo.resnet50_v2(224, bits), backend="numpy")
    specs, ws, descs, state = CudaExecutor(device=card,
                                           mode="streaming").program(cp)
    rolls = [i for i, s in enumerate(specs) if K.stream_form(s) == "roll"]
    stem = next(i for i in rolls if specs[i].meta[0] == 7)
    pool = next(i for i in rolls if specs[i].kind == "pool")
    one = next(i for i in rolls if specs[i].kind == "conv2d"
               and specs[i].meta[0] == 1
               and K.conv_order(specs[i]) == K.ORDER_STAGED)
    assert all(K.conv_order(specs[i]) == K.ORDER_STAGED
               for i in (stem, pool, one))
    checked = 0
    for i, (spec, w, d) in enumerate(zip(specs, ws, descs)):
        if i in (stem, pool, one):
            _hold_50(spec, w, d, state)
            checked += 1
        K.apply_op(state, spec, w, d)
    assert checked == 3
    stray = _hand_built(card, _STRAY, 80, 3)
    place = _hand_built(card, _IN_PLACE["i8" if bits == 1 else "f32"],
                        32 if bits == 1 else 24, 4)
    assert K.conv_order(_STRAY) == K.ORDER_DISJOINT
    assert K.conv_order(_IN_PLACE["f32"]) == K.ORDER_ROWS
    for spec, (arena, w) in ((_STRAY, stray),
                             (_IN_PLACE["i8" if bits == 1 else "f32"],
                              place)):
        _hold_50(spec, w, None, arena)


def _hold_ew_50(spec, d, state):
    """50 launches of an elementwise spec's grid kernel on copies of
    ``state``: each bit-equal to the first, the first bit-equal to the
    plain version (int8 sigmoid within 1 LSB: expf and torch.exp differ by
    an ulp)."""
    ref = state.clone()
    K.apply_plain(ref, spec)
    first = None
    for _ in range(50):
        got = state.clone()
        K.apply_op(got, spec, None, d)
        torch.cuda.synchronize()
        if first is None:
            first = got
            if spec.dtype == "i8" and spec.meta[0] == "sigmoid":
                err = got.view(torch.int8).int() - ref.view(torch.int8).int()
                assert err.abs().max().item() <= 1, spec
            else:
                assert torch.equal(got, ref), spec
        assert torch.equal(got, first), spec


def _ew_spec(bits, fn, shapes, in_off, out_off):
    """A hand-built flat elementwise spec (offsets in elements)."""
    isz = 1 if bits == 1 else 4
    q = ()
    if bits == 1:
        q = (((0.05, 3), (0.07, -2))[:len(shapes)], (0.09, 1))
    return K.OpSpec(kind="elementwise", in_off=tuple(o * isz for o in in_off),
                    in_shape=shapes, out_off=out_off * isz,
                    out_shape=shapes[0], dtype="i8" if bits == 1 else "f32",
                    meta=(fn,), qmeta=q)


@pytest.mark.parametrize("bits", [4, 1])
def test_elementwise_tiles_do_not_race_on_the_card(card, bits):
    """The elementwise grid body, 50 launches each (``_hold_ew_50``): every
    diagonal add of the flat resnet50_v2(224) (order word 2), an aligned
    in-place relu and a disjoint relu of it; a hand-built relu of 3.2 MB
    whose output starts above its input (order 2, every SM's chunk staged
    before the barrier); a broadcast add over its first input; and every
    staged elementwise spec of the streaming resnet50_v2(224), in place on
    the arena."""
    cp = compile(zoo.resnet50_v2(224, bits), backend="numpy")
    specs, ws, descs, state = CudaExecutor(device=card).program(cp)
    ew = [i for i, s in enumerate(specs)
          if K.kernel_of(s) == "arena_elementwise"]
    diag = [i for i in ew if K.ew_order(specs[i]) == K.EW_OVERLAP]
    relu = {K.ew_order(specs[i]): i for i in ew
            if specs[i].meta[0] == "relu"}
    picks = set(diag) | {relu[K.EW_ALIGNED], relu[K.EW_DISJOINT]}
    assert diag and all(specs[i].meta[0] == "add"
                        and specs[i].out_off < specs[i].in_off[0]
                        for i in diag)
    checked = 0
    for i, (spec, w, d) in enumerate(zip(specs, ws, descs)):
        if i in picks:
            _hold_ew_50(spec, d, state)
            checked += 1
        K.apply_op(state, spec, w, d)
    assert checked == len(picks)
    n = 56 * 56 * 256
    above = _ew_spec(bits, "relu", ((56, 56, 256),), (0,), 1000)
    bcast = _ew_spec(bits, "add", ((56, 56, 256), (256,)), (0, n + 64), 0)
    assert K.ew_order(above) == K.EW_OVERLAP
    assert K.ew_tiling(above).chunks == K.EW_RESIDENT
    assert K.ew_order(bcast) == K.EW_ALIGNED
    g = torch.Generator().manual_seed(bits)
    for spec in (above, bcast):
        nbytes = (n + 1024) * (1 if bits == 1 else 4)
        arena = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                              generator=g) if bits == 1 else \
            torch.randn(nbytes // 4, generator=g).view(torch.uint8)
        _hold_ew_50(spec, None, arena.to(card))
    specs, ws, descs, state = CudaExecutor(
        device=card, mode="streaming").program(cp)
    staged = 0
    for spec, w, d in zip(specs, ws, descs):
        if K.stream_form(spec) == "stage" and spec.kind == "elementwise":
            _hold_ew_50(spec, d, state)
            staged += 1
        K.apply_op(state, spec, w, d)
    assert staged == 33


def test_elementwise_refuses_a_grid_the_card_cannot_hold(card):
    """An order-2 launch whose chunks the card cannot hold at once is
    refused by the entry point (the wrapper's check raises) and runs
    nothing, on no smaller grid."""
    from repro_torch.kernels import build
    spec = _ew_spec(4, "relu", ((56, 56, 256),), (0,), 1000)
    _, _, ctr = K.chunk_grid(spec)
    arena = torch.randn(56 * 56 * 256 + 1024, device=card).view(torch.uint8)
    before = arena.clone()
    too_many = 1 << 20
    err = build.entry("arena_elementwise")(
        arena.data_ptr(), K.descriptor(spec, card).data_ptr(), None,
        K.workspace(spec, card).data_ptr(), K.buffer_plan(spec).smem,
        too_many, too_many, ctr, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="arena_elementwise"):
        build.check(err, "arena_elementwise")
    torch.cuda.synchronize()
    assert torch.equal(arena, before)


def _hold_exact_50(spec, w, d, state, exact: bool):
    """50 launches of a spec's grid kernel on copies of ``state``: each
    bit-equal to the first, the first bit-equal to the plain version
    (``exact``) or within 1e-4 of it (f32 FC: another summation order than
    the plain version's torch matmul)."""
    ref = state.clone()
    K.apply_plain(ref, spec, w)
    first = None
    for _ in range(50):
        got = state.clone()
        K.apply_op(got, spec, w, d)
        torch.cuda.synchronize()
        if first is None:
            first = got
            if exact:
                assert torch.equal(got, ref), spec
            else:
                g = got.view(torch.float32)
                r = ref.view(torch.float32)
                assert torch.allclose(g, r, rtol=1e-4, atol=1e-4), spec
        assert torch.equal(got, first), spec


def _walk_holding(card, cp, pick, exact, **kw):
    """Walk ``cp``'s program on the card; hold every spec ``pick`` selects
    (``_hold_exact_50``) on the arena as the program reaches it. Returns
    how many were held."""
    specs, ws, descs, state = CudaExecutor(device=card, **kw).program(cp)
    held = 0
    for spec, w, d in zip(specs, ws, descs):
        if pick(spec):
            _hold_exact_50(spec, w, d, state, exact(spec))
            held += 1
        K.apply_op(state, spec, w, d)
    return held


def _seeded_arena(card, nbytes: int, bits: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    if bits == 1:
        arena = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                              generator=g)
    else:
        arena = torch.randn(nbytes // 4, generator=g).view(torch.uint8)
    return arena.to(card)


@pytest.mark.parametrize("bits", [4, 1])
def test_pool_tiles_do_not_race_on_the_card(card, bits):
    """arena_pool's row tiles, 50 launches each, every launch bit-equal to
    the first and the first bit-equal to pool_plain: resnet50_v2(224)'s
    3x3/2 max pool (written below its input: staged waits) on the flat and
    the row-blocked program, densenet121(224)'s first 2x2/2 average
    transition, and a hand-built 3x3/1 SAME average pool written in place
    over its input (row 1 reads row 0's store: rows one after another)."""
    is_pool = lambda s: s.kind == "pool"  # noqa: E731
    exact = lambda s: True  # noqa: E731
    cp = compile(zoo.resnet50_v2(224, bits), backend="numpy")
    for layout in ("flat", "blocks"):
        assert _walk_holding(card, cp, is_pool, exact, layout=layout) == 1
    dn = compile(zoo.densenet121(224, bits), backend="numpy")
    first_avg = []

    def avg(spec):
        if spec.kind == "pool" and spec.meta[-1] == "avg" and not first_avg:
            first_avg.append(spec)
            return True
        return False
    assert _walk_holding(card, dn, avg, exact) == 1
    assert K.conv_order(first_avg[0]) == K.ORDER_STAGED
    isz = 1 if bits == 1 else 4
    in_place = K.OpSpec(
        kind="pool", in_off=(256 * isz,), in_shape=((56, 56, 64),),
        out_off=256 * isz, out_shape=(56, 56, 64),
        dtype="i8" if bits == 1 else "f32", meta=(3, 3, 1, 1, 1, 1, "avg"),
        qmeta=(-3, 0.87, 5) if bits == 1 else ())
    assert K.conv_order(in_place) == K.ORDER_ROWS
    arena = _seeded_arena(card, (56 * 56 * 64 + 512) * isz, bits, 7)
    _hold_exact_50(in_place, None, None, arena, True)


@pytest.mark.parametrize("bits", [4, 1])
def test_fc_grid_does_not_race_on_the_card(card, bits):
    """The FC grid body, 50 launches each, every launch bit-equal to the
    first, the first bit-equal to the plain version in int8 and within
    1e-4 in f32: the flagship's and resnet50_v2(224)'s FCs on the flat
    program (written over their input: order word 2, partials before one
    grid-wide barrier), the row-blocked program and, staged, the streaming
    one (in place on the arena); and a hand-built 2048 x 1000 FC apart from
    its input (order word 0: the last slice of each column block stores)."""
    is_fc = lambda s: s.kind == "fully_connected"  # noqa: E731
    exact = lambda s: s.dtype == "i8"  # noqa: E731
    for graph in (zoo.mobilenet_v1(0.25, 128, bits),
                  zoo.resnet50_v2(224, bits)):
        cp = compile(graph, backend="numpy")
        specs = CudaExecutor(device=card).program(cp)[0]
        assert [K.fc_order(s) for s in specs if is_fc(s)] == [K.EW_OVERLAP]
        for kw in ({}, {"layout": "blocks"}, {"mode": "streaming"}):
            assert _walk_holding(card, cp, is_fc, exact, **kw) == 1
    isz = 1 if bits == 1 else 4
    apart = K.OpSpec(kind="fully_connected", in_off=(0,),
                     in_shape=((2048,),), out_off=2048 * isz,
                     out_shape=(1000,), dtype="i8" if bits == 1 else "f32",
                     qmeta=(4, 0.0021, -1) if bits == 1 else ())
    assert K.fc_order(apart) == K.EW_DISJOINT
    g = torch.Generator().manual_seed(bits)
    w = (torch.randint(-127, 128, (2048, 1000), dtype=torch.int8, generator=g)
         if bits == 1 else torch.randn(2048, 1000, generator=g) * 0.02)
    arena = _seeded_arena(card, 3048 * isz, bits, 8)
    _hold_exact_50(apart, w.to(card), None, arena, bits == 1)


def test_fc_refuses_a_grid_the_card_cannot_hold(card):
    """An order-2 FC launch whose CTAs the card cannot hold at once is
    refused by the entry point (the wrapper's check raises) and runs
    nothing, on no smaller grid."""
    from repro_torch.kernels import build
    spec = K.OpSpec(kind="fully_connected", in_off=(3996,),
                    in_shape=((2048,),), out_off=0, out_shape=(1000,))
    assert K.fc_order(spec) == K.EW_OVERLAP
    _, _, ctr = K.fc_grid(spec)
    arena = torch.randn(4096, device=card).view(torch.uint8)
    w = torch.randn(2048, 1000, device=card)
    before = arena.clone()
    too_many = 1 << 20
    err = build.entry("arena_fully_connected")(
        arena.data_ptr(), K.descriptor(spec, card).data_ptr(), w.data_ptr(),
        K.workspace(spec, card).data_ptr(), K.buffer_plan(spec).smem,
        too_many, too_many, ctr, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="arena_fully_connected"):
        build.check(err, "arena_fully_connected")
    torch.cuda.synchronize()
    assert torch.equal(arena, before)


def _chunk_exact(spec) -> bool:
    """Is the chunk walk bit-equal to the plain version: a concat copies
    (int8: the shared rescale) and an int8 mean sums exact int32s; an f32
    mean sums in one fixed order, the plain version in torch's (within
    1e-4)."""
    return spec.kind == "concat" or spec.dtype == "i8"


def _concat_overlap(bits):
    """A hand-built flat concat of four inputs whose output starts inside
    the first (order word 2), wide enough for many chunks; offsets in
    elements."""
    isz = 1 if bits == 1 else 4
    shapes = ((56, 56, 64), (56, 56, 32), (56, 56, 32), (56, 56, 16))
    offs, cur = [], 0
    for sh in shapes:
        offs.append(cur)
        cur += 56 * 56 * sh[-1]
    q = (tuple((zp, m) for zp, m in ((1, 0.5), (-2, 1.0), (0, 1.7),
                                     (5, 0.9))), (-1,))
    spec = K.OpSpec(kind="concat", in_off=tuple(o * isz for o in offs),
                    in_shape=shapes, out_off=1000 * isz,
                    out_shape=(56, 56, 144), dtype="i8" if bits == 1
                    else "f32", meta=(-1,), qmeta=q if bits == 1 else ())
    return spec, (cur + 56 * 56 * 144 + 1000) * isz


def _mean_over_others(bits):
    """A hand-built flat mean of a (7, 7, 2048) head whose output starts
    five elements into its input (output o over input element 5 + o, of
    another channel's reduction: order word 2)."""
    isz = 1 if bits == 1 else 4
    spec = K.OpSpec(kind="mean", in_off=(0,), in_shape=((7, 7, 2048),),
                    out_off=5 * isz, out_shape=(2048,),
                    dtype="i8" if bits == 1 else "f32", meta=((0, 1),),
                    qmeta=(-3, 1.7, 2) if bits == 1 else ())
    return spec, (7 * 7 * 2048 + 64) * isz


def _mean_axes_apart(bits):
    """A hand-built flat mean over two axes that are not adjacent (0 and
    2 of (8, 7, 64)): its reduction steps the odometer, not a constant
    stride; the output apart from the input (order word 0)."""
    isz = 1 if bits == 1 else 4
    spec = K.OpSpec(kind="mean", in_off=(0,), in_shape=((8, 7, 64),),
                    out_off=8 * 7 * 64 * isz, out_shape=(7,),
                    dtype="i8" if bits == 1 else "f32", meta=((0, 2),),
                    qmeta=(-3, 1.7, 2) if bits == 1 else ())
    return spec, (8 * 7 * 64 + 64) * isz


@pytest.mark.parametrize("bits", [4, 1])
def test_concat_and_mean_grids_do_not_race_on_the_card(card, bits):
    """The concat and mean chunk walks, 50 launches each, every launch
    bit-equal to the first and the first bit-equal to the plain version
    (f32 mean: within 1e-4, another summation order): every concat of the
    flat and the blocked densenet121(224) (order word 0) and its flat mean;
    resnet50_v2(224)'s and the flagship's flat means, written over their
    own inputs (order word 1), and their blocked ones (order word 0); a
    hand-built concat and a hand-built mean whose outputs lie over other
    elements' inputs (order word 2, every chunk staged before one
    grid-wide barrier); a hand-built mean over two axes that are not
    adjacent (the odometer's path)."""
    walk = lambda s: s.kind in ("concat", "mean")  # noqa: E731
    dn = compile(zoo.densenet121(224, bits), backend="numpy")
    for kw in ({}, {"layout": "blocks"}):
        specs = CudaExecutor(device=card, **kw).program(dn)[0]
        assert {K.chunk_of(s)[1] for s in specs if s.kind == "concat"} == {
            K.EW_DISJOINT}
        assert _walk_holding(card, dn, walk, _chunk_exact, **kw) == 59
    is_mean = lambda s: s.kind == "mean"  # noqa: E731
    for graph in (zoo.resnet50_v2(224, bits),
                  zoo.mobilenet_v1(0.25, 128, bits)):
        cp = compile(graph, backend="numpy")
        for kw, order in (({}, K.EW_ALIGNED),
                          ({"layout": "blocks"}, K.EW_DISJOINT)):
            specs = CudaExecutor(device=card, **kw).program(cp)[0]
            assert [K.mean_order(s) for s in specs if is_mean(s)] == [order]
            assert _walk_holding(card, cp, is_mean, _chunk_exact, **kw) == 1
    for make in (_concat_overlap, _mean_over_others, _mean_axes_apart):
        spec, nbytes = make(bits)
        t, order = K.chunk_of(spec)
        assert (order, t.chunks > 1) == ((K.EW_DISJOINT, False)
                                         if make is _mean_axes_apart
                                         else (K.EW_OVERLAP, True))
        arena = _seeded_arena(card, _round_up(nbytes, 16), bits, 9)
        _hold_exact_50(spec, None, None, arena, _chunk_exact(spec))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@pytest.mark.parametrize("kernel", ["arena_concat", "arena_mean"])
def test_concat_and_mean_refuse_a_grid_the_card_cannot_hold(card, kernel):
    """An order-2 concat or mean launch whose chunks the card cannot hold
    at once is refused by the entry point (the wrapper's check raises) and
    runs nothing, on no smaller grid."""
    from repro_torch.kernels import build
    spec, nbytes = (_concat_overlap if kernel == "arena_concat"
                    else _mean_over_others)(4)
    assert K.chunk_of(spec)[1] == K.EW_OVERLAP
    _, _, ctr = K.chunk_grid(spec)
    arena = _seeded_arena(card, _round_up(nbytes, 16), 4, 10)
    before = arena.clone()
    too_many = 1 << 20
    err = build.entry(kernel)(
        arena.data_ptr(), K.descriptor(spec, card).data_ptr(), None,
        K.workspace(spec, card).data_ptr(), K.buffer_plan(spec).smem,
        too_many, too_many, ctr, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match=kernel):
        build.check(err, kernel)
    torch.cuda.synchronize()
    assert torch.equal(arena, before)


@pytest.mark.parametrize("bits", [4, 1])
def test_staged_concat_and_mean_run_in_place_on_the_card(card, bits):
    """densenet121(224)'s streaming program: its 58 staged concats and its
    staged mean run in place on the arena (no window, no copy), each held
    50 times against the plain streaming version; the final streaming
    arena equals the blocked one, element for element."""
    cp = compile(zoo.densenet121(224, bits), backend="numpy")

    def staged(spec):
        if K.stream_form(spec) != "stage" or spec.kind not in ("concat",
                                                               "mean"):
            return False
        assert K.runs_in_place(spec)
        assert "win" not in {n for n, _, _ in K.buffer_plan(spec).parts}
        return True
    assert _walk_holding(card, cp, staged, _chunk_exact,
                         mode="streaming") == 59
    st = CudaExecutor(device=card, mode="streaming")
    blk = CudaExecutor(device=card, layout="blocks")
    assert torch.equal(_final_arena(st, cp), _final_arena(blk, cp))


def _final_arena(ex, cp):
    specs, ws, descs, arena = ex.program(cp)
    for spec, w, d in zip(specs, ws, descs):
        K.apply_op(arena, spec, w, d)
    torch.cuda.synchronize()
    return arena


# ---------------------------------------------------------------------------
# the softmax grid, and the matmul on the product grid
# ---------------------------------------------------------------------------

def _hold_50_within(spec, state):
    """50 launches of a softmax or matmul grid on copies of ``state``: each
    bit-equal to the first, the first within the plain version's limit
    (softmax int8 1 LSB, matmul int8 bit for bit, f32 1e-4)."""
    ref = state.clone()
    K.apply_plain(ref, spec)
    first = None
    for _ in range(50):
        got = state.clone()
        K.apply_op(got, spec)
        torch.cuda.synchronize()
        if first is None:
            first = got
            if spec.dtype == "i8":
                d = (got.view(torch.int8).int() - ref.view(torch.int8).int())
                assert d.abs().max().item() <= int(spec.kind == "softmax"), \
                    spec
            else:
                assert torch.allclose(got.view(torch.float32),
                                      ref.view(torch.float32), rtol=1e-4,
                                      atol=1e-4), spec
        assert torch.equal(got, first), spec


def _hand_softmax_and_matmul(bits):
    """The chip script's hand-built softmaxes (1,024 rows x 1,000 on every
    placement; one row of 65,536) and matmuls (1024^3 apart from and over
    a; (40, 70) x (70, 130) over b; a few rows, (3, 16) x (16, 5))."""
    cs = _chip_smoke()
    dt = "i8" if bits == 1 else "f32"
    out = [cs.softmax_spec(dt, 1024, 1000, pl) for pl in cs.SOFTMAX_PLACES]
    out.append(cs.softmax_spec(dt, 1, 65_536, "disjoint"))
    out += [cs.matmul_spec(dt, 1024, 1024, 1024, pl)
            for pl in ("disjoint", "over_a")]
    spec, nbytes = cs.matmul_spec(dt, 40, 70, 130, "disjoint")
    out.append((dataclasses.replace(spec, out_off=spec.in_off[1]), nbytes))
    out.append(cs.matmul_spec(dt, 3, 16, 5, "over_a"))
    return cs, out


@pytest.mark.parametrize("bits", [4, 1])
def test_softmax_and_matmul_grids_do_not_race_on_the_card(card, bits):
    """The softmax and product grids, 50 launches each, every launch
    bit-equal to the first and the first within the plain version's limit:
    the flagship's softmax (in place, order word 1) and resnet50_v2(224)'s
    on the flat and blocked programs, allops' softmax and matmul, and the
    hand-built specs on every placement (order words 0, 1 and 2; a CTA row
    staged in the workspace; row blocks, a few rows)."""
    pick = lambda s: s.kind in ("softmax", "matmul")  # noqa: E731
    for graph, n in ((zoo.mobilenet_v1(0.25, 128, bits), 1),
                     (zoo.resnet50_v2(224, bits), 1)):
        cp = compile(graph, backend="numpy")
        for kw in ({}, {"layout": "blocks"}):
            specs, ws, descs, state = CudaExecutor(device=card,
                                                   **kw).program(cp)
            held = 0
            for spec, w, d in zip(specs, ws, descs):
                if pick(spec):
                    _hold_50_within(spec, state)
                    held += 1
                K.apply_op(state, spec, w, d)
            assert held == n
    cs, hand = _hand_softmax_and_matmul(bits)
    allops = compile(cs.allops_graph(bits), backend="numpy")
    specs, ws, descs, state = CudaExecutor(device=card).program(allops)
    for spec, w, d in zip(specs, ws, descs):
        if pick(spec):
            _hold_50_within(spec, state)
        K.apply_op(state, spec, w, d)
    orders = set()
    for spec, nbytes in hand:
        orders.add((spec.kind, K.softmax_order(spec) if spec.kind ==
                    "softmax" else K.matmul_order(spec)))
        _hold_50_within(spec, cs.seeded_state(torch, spec, nbytes, 5))
    assert orders == {("softmax", K.EW_DISJOINT), ("softmax", K.EW_ALIGNED),
                      ("softmax", K.EW_OVERLAP), ("matmul", K.EW_DISJOINT),
                      ("matmul", K.EW_OVERLAP)}


@pytest.mark.parametrize("kernel", ["arena_softmax", "arena_matmul"])
def test_softmax_and_matmul_refuse_a_grid_the_card_cannot_hold(card,
                                                               kernel):
    """An order-2 softmax or matmul launch whose CTAs the card cannot hold
    at once is refused by the entry point (the wrapper's check raises) and
    runs nothing, on no smaller grid."""
    from repro_torch.kernels import build
    cs = _chip_smoke()
    spec, nbytes = (cs.softmax_spec("f32", 1024, 1000, "shifted")
                    if kernel == "arena_softmax" else
                    cs.matmul_spec("f32", 1024, 1024, 1024, "over_a"))
    _, group, ctr = (K.softmax_grid if kernel == "arena_softmax"
                     else K.fc_grid)(spec)
    assert group > 0
    arena = cs.seeded_state(torch, spec, nbytes, 6)
    before = arena.clone()
    too_many = 1 << 20
    err = build.entry(kernel)(
        arena.data_ptr(), K.descriptor(spec, card).data_ptr(), None,
        K.workspace(spec, card).data_ptr(), K.buffer_plan(spec).smem,
        too_many, too_many, ctr, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match=kernel):
        build.check(err, kernel)
    torch.cuda.synchronize()
    assert torch.equal(arena, before)


@pytest.mark.parametrize("bits", [4, 1])
def test_staged_softmax_and_matmul_run_in_place_on_the_card(card, bits):
    """The streaming program of allops (a staged matmul and softmax), the
    reference's stream_allops and the flagship: every staged softmax and
    matmul runs in place on the arena (no window, no copy), held 50 times
    against the plain streaming version; five forwards give identical
    final arenas, each equal to the blocked program's."""
    cs = _chip_smoke()

    def staged(spec):
        if K.stream_form(spec) != "stage" or spec.kind not in ("softmax",
                                                               "matmul"):
            return False
        assert K.runs_in_place(spec)
        assert "win" not in {n for n, _, _ in K.buffer_plan(spec).parts}
        return True
    for graph in (cs.allops_graph(bits), cs.stream_allops_graph(bits),
                  zoo.mobilenet_v1(0.25, 128, bits)):
        cp = compile(graph, backend="numpy")
        specs, ws, descs, state = CudaExecutor(
            device=card, mode="streaming").program(cp)
        held = 0
        for spec, w, d in zip(specs, ws, descs):
            if staged(spec):
                _hold_50_within(spec, state)
                held += 1
            K.apply_op(state, spec, w, d)
        assert held >= 1
        st = CudaExecutor(device=card, mode="streaming")
        blk = CudaExecutor(device=card, layout="blocks")
        first = _final_arena(st, cp)
        for _ in range(4):
            assert torch.equal(_final_arena(st, cp), first)
        assert torch.equal(first, _final_arena(blk, cp))


@pytest.mark.parametrize("bits", [1, 4])
def test_streaming_route_on_the_card(card, bits):
    """The flagship's streaming route: every streaming kernel against its
    plain version, one request of 29 launches (25 rolling, 3 staged, one
    fused chain), outputs and the final arena bit-equal to the blocked
    route's."""
    cp = compile(zoo.mobilenet_v1(0.25, 128, bits))
    _hold_against_plain(card, cp, mode="streaming")
    st = CudaExecutor(device=card, mode="streaming")
    blk = CudaExecutor(device=card, layout="blocks")
    K.reset_launches()
    got = st.execute(cp)
    assert (K.LAUNCHES["arena_stream_roll"], K.LAUNCHES["arena_stream_stage"],
            K.LAUNCHES["arena_stream_fused"]) == (25, 3, 1)
    assert sum(K.LAUNCHES.values()) == 29
    want = blk.execute(cp)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    a, b = _final_arena(st, cp), _final_arena(blk, cp)
    assert a.is_cuda and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the pad's chunk walk (arena_pad, and the staged pad of arena_stream_stage)
# ---------------------------------------------------------------------------

def _blocked_pad(bits, streaming):
    """A hand-built row-blocked pad (4, 4, 4) -> (6, 6, 4) on rows of 32,
    its input packed two image rows an arena row at row 0, its output one
    image row an arena row from row 1, over the input (order word 2); in
    the streaming program (``streaming``) it is staged. Returns (spec,
    arena rows)."""
    from repro_torch.core.planner import staged_slots
    dt = "i8" if bits == 1 else "f32"
    spec = K.OpSpec(kind="pad", in_off=(0,), in_shape=((4, 4, 4),),
                    out_off=1, out_shape=(6, 6, 4), dtype=dt,
                    meta=(((1, 1), (1, 1), (0, 0)),),
                    qmeta=((-3, 0.9), (4,)) if bits == 1 else (),
                    rowlen=32, in_rows=((2, 32),), out_rows=(6, 24),
                    in_addr=((2, 1, 16),), out_addr=(1, 1, 24))
    if streaming:
        spec = dataclasses.replace(
            spec, win_rows=staged_slots([2], 6, K._sub(dt))[2])
    return spec, 16


def _typed_state(card, spec, rows, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (rows, spec.rowlen)
    t = (torch.randint(-128, 128, shape, dtype=torch.int8, generator=g)
         if spec.dtype == "i8" else torch.randn(shape, generator=g))
    return t.to(card)


@pytest.mark.parametrize("bits", [4, 1])
def test_pad_grid_does_not_race_on_the_card(card, bits):
    """The pad's chunk walk, 50 launches each, every launch bit-equal to
    the first and the first bit-equal to the plain version: the pads of
    allops and stream_allops on the flat and blocked programs (order word
    0), the chip script's ResNet50 stem pads (112, 112, 64) -> (114, 114,
    64) with the output apart (0) and over the input (2, every chunk
    staged before one grid-wide barrier), and a hand-built blocked pad
    over its packed input (2)."""
    cs = _chip_smoke()
    is_pad = lambda s: s.kind == "pad"  # noqa: E731
    exact = lambda s: True  # noqa: E731
    for build in (cs.allops_graph, cs.stream_allops_graph):
        cp = compile(build(bits), backend="numpy")
        for kw in ({}, {"layout": "blocks"}):
            specs = CudaExecutor(device=card, **kw).program(cp)[0]
            assert [K.pad_order(s) for s in specs if is_pad(s)] == [
                K.EW_DISJOINT]
            assert _walk_holding(card, cp, is_pad, exact, **kw) == 1
    dt = "i8" if bits == 1 else "f32"
    orders = set()
    for place in cs.PAD_PLACES:
        spec, nbytes = cs.pad_spec(dt, 112, 112, 64, place)
        t, order = K.chunk_of(spec)
        assert t.vec > 1 and t.chunks > 1
        orders.add(order)
        _hold_exact_50(spec, None, None,
                       cs.seeded_state(torch, spec, nbytes, 12), True)
    assert orders == {K.EW_DISJOINT, K.EW_OVERLAP}
    spec, rows = _blocked_pad(bits, False)
    assert K.pad_order(spec) == K.EW_OVERLAP
    _hold_exact_50(spec, None, None, _typed_state(card, spec, rows, 13),
                   True)


def test_pad_refuses_a_grid_the_card_cannot_hold(card):
    """An order-2 pad launch whose chunks the card cannot hold at once is
    refused by the entry point (the wrapper's check raises) and runs
    nothing, on no smaller grid."""
    from repro_torch.kernels import build
    cs = _chip_smoke()
    spec, nbytes = cs.pad_spec("f32", 112, 112, 64, "over")
    _, group, ctr = K.chunk_grid(spec)
    assert group > 0
    arena = cs.seeded_state(torch, spec, nbytes, 14)
    before = arena.clone()
    too_many = 1 << 20
    ws = K.workspace(spec, card)
    err = build.entry("arena_pad")(
        arena.data_ptr(), K.descriptor(spec, card).data_ptr(), None,
        ws.data_ptr(), K.buffer_plan(spec).smem, too_many, too_many, ctr,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="arena_pad"):
        build.check(err, "arena_pad")
    torch.cuda.synchronize()
    assert torch.equal(arena, before)


@pytest.mark.parametrize("bits", [4, 1])
def test_staged_pad_runs_in_place_on_the_card(card, bits):
    """The streaming program of allops and stream_allops: the staged pad
    runs in place on the arena (no window, no copy), held 50 times against
    the plain streaming version, and the final streaming arena equals the
    blocked one; the chip script's streaming pad (its TPU window 819,200
    B, f32) and a hand-built staged pad over its packed input (order word
    2) in place, 50 times each."""
    cs = _chip_smoke()

    def staged(spec):
        if K.stream_form(spec) != "stage" or spec.kind != "pad":
            return False
        assert K.runs_in_place(spec)
        assert cs.card_staging_bytes(K, spec) == 0
        assert K.descriptor_words(spec)[K.S_BODY] == 32
        return True
    for build in (cs.allops_graph, cs.stream_allops_graph):
        cp = compile(build(bits), backend="numpy")
        assert _walk_holding(card, cp, staged, lambda s: True,
                             mode="streaming") == 1
        st = CudaExecutor(device=card, mode="streaming")
        blk = CudaExecutor(device=card, layout="blocks")
        assert torch.equal(_final_arena(st, cp), _final_arena(blk, cp))
    hand = [_blocked_pad(bits, True)]
    if bits == 4:
        hand.append(cs.stream_pad_spec())
    for spec, rows in hand:
        assert staged(spec)
        _hold_exact_50(spec, None, None, _typed_state(card, spec, rows, 15),
                       True)


# ---------------------------------------------------------------------------
# the fused chains' grid (arena_fused_chain, arena_stream_fused)
# ---------------------------------------------------------------------------

_PROGRAMS = {"flat": {}, "blocks": {"layout": "blocks"},
             "streaming": {"mode": "streaming"}}


def _chip_smoke():
    """The chip script as a module (its hand-built chains)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chain_state(card, cp, program):
    """(fused spec, blob, descriptor, the arena as the program reaches the
    chain) of a compiled plan's program."""
    specs, ws, descs, state = CudaExecutor(
        device=card, **_PROGRAMS[program]).program(cp)
    for spec, w, d in zip(specs, ws, descs):
        if spec.kind == "fused":
            return spec, w, d, state
        K.apply_op(state, spec, w, d)
    raise AssertionError("no fused chain")


def _hold_chain(spec, got, ref):
    if spec.dtype == "i8":
        assert torch.equal(got, ref)
    else:
        g, r = (t.view(torch.float32) for t in (got, ref))
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("program", ["flat", "blocks", "streaming"])
@pytest.mark.parametrize("bits,batch", [(1, 1), (4, 1), (1, 2)])
def test_chain_grid_matches_plain_on_the_card(card, bits, batch, program):
    """The flagship's chain (int8, f32, int8 at batch 2) on each program:
    one launch of a cooperative grid of more than one CTA, against the
    plain version (int8 bit-exact, f32 within 1e-4)."""
    cp = compile(zoo.mobilenet_v1(0.25, 128, bits), batch=batch)
    spec, w, d, state = _chain_state(card, cp, program)
    assert K.chain_grid(spec)[0] > 1
    got, ref = state.clone(), state.clone()
    K.reset_launches()
    K.apply_op(got, spec, w, d)
    assert sum(K.LAUNCHES.values()) == 1
    K.apply_plain(ref, spec, w)
    torch.cuda.synchronize()
    _hold_chain(spec, got, ref)


@pytest.mark.parametrize("rowlen,stream", [(0, False), (512, False),
                                           (512, True)])
@pytest.mark.parametrize("dtype", ["i8", "f32"])
def test_staged_terminal_chain_on_the_card(card, dtype, rowlen, stream):
    """A hand-built chain whose terminal concat reads the chain input it
    overwrites in the arena (flat, blocked and streaming): every chunk of
    the last level stages its results before one more grid barrier; held
    against the plain version, and 20 launches bit-equal to the first."""
    CS = _chip_smoke()
    spec, n = CS.fused_demo_spec(dtype, 28, 28, 16, rowlen, arena_cat=True)
    if stream:
        spec = CS.stream_chain_spec(spec)
    assert K.chain_schedule(spec).staged
    g = torch.Generator().manual_seed(3)
    wt = (torch.randint(-127, 128, (3, 3, 16, 16), dtype=torch.int8,
                        generator=g) if dtype == "i8" else
          torch.randn(3, 3, 16, 16, generator=g) * 0.2)
    blob = K.pack_weights(spec, [wt.to(card)])
    if rowlen:
        shape = (n, rowlen)
        state = (torch.randn(shape, generator=g) if dtype == "f32" else
                 torch.randint(-128, 128, shape, dtype=torch.int8,
                               generator=g)).to(card)
    else:
        state = torch.randint(0, 256, (n,), dtype=torch.uint8,
                              generator=g).to(card)
        if dtype == "f32":
            state = torch.randn(n // 4, generator=g).view(
                torch.uint8).to(card)
    ref = state.clone()
    K.apply_plain(ref, spec, blob)
    first = None
    for _ in range(20):
        got = state.clone()
        K.apply_op(got, spec, blob)
        torch.cuda.synchronize()
        first = got if first is None else first
        assert torch.equal(got, first)
    _hold_chain(spec, first, ref)


@pytest.mark.parametrize("program", ["flat", "streaming"])
def test_chain_repeats_are_identical_on_the_card(card, program):
    """Five launches of the flagship int8 chain on the same arena give
    byte-identical arenas (a missing level barrier would show here)."""
    cp = compile(zoo.mobilenet_v1(0.25, 128, 1))
    spec, w, d, state = _chain_state(card, cp, program)
    outs = []
    for _ in range(5):
        got = state.clone()
        K.apply_op(got, spec, w, d)
        outs.append(got)
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_chain_refuses_a_grid_the_card_cannot_hold(card):
    """A chain launch asking for more resident CTAs than the card holds is
    refused by the entry point and runs nothing, on no smaller grid."""
    from repro_torch.kernels import build
    cp = compile(zoo.mobilenet_v1(0.25, 128, 1))
    spec, w, d, state = _chain_state(card, cp, "flat")
    _, _, ctr = K.chain_grid(spec)
    before = state.clone()
    too_many = 1 << 20
    err = build.entry("arena_fused_chain")(
        state.data_ptr(), d.data_ptr(), w.data_ptr(),
        K.workspace(spec, card).data_ptr(), K.buffer_plan(spec).smem,
        too_many, too_many, ctr, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="arena_fused_chain"):
        build.check(err, "arena_fused_chain")
    torch.cuda.synchronize()
    assert torch.equal(state, before)


# ---------------------------------------------------------------------------
# the standalone kernels (rmsnorm_inplace, flash_attention, wkv_chunk)
# ---------------------------------------------------------------------------

_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _normal(card, seed, *shape, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(card).to(dtype)


def _assert_close(got, want, tol, rtol=None):
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=tol if rtol is None else rtol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(64, 32), (256, 64), (128, 200), (8, 8),
                                 (4096, 2048)])
def test_rmsnorm_on_the_card(card, n, d, dt):
    """Kernel against plain version; the result is x's storage and the
    call allocates nothing but g's float32 copy (bf16 g; one 512 B block
    of the allocator at least), well under x's bytes at full width."""
    from repro_torch.kernels import inplace_rmsnorm as TR
    from repro_torch.kernels import ops as TO
    ty = _TYPES[dt]
    x, g, r = (_normal(card, n + d + i, *s, dtype=ty)
               for i, s in enumerate(((n, d), (d,), (n, d))))
    want = TR.rmsnorm_plain(x.clone(), g, r)
    TR.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = TO.rmsnorm_residual(x, g, r)
    torch.cuda.synchronize()
    assert got.data_ptr() == x.data_ptr() and TR.LAUNCHES == 1
    rise = torch.cuda.max_memory_allocated() - base
    assert rise <= (0 if dt == "f32" else -(-4 * d // 512) * 512)
    assert rise < x.numel() * x.element_size() or n * d < 4096
    _assert_close(got, want, 5e-2 if dt == "bf16" else 2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,t,h,d,causal", [
    (128, 128, 4, 64, True), (256, 256, 2, 32, True), (64, 256, 3, 16, True),
    (32, 32, 1, 128, True), (64, 128, 2, 32, False), (64, 32, 2, 32, True),
    (100, 70, 2, 24, True), (4096, 4096, 16, 128, True),
    (1000, 1000, 4, 96, True), (1, 4096, 8, 128, False),
    (300, 200, 2, 40, True)])
def test_flash_attention_on_the_card(card, s, t, h, d, causal, dt):
    _hold_flash(card, s, t, h, d, causal, dt, 1.0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,t,h,d,causal", [
    (512, 512, 4, 128, True), (300, 200, 2, 40, True),
    (1000, 1000, 4, 96, False)])
def test_flash_attention_rescales_large_scores_on_the_card(card, s, t, h, d,
                                                           causal, dt):
    """q x 8: scores of tens, so the running max moves often and the
    rescaling of (l, acc) carries the result."""
    _hold_flash(card, s, t, h, d, causal, dt, 8.0)


def _hold_flash(card, s, t, h, d, causal, dt, scale):
    """The kernel against its plain version (and the oracle where it is
    small), with the plain version and SDPA made to raise: the card path
    calls neither."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops as TO
    from repro_torch.kernels import ref as TREF
    ty = _TYPES[dt]
    q = (_normal(card, s, s, h, d) * scale).to(ty)
    k = _normal(card, t + 1, t, h, d, dtype=ty)
    v = _normal(card, t + 2, t, h, d, dtype=ty)
    plain = TF.flash_plain

    def refuse(*a, **kw):
        raise AssertionError("the card path reached a fallback")
    TF.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "flash_plain", refuse)
        mp.setattr(F, "scaled_dot_product_attention", refuse)
        got = TO.flash_attention(q, k, v, causal=causal)
    assert got.is_cuda and got.dtype == ty and TF.LAUNCHES == 1
    # bf16: atol 4e-3, rtol 2e-2, from the rounding of P and out to bf16;
    # a skipped key tile fails it (scripts/torch_flash_faults.py)
    tol, rtol = (4e-3, 2e-2) if dt == "bf16" else (2e-4, 2e-4)
    _assert_close(got, plain(q, k, v, causal), tol, rtol)
    if s * t <= 1 << 16:
        _assert_close(got, TREF.attention(q, k, v, causal), tol, rtol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_refuses_a_misaligned_view_on_the_card(card, dt):
    """A contiguous view one element into its storage is not on a 16-byte
    boundary: the wrapper raises rather than copy it or run the plain
    version."""
    from repro_torch.kernels import flash_attention as TF
    s, h, d = 64, 2, 32
    ty = _TYPES[dt]
    buf = _normal(card, 9, s * h * d + 8, dtype=ty)
    bad = buf[1:1 + s * h * d].view(s, h, d)
    good = buf[8:8 + s * h * d].view(s, h, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    TF.reset_launches()
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            TF.flash_attention_kernel(*args)
    assert TF.LAUNCHES == 0
    TF.flash_attention_kernel(good, good, good)
    assert TF.LAUNCHES == 1


#: the backward's limits against its plain version, (atol, rtol), both
#: scaled by the largest entry of the plain version's gradient: f32 1e-4
#: (the two sum in other orders); bf16 the forward's (4e-3, 2e-2), since
#: both compute in f32 from the same bf16 inputs and round dq, dk, dv to
#: bf16 at the end, where the two may land one bf16 step apart
FLASH_BWD_TOL = {"f32": (1e-4, 0.0), "bf16": (4e-3, 2e-2)}


def _hold_grads(got, want, dt, label=""):
    atol, rtol = FLASH_BWD_TOL[dt]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        top = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), atol=atol * top,
                                   rtol=rtol, msg=f"{label} {name}")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s,t,h,d,causal", [
    (64, 64, 2, 32, True), (130, 130, 3, 64, True), (256, 256, 2, 128, True),
    (64, 200, 2, 16, True), (100, 60, 2, 40, False), (300, 300, 2, 48, True),
    (4096, 4096, 16, 128, True),
    # the train launcher's --reduced qwen2.5-3b at --seq 4096, batch 8
    (4096, 4096, 32, 32, True),
    # minicpm3-4b's training microbatch: 40 heads of MLA's folded D = 96
    # (bf16: the second 64-column slab half filled)
    (4096, 4096, 40, 96, True),
    # one past a 128-row (bf16 CTA) tile, and D at each other D_pad
    (129, 129, 2, 128, True), (257, 257, 2, 64, True),
    (200, 200, 2, 24, True), (200, 200, 2, 56, True), (200, 200, 2, 80, True),
    (200, 200, 2, 96, True), (200, 200, 2, 112, True)])
def test_flash_backward_on_the_card(card, s, t, h, d, causal, dt):
    """The two backward launches of either type (bf16: the dQ grid over
    query tiles, the dK/dV grid over key tiles; f32: the pre-pass, the one
    pass over key tiles with dQ's ordered adds) against
    ``flash_backward_plain`` on the forward kernel's own output and lse,
    with the lse against the plain forward's; a second call bit-equal to
    the first; the Function's gradients equal to the direct call's."""
    from repro_torch.kernels import flash_attention as TF
    ty = _TYPES[dt]
    q = _normal(card, s + 3, s, h, d, dtype=ty)
    k = _normal(card, t + 4, t, h, d, dtype=ty)
    v = _normal(card, t + 5, t, h, d, dtype=ty)
    do = _normal(card, s + 6, s, h, d, dtype=ty)
    TF.reset_launches()
    out, lse = TF._forward(q, k, v, causal, 128, 128, True)
    _, want_lse = TF.flash_plain_lse(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=2e-4)
    got = TF.flash_backward_kernel(q, k, v, out, do, lse, causal)
    again = TF.flash_backward_kernel(q, k, v, out, do, lse, causal)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == 1 and TF.BWD_LAUNCHES == 2 * TF.BWD_KERNELS_PER_CALL
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = TF.flash_backward_plain(q, k, v, out, do, lse, causal)
    _hold_grads(got, want, dt, f"({s}, {t}, {h}, {d}, {causal}) {dt}")
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    y = TF.flash_attention_kernel(*leaves, causal)
    grads = torch.autograd.grad(y, leaves, do)
    assert TF.LAUNCHES == 2 and TF.BWD_LAUNCHES == 6
    assert torch.equal(y, out)
    for a, b in zip(grads, got):
        assert torch.equal(a, b)


def test_flash_backward_bf16_runs_on_wgmma_and_tma_on_the_card(card):
    """The built ``flash_attention_bwd`` library: each bf16 kernel (the dQ
    and dK/dV launches, both slab counts) holds wgmma (``HGMMA``), TMA loads
    (``UTMALDG``) and mbarrier operations (``SYNCS``) and no ``mma.sync``
    (``HMMA``) in its SASS (``cuobjdump -sass``), and ``-Xptxas -v`` reports
    no stack and no spills for them at D_pad 128 (two 64-column slabs)."""
    import shutil
    import subprocess
    from repro_torch.kernels import build
    build.load()
    lib = build.build_dir() / "libflash_attention_bwd.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        funcs[part.split(None, 1)[0]] = part
    bf16 = {name: body for name, body in funcs.items()
            if "bwd_dq_wg" in name or "bwd_dkv_wg" in name}
    assert len(bf16) == 4, sorted(funcs)
    for name, body in bf16.items():
        assert "HGMMA" in body and "UTMALDG" in body and "SYNCS" in body, \
            name
        assert "HMMA" not in body, name
    res = build.ptxas_resources("flash_attention_bwd")
    wide = {fn: r for fn, r in res.items()
            if ("bwd_dq_wg" in fn or "bwd_dkv_wg" in fn) and "ILi2E" in fn}
    assert len(wide) == 2, sorted(res)
    for fn, r in wide.items():
        assert r["stack"] == r["spill_stores"] == r["spill_loads"] == 0, \
            (fn, r)


def test_flash_backward_f32_has_no_stack_or_spills_on_the_card(card):
    """``-Xptxas -v`` of the built ``flash_attention_bwd`` library: the f32
    pre-pass and the one pass at each W (32, 64, 128) use no stack frame
    and spill nothing."""
    from repro_torch.kernels import build
    build.load()
    res = build.ptxas_resources("flash_attention_bwd")
    f32 = {fn: r for fn, r in res.items() if "flash_bwd_f32" in fn}
    assert len(f32) == 4, sorted(res)
    for fn, r in f32.items():
        assert r["stack"] == r["spill_stores"] == r["spill_loads"] == 0 \
            and r["registers"] > 0, (fn, r)


def test_flash_backward_refuses_what_it_cannot_take_on_the_card(card):
    """Causal T < S (a row that sees no key has no finite lse) and a
    misaligned view raise; nothing launches."""
    from repro_torch.kernels import flash_attention as TF
    q = _normal(card, 1, 64, 2, 32).requires_grad_()
    k = _normal(card, 2, 32, 2, 32)
    TF.reset_launches()
    with pytest.raises(ValueError, match="T >= S"):
        TF.flash_attention_kernel(q, k, k, True)
    buf = _normal(card, 3, 64 * 2 * 32 + 4)
    bad = buf[1:1 + 64 * 2 * 32].view(64, 2, 32)
    x = _normal(card, 4, 64, 2, 32)
    lse = torch.zeros((64, 2), device=card)
    with pytest.raises(ValueError, match="16-byte"):
        TF.flash_backward_kernel(x, x, x, x, bad, lse, True)
    assert TF.LAUNCHES == 0 and TF.BWD_LAUNCHES == 0


def _wkv_sequential(r, k, v, w, u):
    """The recurrence one step at a time (the reference's _rwkv_step)."""
    b, s, h, d = r.shape
    st = torch.zeros((b, h, d, d), device=r.device)
    ys = []
    for i in range(s):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, i],
                               st + u[:, :, None] * kv))
        st = w[:, i, :, :, None] * st + kv
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("b,s,h,d,q,shift", [
    (2, 128, 2, 64, 32, 0.0), (2, 256, 4, 64, 64, 0.0),
    (2, 192, 1, 64, 64, 0.0), (2, 192, 1, 40, 24, 0.0),
    (2, 64, 3, 64, 64, 0.0), (2, 256, 4, 64, 64, 3.0),
    (1, 4096, 32, 64, 64, 0.0), (2, 35, 1, 7, 5, 0.0)])
def test_wkv_chunk_on_the_card(card, b, s, h, d, q, shift):
    """Three launches against the plain version (made to raise during the
    call: the card path never runs it) and, below full width, the
    sequential recurrence; shift 3 is the strong-decay input, chunk
    log-decays far past -88.7, and every output stays finite."""
    from repro_torch.kernels import wkv_chunk as TW
    r, k, v, z = (_normal(card, s + i, b, s, h, d) for i in range(4))
    logw = -torch.exp(z * 0.5 + shift)
    u = _normal(card, s + 5, h, d) * 0.1
    plain = TW.wkv_plain

    def refuse(*a, **kw):
        raise AssertionError("the card path reached a plain version")
    TW.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "wkv_plain", refuse)
        mp.setattr(TW, "wkv_phases_plain", refuse)
        y, st = TW.wkv_chunk_kernel(r, k, v, logw, u, q=q)
    torch.cuda.synchronize()
    assert y.is_cuda and TW.LAUNCHES == TW.KERNELS_PER_CALL == 3
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    y0, st0 = plain(r, k, v, logw, u, q)
    _assert_close(y, y0, 3e-4)
    _assert_close(st, st0, 3e-4)
    if b * s * h <= 2048:
        ys, sts = _wkv_sequential(r, k, v, torch.exp(logw), u)
        _assert_close(y, ys, 3e-4)
        _assert_close(st, sts, 3e-4)


def test_wkv_chunk_unaligned_on_the_card(card):
    """Inputs that start one float into their storage (not 16-byte
    aligned) take the kernel's 4-byte copies and scalar stores at D = 64;
    held against the plain version and the sequential recurrence."""
    from repro_torch.kernels import wkv_chunk as TW
    b, s, h, d, q = 2, 256, 4, 64, 64

    def one_float_in(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)
    r, k, v, z = (_normal(card, s + i, b, s, h, d) for i in range(4))
    logw = -torch.exp(z * 0.5)
    u = _normal(card, s + 5, h, d) * 0.1
    r, k, v, logw = (one_float_in(t) for t in (r, k, v, logw))
    assert r.data_ptr() % 16 != 0 and r.is_contiguous()
    TW.reset_launches()
    y, st = TW.wkv_chunk_kernel(r, k, v, logw, u, q=q)
    torch.cuda.synchronize()
    assert TW.LAUNCHES == TW.KERNELS_PER_CALL
    y0, st0 = TW.wkv_plain(r, k, v, logw, u, q)
    _assert_close(y, y0, 3e-4)
    _assert_close(st, st0, 3e-4)
    ys, sts = _wkv_sequential(r, k, v, torch.exp(logw), u)
    _assert_close(y, ys, 3e-4)
    _assert_close(st, sts, 3e-4)


#: label -> port graph builder of the serving tests on the card
SERVE_GRAPHS = {
    "band_graph_f32": band_graph,
    "band_graph_8bit": lambda: band_graph(db=1),
    "mobilenet_v1_0.25_32_8bit": lambda: zoo.mobilenet_v1(0.25, 32, 1),
}


@pytest.mark.parametrize("label", sorted(SERVE_GRAPHS))
def test_plan_server_on_the_card(card, label):
    """A PlanServer with no device runs every flush on the card: batches
    (1, 2, 4, 8) each once over 15 float requests, each flush's device
    arena its variant's peak_bytes and one launch a spec, every request
    within compare_outputs of FastExec on that request alone."""
    graph = SERVE_GRAPHS[label]()
    srv = PlanServer(graph, batches=(1, 2, 4, 8), max_delay_s=10.0)
    assert srv.device.type == "cuda"
    imgs = [random_inputs(graph, seed=i) for i in range(15)]
    for im in imgs:
        srv.submit(im)
    K.reset_launches()
    assert srv.drain() == 15
    assert [f.batch for f in srv.flushes] == [8, 4, 2, 1]
    assert sum(K.LAUNCHES.values()) == sum(f.specs for f in srv.flushes)
    for f in srv.flushes:
        assert f.arena_bytes == srv.variants[f.batch].peak_bytes
    for r in srv.done:
        compare_outputs(alone(srv._exec, imgs[r.rid]), r.output,
                        exact=False, label=f"request {r.rid}")



# ---------------------------------------------------------------------------
# the decoder models and the decode engines on the card
# ---------------------------------------------------------------------------


def _model(arch, dtype="float32", **kw):
    """A reduced arch and its weights drawn on the CPU from a seed, on the
    CPU and on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **kw)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, cpu, T.tree_map(lambda t: t.cuda(), cpu)


def _refuse(*a, **kw):
    raise AssertionError("the card path reached a plain version")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b"])
def test_flash_route_on_the_card(card, arch):
    """Causal prefill attention past FLASH_THRESHOLD (S = 2112, batch 2)
    through the flash kernel: one launch, with its plain version made to
    raise, against the CPU route (the plain version) within 2e-4; GQA on
    2 kv heads and MLA's folded D = 48."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model(arch)
    fwd = L.mla_forward if cfg.attention == "mla" else L.attn_forward
    x = _normal(card, 9, 2, 2112, cfg.d_model)
    want, wcache = fwd(T.layer(cpu["blocks"], 0)["attn"], x.cpu(), cfg)
    TF.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "flash_plain", _refuse)
        got, gcache = fwd(T.layer(dev["blocks"], 0)["attn"], x, cfg)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == 1 and got.is_cuda
    _assert_close(got.cpu(), want, 2e-4)
    for name, w in wcache.items():
        _assert_close(gcache[name].cpu(), w, 2e-4)


def test_wkv_route_on_the_card(card):
    """RWKV's chunked time mixing at S = 256, batch 2, through the WKV
    kernel: three launches, with its plain versions made to raise, against
    the CPU route within 3e-4 (output and state)."""
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model("rwkv6-1.6b")
    x = _normal(card, 10, 2, 256, cfg.d_model)
    want, wst = S.rwkv_forward(T.layer(cpu["blocks"], 0)["rwkv"], x.cpu(),
                               cfg)
    TW.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TW, "wkv_plain", _refuse)
        mp.setattr(TW, "wkv_phases_plain", _refuse)
        got, gst = S.rwkv_forward(T.layer(dev["blocks"], 0)["rwkv"], x, cfg)
    torch.cuda.synchronize()
    assert TW.LAUNCHES == TW.KERNELS_PER_CALL and got.is_cuda
    _assert_close(got.cpu(), want, 3e-4)
    _assert_close(gst["wkv"].cpu(), wst["wkv"], 3e-4)


#: (arch, prompt) of the card's prefill and decode test, every configured
#: arch: past FLASH_THRESHOLD where the arch's attention has no window
#: (the flash kernel), 256 for RWKV's chunked WKV and hymba's windowed
#: attention
MODEL_CASES = [("qwen2.5-3b", 2112), ("minicpm3-4b", 2112),
               ("rwkv6-1.6b", 256), ("yi-6b", 2112),
               ("nemotron-4-15b", 2112), ("olmoe-1b-7b", 2112),
               ("qwen3-moe-235b-a22b", 2112), ("hymba-1.5b", 256),
               ("internvl2-1b", 2112), ("musicgen-medium", 2112)]


def _prompt(cfg, b, s, seed):
    """(prompt, tokens): b x (s + 4) token ids, the prompt their first s,
    or b x s x d_model embeddings for a frontend stub (its decode steps
    take tokens)."""
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + 4))
                           .astype(np.int32))
    if cfg.frontend == "none":
        return toks[:, :s], toks
    return torch.as_tensor(rng.standard_normal((b, s, cfg.d_model))
                           .astype(np.float32)), toks


@pytest.mark.parametrize("arch,s", MODEL_CASES)
def test_prefill_and_decode_on_the_card(card, arch, s):
    """A reduced model's prefill (on the kernels: one flash launch or
    three WKV launches a layer, none for hymba's windowed attention, with
    flash's plain version made to raise where the kernel route applies)
    and four decode steps on the card, each within 2e-3 of the CPU route;
    a MoE prefill's routers pick the same experts on both devices."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model(arch)
    prompt, toks = _prompt(cfg, 2, s, 11)
    flash = _chip_smoke().flash_route(cfg, s)
    picks = []
    route = M._route

    def recorded(p, xf, c):
        out = route(p, xf, c)
        picks.append(out[1].cpu())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_route", recorded)
        want, wcache = T.prefill(cfg, cpu, prompt, s + 4)
        if flash:
            mp.setattr(TF, "flash_plain", _refuse)
        TF.reset_launches()
        TW.reset_launches()
        got, gcache = T.prefill(cfg, dev, prompt.cuda(), s + 4)
        torch.cuda.synchronize()
    if cfg.is_moe:
        n = cfg.num_layers
        assert len(picks) == 2 * n
        for i in range(n):
            assert torch.equal(picks[n + i], picks[i]), f"layer {i} routes"
    per_layer = (TW.KERNELS_PER_CALL if cfg.attention == "none"
                 else int(flash))
    assert TF.LAUNCHES + TW.LAUNCHES == per_layer * cfg.num_layers
    _assert_close(got.cpu(), want, 2e-3)
    for i in range(4):
        tok = toks[:, s + i:s + i + 1]
        want, wcache = T.decode_step(cfg, cpu, wcache, tok, s + i)
        got, gcache = T.decode_step(cfg, dev, gcache, tok.cuda(), s + i)
        _assert_close(got.cpu(), want, 2e-3)
    for name, w in wcache.items():
        _assert_close(gcache[name].cpu(), w, 2e-3)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b"])
def test_ring_wraps_on_the_card(card, arch):
    """The ring with no window (long_500k's on an attention arch): a
    prefill of S = 2112 tokens (the flash kernel, its plain version made
    to raise) into as many slots, then 24 decode steps that wrap the ring,
    each within 2e-3 of the CPU route, the card's cache in its storage
    throughout and within 2e-3 of the CPU's at the end."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.models import transformer as T
    cfg, cpu, dev = _model(arch)
    s, steps = 2112, 24
    _, toks = _prompt(cfg, 2, s + steps - 4, 15)
    TF.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        want, wcache = T.prefill(cfg, cpu, toks[:, :s], s)
        mp.setattr(TF, "flash_plain", _refuse)
        got, gcache = T.prefill(cfg, dev, toks[:, :s].cuda(), s)
        torch.cuda.synchronize()
    assert TF.LAUNCHES == cfg.num_layers
    _assert_close(got.cpu(), want, 2e-3)
    ptrs = {k: v.data_ptr() for k, v in gcache.items()}
    for pos in range(s, s + steps):
        tok = toks[:, pos:pos + 1]
        want, wcache = T.decode_step(cfg, cpu, wcache, tok, pos)
        got, gcache = T.decode_step(cfg, dev, gcache, tok.cuda(), pos)
        _assert_close(got.cpu(), want, 2e-3)
    assert {k: v.data_ptr() for k, v in gcache.items()} == ptrs
    for name, w in wcache.items():
        assert w.shape[2] == s
        _assert_close(gcache[name].cpu(), w, 2e-3)


def test_kernel_calls_keep_on_the_host_on_the_card(card):
    """``chip_smoke.KernelCalls`` with ``host`` copies the kept call to
    the host as it returns: once the caller drops its tensors the card
    holds none of them (the 500k run's layer 0 kept on the card left the
    prefill too little room), and the copies equal the call's."""
    from repro_torch.kernels import wkv_chunk as TW
    cs = _chip_smoke()
    b, s, h, d, q = 1, 1024, 4, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    r, k, v = (torch.randn(b, s, h, d, device=card, generator=gen)
               for _ in range(3))
    logw = -torch.rand(b, s, h, d, device=card, generator=gen)
    u = torch.randn(h, d, device=card, generator=gen)
    with cs.KernelCalls(torch, keep=("first",), host=True) as calls:
        y, st = TW.wkv_chunk_kernel(r, k, v, logw, u, q=q)
    args, _, out = calls.first["wkv_chunk"]
    for a, want in zip(args + out, (r, k, v, logw, u, y, st)):
        assert a.device.type == "cpu" and torch.equal(a, want.cpu())
    del r, k, v, logw, u, y, st, want
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b", "hymba-1.5b",
                                  "olmoe-1b-7b"])
def test_decode_step_is_in_place_on_the_card(card, arch):
    """One decode step after a prefill keeps every stacked cache tensor in
    its storage and raises the peak memory by less than the cache's
    bytes (a copy of the cache would not fit). 16 layers: a step's own
    temporaries are one layer's (its cache slice read in float32), which
    at the reduced width's 2 layers would already match the whole bf16
    cache."""
    from repro_torch.models import transformer as T
    cfg, _, dev = _model(arch, dtype="bfloat16", num_layers=16)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (4, 513)).astype(np.int32)).cuda()
    with torch.inference_mode():
        _, cache = T.prefill(cfg, dev, toks[:, :512], 513)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        nbytes = sum(v.numel() * v.element_size() for v in cache.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, cache = T.decode_step(cfg, dev, cache, toks[:, 512:], 512)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert rise < nbytes, (rise, nbytes)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm3-4b",
                                  "rwkv6-1.6b"])
def test_decode_step_never_waits_for_the_card(card, arch):
    """A decode step at an int position issues no operation that makes the
    host wait for the card (``torch.cuda.set_sync_debug_mode`` raises on
    one), so the host can queue the next layers while the card runs."""
    from repro_torch.models import transformer as T
    cfg, _, dev = _model(arch, dtype="bfloat16")
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)).cuda()
    with torch.inference_mode():
        _, cache = T.prefill(cfg, dev, toks[:, :64], 80)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            T.decode_step(cfg, dev, cache, toks[:, 64:], 64)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_engines_on_the_card(card):
    """``Engine`` and ``ContinuousEngine`` with no device run on the card:
    three ragged requests on two slots equal single-request engines."""
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   Engine, Request, ServeConfig)
    cfg, _, dev = _model("qwen2.5-3b")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 90, 12)]
    eng = ContinuousEngine(cfg, dev, ContinuousConfig(slots=2,
                                                      cache_len=128))
    assert eng.device.type == "cuda" and eng.cache["k"].is_cuda
    reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=40)
    single = Engine(cfg, dev, ServeConfig(cache_len=128, max_new_tokens=5))
    assert single.device.type == "cuda"
    for r, p in zip(reqs, prompts):
        assert r.done and r.out == single.generate(p[None])[0].tolist()


def _train_batch(cfg, s, seed, b=1):
    """b x s token ids and their next tokens; a frontend stub's inputs
    are b x s x d_model embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    inputs = toks[:, :-1]
    if cfg.frontend != "none":
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return {"inputs": torch.as_tensor(inputs),
            "targets": torch.as_tensor(toks[:, 1:])}


def test_train_step_on_the_card(card):
    """A reduced qwen2.5-3b (float32, 2 layers) train step at S = 2112
    with remat on the card: two flash forwards a layer (the forward and
    its recomputation) and one backward call (two launches) a layer, the
    plain versions made to raise; gradients, loss, grad norm and the state
    after the step against the same step on the CPU; every param, m and v
    leaf kept in its storage."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cfg, cpu, dev = _model("qwen2.5-3b")
    batch = _train_batch(cfg, 2112, 15)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    (wl, _), wg = TS.value_and_grad(cfg, cpu, batch, remat=True)
    TF.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "flash_plain", _refuse)
        mp.setattr(TF, "flash_plain_lse", _refuse)
        mp.setattr(TF, "flash_backward_plain", _refuse)
        (gl, _), gg = TS.value_and_grad(cfg, dev, gbatch, remat=True)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == 2 * cfg.num_layers
    assert TF.BWD_LAUNCHES == TF.BWD_KERNELS_PER_CALL * cfg.num_layers
    _assert_close(gl.cpu(), wl, 1e-5)
    for w, g in zip(adamw.tree_leaves(wg), adamw.tree_leaves(gg)):
        top = w.abs().max().item()
        torch.testing.assert_close(g.cpu(), w, atol=1e-4 * top, rtol=0)
    opt = adamw.OptConfig()
    cstate = {"params": cpu, "opt": adamw.init(cpu)}
    gstate = {"params": dev, "opt": adamw.init(dev)}
    ptrs = [t.data_ptr() for t in adamw.tree_leaves(gstate)]
    cstate, cm = TS.train_step(cfg, opt, cstate, batch)
    gstate, gm = TS.train_step(cfg, opt, gstate, gbatch)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in adamw.tree_leaves(gstate)] == ptrs
    for k in ("loss", "grad_norm", "lr"):
        _assert_close(gm[k].cpu(), cm[k], 1e-5)
    for w, g in zip(adamw.tree_leaves(cstate), adamw.tree_leaves(gstate)):
        _assert_close(g.cpu(), w, 1e-5)


def test_reduced_train_step_at_4096_on_the_card(card):
    """The train launcher's ``--reduced`` qwen2.5-3b (float32, 2 layers, 4
    heads of 32) at ``--seq 4096`` and its default batch 8: attention takes
    the flash route (B·H = 32, D = 32), one forward and one backward call
    (two f32 launches) a layer. Every gradient leaf of the loss on the
    kernels within ``chip_smoke.TRAIN_GRAD_TOL`` of the same loss with
    attention from ``chip_smoke.plain_attention``; then one train step of
    ``make_train_step`` (as the launcher runs it) gives a finite loss and
    grad norm."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           shard_batch)
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops as TO
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cs = _chip_smoke()
    cfg = get_arch("qwen2.5-3b").reduced()
    assert (cfg.dtype, cfg.num_heads, cfg.head_dim) == ("float32", 4, 32)
    batch = shard_batch(next(SyntheticCorpus(DataConfig(
        cfg.vocab_size, 4096, 8, seed=18)).packed_batches()), "cuda")
    opt = adamw.OptConfig()
    state = TS.init_state(cfg, torch.Generator(device="cuda").manual_seed(18),
                          opt, "cuda")
    TF.reset_launches()
    (kl, _), kg = TS.value_and_grad(cfg, state["params"], batch, remat=False)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == cfg.num_layers
    assert TF.BWD_LAUNCHES == TF.BWD_KERNELS_PER_CALL * cfg.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "flash_attention", cs.plain_attention(torch))
        (pl, _), pg = TS.value_and_grad(cfg, state["params"], batch,
                                        remat=False)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == cfg.num_layers
    atol, rtol = cs.TRAIN_GRAD_TOL
    torch.testing.assert_close(kl, pl, atol=atol * abs(float(pl)), rtol=rtol)
    for name, g, w in zip(cs._leaf_names(state["params"]),
                          adamw.tree_leaves(kg), adamw.tree_leaves(pg)):
        top = w.abs().max().item()
        torch.testing.assert_close(g, w, atol=atol * top, rtol=rtol,
                                   msg=name)
    step = TS.make_train_step(cfg, opt, remat=False)
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert TF.BWD_LAUNCHES == 2 * TF.BWD_KERNELS_PER_CALL * cfg.num_layers
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


def test_wkv_trains_on_the_card(card):
    """A 2-layer rwkv6-1.6b (reduced, float32) loss under grad at 256
    tokens on the card: each layer's chunked WKV runs the forward kernel
    and, in the backward, ``csrc/wkv_chunk_bwd.cu`` (every plain version
    made to raise); the loss and every gradient leaf within
    ``chip_smoke.TRAIN_GRAD_TOL`` of the same loss on the CPU's plain
    route, and wr, wk, wv, wd and u with non-zero gradients."""
    from repro_torch.kernels import wkv_chunk as TW
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cs = _chip_smoke()
    cfg, cpu, dev = _model("rwkv6-1.6b")
    assert cfg.num_layers == 2
    batch = _train_batch(cfg, 256, 16)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    (wl, _), wg = TS.value_and_grad(cfg, cpu, batch, remat=False)
    TW.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("wkv_plain", "wkv_phases_plain", "wkv_backward_plain",
                     "wkv_backward_phases_plain"):
            mp.setattr(TW, name, _refuse)
        (gl, _), gg = TS.value_and_grad(cfg, dev, gbatch, remat=False)
    torch.cuda.synchronize()
    assert TW.LAUNCHES == TW.KERNELS_PER_CALL * cfg.num_layers
    assert TW.BWD_LAUNCHES == TW.BWD_KERNELS_PER_CALL * cfg.num_layers
    atol, rtol = cs.TRAIN_GRAD_TOL
    torch.testing.assert_close(gl.cpu(), wl, atol=atol * abs(float(wl)),
                               rtol=rtol)
    names = cs._leaf_names(cpu)
    for name, w, g in zip(names, adamw.tree_leaves(wg),
                          adamw.tree_leaves(gg)):
        top = w.abs().max().item()
        torch.testing.assert_close(g.cpu(), w, atol=atol * top, rtol=rtol,
                                   msg=name)
    grads = dict(zip(names, adamw.tree_leaves(gg)))
    for leaf in ("wr/w", "wk/w", "wv/w", "wd/w", "u"):
        hit = [n for n in names if n.endswith(f"rwkv/{leaf}")]
        assert hit and all(grads[n].abs().max().item() > 0 for n in hit), \
            leaf


@pytest.mark.parametrize("arch,s", [("olmoe-1b-7b", 2112),
                                    ("hymba-1.5b", 256),
                                    ("internvl2-1b", 2112)])
def test_model_trains_on_the_card(card, arch, s):
    """A reduced model's loss under grad with remat on the card, batch 2
    (internvl2's inputs embeddings): two flash forwards and one backward
    call a layer where the kernel route applies, with every plain version
    of flash made to raise, none for hymba (MoE's aux loss and the Mamba
    loop under remat); the loss and every gradient leaf within
    ``chip_smoke.TRAIN_GRAD_TOL`` of the same loss on the CPU."""
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cs = _chip_smoke()
    cfg, cpu, dev = _model(arch)
    batch = _train_batch(cfg, s, 17, b=2)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    (wl, wparts), wg = TS.value_and_grad(cfg, cpu, batch, remat=True)
    flash = cs.flash_route(cfg, s)
    TF.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("flash_plain", "flash_plain_lse",
                     "flash_backward_plain"):
            mp.setattr(TF, name, _refuse)
        (gl, gparts), gg = TS.value_and_grad(cfg, dev, gbatch, remat=True)
    torch.cuda.synchronize()
    assert TF.LAUNCHES == 2 * cfg.num_layers * flash
    assert TF.BWD_LAUNCHES == TF.BWD_KERNELS_PER_CALL * cfg.num_layers \
        * flash
    atol, rtol = cs.TRAIN_GRAD_TOL
    for got, want in ((gl, wl), (gparts["moe_aux"], wparts["moe_aux"])):
        torch.testing.assert_close(got.cpu(), want,
                                   atol=atol * abs(float(want)), rtol=rtol)
    for name, w, g in zip(cs._leaf_names(cpu), adamw.tree_leaves(wg),
                          adamw.tree_leaves(gg)):
        top = w.abs().max().item()
        torch.testing.assert_close(g.cpu(), w, atol=atol * top, rtol=rtol,
                                   msg=name)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_repeats_bit_for_bit_on_the_card(card, arch):
    """A reduced MoE model's forward output and aux, and its loss and
    every gradient leaf (remat, S = 2112 on the flash kernel, batch 2,
    capacity factor 1.0 so that some copies drop), are bit-equal across
    two runs on the card: the dispatch and the combine sum in a fixed
    order."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS
    cfg, _, dev = _model(arch, capacity_factor=1.0)
    batch = {k: v.cuda() for k, v in _train_batch(cfg, 2112, 18,
                                                  b=2).items()}
    kept = []
    route = M._route

    def recorded(p, xf, c):
        out = route(p, xf, c)
        kept.append(bool(out[3].all()))
        return out
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_route", recorded)
        runs = [T.forward_train(cfg, dev, batch["inputs"]) for _ in range(2)]
    assert not all(kept)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    grads = [TS.value_and_grad(cfg, dev, batch, remat=True)
             for _ in range(2)]
    (l0, _), g0 = grads[0]
    (l1, _), g1 = grads[1]
    assert torch.equal(l0, l1)
    for a, b in zip(adamw.tree_leaves(g0), adamw.tree_leaves(g1)):
        assert torch.equal(a, b)


def _hold_wkv_grads(got, want, tol=3e-4):
    """dr, dk, dv, dlogw, du within ``tol`` (the forward's
    STANDALONE_TOL["wkv_chunk"]) scaled by each leaf's largest entry, and
    ``tol`` relative."""
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        top = w.abs().max().item()
        torch.testing.assert_close(g, w, atol=tol * top, rtol=tol, msg=name)


@pytest.mark.parametrize("b,s,h,d,q,shift,skew", [
    (2, 128, 2, 64, 32, 0.0, False), (2, 256, 4, 64, 64, 0.0, False),
    (2, 192, 1, 64, 64, 0.0, False), (2, 192, 1, 40, 24, 0.0, False),
    (2, 64, 3, 64, 64, 0.0, False), (2, 35, 1, 7, 5, 0.0, False),
    (2, 256, 4, 64, 64, 3.0, False), (2, 256, 4, 64, 64, 0.0, True),
    (1, 96, 2, 64, 48, 0.0, False), (1, 80, 3, 12, 40, 3.0, False),
    (1, 4096, 32, 64, 64, 0.0, False)])
def test_wkv_backward_on_the_card(card, b, s, h, d, q, shift, skew):
    """The four launches of ``csrc/wkv_chunk_bwd.cu`` on the forward
    kernel's workspace, every plain version made to raise during the
    call, against ``wkv_backward_plain``; a random state gradient, none
    (zero, as in training) on the inputs one float into their storage
    (4-byte copies at D = 64); q = 48 and 40 (three sub-chunks, the last
    ragged at 40, with D = 12 and strong decays); a second call bit-equal
    (no atomics) and the ``WkvChunk`` Function's gradients equal to the
    direct call's."""
    from repro_torch.kernels import wkv_chunk as TW
    r, k, v, z, dy = (_normal(card, s + i, b, s, h, d) for i in range(5))
    logw = -torch.exp(z * 0.5 + shift)
    u = _normal(card, s + 5, h, d) * 0.1
    dst = None if skew else _normal(card, s + 6, b, h, d, d)
    if skew:
        def one_float_in(t):
            buf = torch.empty(t.numel() + 1, device=t.device)
            buf[1:].copy_(t.reshape(-1))
            return buf[1:].view(t.shape)
        r, k, v, logw, dy = (one_float_in(t) for t in (r, k, v, logw, dy))
        assert r.data_ptr() % 16 != 0 and r.is_contiguous()
    plain = TW.wkv_backward_plain
    TW.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("wkv_plain", "wkv_phases_plain", "wkv_backward_plain",
                     "wkv_backward_phases_plain"):
            mp.setattr(TW, name, _refuse)
        _, _, ws = TW.wkv_forward_saved(r, k, v, logw, u, q)
        got = TW.wkv_backward_kernel(r, k, v, logw, u, dy, dst, q, ws)
        again = TW.wkv_backward_kernel(r, k, v, logw, u, dy, dst, q, ws)
        leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u)]
        y, st = TW.wkv_chunk_kernel(*leaves, q=q)
        outs, grads_in = (y, st), (dy, dst)
        if dst is None:
            outs, grads_in = (y,), (dy,)
        viaf = torch.autograd.grad(outs, leaves, grads_in)
    torch.cuda.synchronize()
    assert TW.LAUNCHES == 2 * TW.KERNELS_PER_CALL
    assert TW.BWD_LAUNCHES == 3 * TW.BWD_KERNELS_PER_CALL
    _hold_wkv_grads(got, plain(r, k, v, logw, u, dy, dst, q))
    assert all(bool(torch.equal(a, c)) for a, c in zip(got, again))
    assert all(bool(torch.equal(a, c)) for a, c in zip(got, viaf))


def test_wkv_backward_holds_16_warps_an_sm_on_the_card(card):
    """C' (``chunk_grads``) keeps at least 16 warps on an SM at its launch's
    threads and shared memory, by the card's occupancy calculator; A', B'
    and D' hold at least one CTA."""
    from repro_torch.kernels import wkv_chunk as TW
    occ = TW.bwd_occupancy()
    assert list(occ) == list(TW.BWD_KERNELS)
    assert occ["chunk_grads"]["warps_an_sm"] >= 16, occ
    assert all(o["ctas_an_sm"] >= 1 for o in occ.values()), occ


def test_wkv_backward_refuses_what_it_cannot_take_on_the_card(card):
    """D past 64 and a backward without the forward's workspace raise
    before any launch."""
    from repro_torch.kernels import wkv_chunk as TW
    r = _normal(card, 1, 1, 64, 1, 72)
    u = _normal(card, 2, 1, 72)
    TW.reset_launches()
    with pytest.raises(ValueError, match="D, q <= 64"):
        TW.wkv_backward_kernel(r, r, r, -r.abs(), u, r, None, 64,
                               torch.empty(0, device=card))
    r, u = r[..., :64].contiguous(), u[:, :64].contiguous()
    with pytest.raises(ValueError, match="workspace"):
        TW.wkv_backward_kernel(r, r, r, -r.abs(), u, r, None, 64, None)
    assert TW.LAUNCHES == 0 and TW.BWD_LAUNCHES == 0


def test_expert_parallel_layer_on_ranks_sharing_the_card(card):
    """The MoE layer's expert-parallel body on 2 ranks (mesh (1, 2)) that
    share the card over gloo, every floating-point ``index_add_`` and
    ``all_reduce`` made to raise in them: output and aux bit-equal to the
    one-process local path on the card (k = 2: each token's copies add
    alike), the gradients within 1e-4 of each leaf's max of its, both
    model ranks alike and two runs bit-equal."""
    import _torch_mesh_cases as C
    from repro_torch import configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as TM
    ranks = M.spawn(C.run_rank, 1, 2, backend="gloo", device="cuda",
                    args=([("layer", "1x2")], "cuda"), timeout=300)
    cfg = C.layer_cfg(configs.get_arch("olmoe-1b-7b").reduced(), "1x2")
    r, wg, wu, wd, x = (torch.as_tensor(a, device=card).requires_grad_()
                        for a in C.layer_arrays(cfg, "1x2"))
    y, aux = TM._moe_ffn_local({"router": {"w": r}, "w_gate": wg,
                                "w_up": wu, "w_down": wd}, x, cfg)
    loss = torch.sum(y * torch.sin(y)) + C.AUX_WEIGHT * aux
    want = dict(zip(("gr", "gwg", "gwu", "gwd", "gx"),
                    (g.cpu().numpy() for g in
                     torch.autograd.grad(loss, (r, wg, wu, wd, x)))))
    e_loc = cfg.num_experts // 2
    for m, res in enumerate(ranks):
        first, again = res["layer/1x2"]
        assert all(np.array_equal(first[k], again[k]) for k in first)
        assert np.array_equal(first["y"], y.detach().cpu().numpy())
        assert np.array_equal(first["aux"], aux.detach().cpu().numpy())
        for k, w in want.items():
            if k in ("gwg", "gwu", "gwd"):
                w = w[m * e_loc:(m + 1) * e_loc]
            assert np.abs(first[k] - w).max() <= 1e-4 * np.abs(w).max(), k
        for k in ("y", "aux", "gx", "gr"):
            assert np.array_equal(first[k], ranks[0]["layer/1x2"][0][k]), k


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """``"nccl"`` takes one card a rank: two ranks on the one card raise
    before any process group is made (no fall back to gloo). Runs on the
    CPU too: the card count is patched to 1."""
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share one"):
        M.rank_device("nccl", 0, 2)
    with pytest.raises(ValueError, match="share one"):
        M.open_mesh(1, 2, backend="nccl", rank=0,
                    init_method="file:///nonexistent/store")
    assert M.rank_device("nccl", 0, 1) == torch.device("cuda", 0)
