"""The fused chains' schedule on the card (``arena_ops.chain_schedule``,
the host half of ``csrc/chain_tiles.cuh``): the kernel's own placement of
every chain-internal tensor, the levels of independent stages, and a plain
mirror that runs a chain by that schedule against the one-stage-at-a-time
plain versions and the JAX package's Pallas kernels in interpret mode.

Cases: the flagship's band chain (``mobilenet_v1(0.25, 128)``, int8 and
f32, and int8 at batch 2) and ``chip_smoke.fused_demo_spec`` (conv2d, max
pool, add, average pool, an in-place relu6, concat; and its variant whose
concat reads the chain input it overwrites), each on the flat, row-blocked
and streaming programs. Tolerances are those of
``tests/test_torch_arena_ops.py``: the mirror is bit-equal to the plain
versions (the same torch ops per stage); against the reference int8 is
bit-exact and f32 within 1e-4 absolute plus 1e-4 relative (summation
order).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import arena_ops as R

from repro_torch.core import zoo as tzoo
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile as t_compile
from repro_torch.kernels import arena_ops as K

from _torch_block_cases import CS, _compare_arena, _ref_spec

PROGRAMS = {"flat": {}, "blocks": {"layout": "blocks"},
            "streaming": {"mode": "streaming"}}
#: (bits, batch) of the flagship's chains
FLAGSHIP = {"int8": (1, 1), "f32": (4, 1), "int8_batch2": (1, 2)}


@functools.lru_cache(maxsize=None)
def _flagship(case: str, program: str):
    """(fused spec, packed filter blob, the program's arena shape and
    dtype) of the flagship's chain."""
    bits, batch = FLAGSHIP[case]
    cp = t_compile(tzoo.mobilenet_v1(0.25, 128, bits), verify="off",
                   batch=batch)
    specs, ws, _, arena = CudaExecutor(device="cpu",
                                       **PROGRAMS[program]).program(cp)
    (i,) = [i for i, s in enumerate(specs) if s.kind == "fused"]
    return specs[i], ws[i], tuple(arena.shape), arena.dtype


@functools.lru_cache(maxsize=None)
def _demo(dtype: str, program: str, cat: bool = False):
    """(fused spec, packed filter blob, arena shape and dtype) of the
    hand-built chain: 12 x 10 x 4 images, blocked rows of 32 elements."""
    spec, n = CS.fused_demo_spec(dtype, 12, 10, 4,
                                 0 if program == "flat" else 32,
                                 arena_cat=cat)
    if program == "streaming":
        spec = CS.stream_chain_spec(spec)
    rng = np.random.default_rng(21)
    if dtype == "i8":
        w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 4, 4))
                             .astype(np.int8))
    else:
        w = torch.from_numpy(rng.standard_normal((3, 3, 4, 4))
                             .astype(np.float32) * np.float32(0.2))
    if program == "flat":
        shape, tdt = (n,), torch.uint8
    else:
        shape, tdt = (n, 32), torch.int8 if dtype == "i8" else torch.float32
    return spec, K.pack_weights(spec, [w]), shape, tdt


def _case(name: str, program: str):
    if name.startswith("demo"):
        _, dtype, *cat = name.split("_")
        return _demo(dtype, program, bool(cat))
    return _flagship(name, program)


def _arena(shape, dtype, f32: bool, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.uint8:
        n = shape[0]
        if f32:
            return torch.from_numpy(rng.standard_normal(-(-n // 4)).astype(
                np.float32).view(np.uint8)[:n].copy())
        return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-128, 128, shape,
                                             dtype=np.int8))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _filters(spec: K.OpSpec, blob: torch.Tensor):
    """The stage filters the blob packs, in stage order (numpy)."""
    offs, _ = K.weight_offsets(spec)
    out = []
    for st, off in zip(spec.stages, offs):
        if off is None:
            continue
        shape = K._weight_shape(st)
        out.append(K._typed(blob, off, K._elems(shape),
                            st.dtype == "i8").reshape(shape).numpy())
    return out


CASES = [*FLAGSHIP, "demo_i8", "demo_f32", "demo_i8_cat", "demo_f32_cat"]


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("case", list(FLAGSHIP))
def test_flagship_chain_levels(case, program):
    """Three levels, [8 conv2d] [8 depthwise] [concat] (per image at batch
    2), two grid barriers, more than one CTA; every dependency that is not
    read-after-write ends at a terminal stage (the concat writes the arena
    over the chain input the convs read)."""
    spec, _, _, _ = _case(case, program)
    s = K.chain_schedule(spec)
    b = FLAGSHIP[case][1]
    kinds = [[s.stages[j].kind for j in lv] for lv in s.levels]
    assert kinds == [["conv2d"] * 8 * b, ["depthwise_conv2d"] * 8 * b,
                     ["concat"] * b]
    assert s.levels[-1] == s.terminal and not s.staged
    assert s.n_barriers == 2 and s.grid > 1
    assert s.counter_bytes >= 4 * (len(s.levels) + s.n_barriers)
    assert {k for i, j, k in s.edges if j not in s.terminal} == {"raw"}
    assert {k for _, _, k in s.edges} <= {"raw", "war"}
    words = K.descriptor_words(spec)
    head = words[words[K.S_BODY]:] if spec.win_rows else words
    assert (head[K.H_NS], head[K.H_NL]) == (len(s.stages), 3)
    for lv, stages in enumerate(s.levels):   # one ticket range a level
        assert head[K.H_LEVEL0 + 2 * lv + 1] == sum(s.items[j]
                                                    for j in stages)


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("case", CASES)
def test_chain_regions_are_disjoint_inside_the_workspace(case, program):
    """Every non-terminal stage writes a region of its own, 16-byte
    aligned, after the counters and inside the workspace; terminal stages
    write the arena (their blocks, one per image)."""
    spec, _, _, _ = _case(case, program)
    s = K.chain_schedule(spec)
    ws = K.buffer_plan(spec).gbytes
    spans = []
    for j, off, nbytes in s.regions:
        st = s.stages[j]
        assert j not in s.terminal and st.out_scratch == 1
        assert st.out_off == off and (off * s.unit) % 16 == 0
        lo = off * s.unit
        assert s.counter_bytes <= lo and lo + nbytes <= \
            s.counter_bytes + s.region_bytes <= ws
        spans.append((lo, lo + nbytes))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert len(spans) + len(s.terminal) == len(s.stages)
    for j in s.terminal:
        assert s.stages[j].out_scratch == 0


def _writers(spec: K.OpSpec):
    """Per stage, per scratch-flagged input, what the reference's bytes
    held when it read them, by brute force over the scratch: a list of
    (writer stage, offset in its output) per unit, or ("in", e, offset) for
    a streaming chain's external input e copied in up front."""
    n = max(spec.scratch_rows, spec.win_rows)
    held = [None] * n
    for e, (slot, (rows, _)) in enumerate(zip(spec.in_slots, spec.in_rows)):
        for r in range(rows):
            held[slot + r] = ("in", e, r)
    seen = []
    for k, st in enumerate(spec.stages):
        reads = []
        for i, f in enumerate(st.in_scratch):
            lo, hi = K._span(st, i)
            reads.append([held[u] for u in range(lo, hi)] if f else None)
        seen.append(reads)
        if st.out_scratch:
            lo, hi = K._span(st, None)
            for u in range(lo, hi):
                held[u] = (k, u - lo)
    return seen


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("case", CASES)
def test_repointed_inputs_read_their_producers_region(case, program):
    """Every input the reference reads from its scratch reads, in the
    kernel's placement, the region of the stage that wrote those units
    (the same unit of its output), or, in the streaming program, the arena
    rows of the external input copied there; inputs of the arena stay."""
    spec, _, _, _ = _case(case, program)
    s = K.chain_schedule(spec)
    region = {j: off for j, off, _ in s.regions}
    for k, (old, new, reads) in enumerate(zip(spec.stages, s.stages,
                                              _writers(spec))):
        for i, held in enumerate(reads):
            if held is None:
                assert (new.in_off[i], new.in_scratch[i]) == \
                    (old.in_off[i], 0)
                continue
            assert len({h[0] for h in held}) == 1, (k, i)
            src = held[0]
            if src[0] == "in":
                e = src[1]
                assert new.in_scratch[i] == 0 and [h[2] for h in held] == \
                    list(range(src[2], src[2] + len(held)))
                assert new.in_off[i] == spec.in_off[e] + src[2]
            else:
                assert new.in_scratch[i] == 1 and [h[1] for h in held] == \
                    list(range(src[1], src[1] + len(held)))
                assert new.in_off[i] == region[src[0]] + src[1]


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("dtype", ["i8", "f32"])
def test_demo_chain_in_place_relu6_gets_its_own_region(dtype, program):
    """The hand-built chain's relu6 runs in place on its scratch slot in
    the reference; here it reads the average pool's region and writes a
    region of its own, which the concat reads. The chain is a line: six
    levels. With the concat over the chain input it reads, the last level
    stages its chunks before one more barrier."""
    spec, _, _, _ = _case(f"demo_{dtype}", program)
    old = spec.stages[4]
    assert old.kind == "elementwise" and old.meta == ("relu6",)
    assert old.in_off == (old.out_off,) and old.in_scratch == (1,)
    s = K.chain_schedule(spec)
    region = {j: off for j, off, _ in s.regions}
    relu = s.stages[4]
    assert relu.in_off == (region[3],) and relu.out_off == region[4]
    assert relu.in_off[0] != relu.out_off
    assert s.stages[5].in_off[0] == region[4]
    assert [len(lv) for lv in s.levels] == [1] * 6
    assert not s.staged and s.n_barriers == 5
    cat = K.chain_schedule(_case(f"demo_{dtype}_cat", program)[0])
    assert cat.staged and cat.n_barriers == 6
    assert cat.stages[5].in_scratch == (1, 0)


@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("case", CASES)
def test_chain_mirror_matches_plain_and_pallas(case, program):
    """The chain run by its schedule (levels in order, the stages of a
    level in reverse order, on the kernel's placement; the streaming
    chain's operands on their arena rows) leaves the arena bit-equal to
    the stage-by-stage plain version and to the reference's fused kernel
    in interpret mode."""
    spec, blob, shape, dtype = _case(case, program)
    f32 = spec.dtype == "f32"
    arena = _arena(shape, dtype, f32, 7)
    got = arena.clone()
    before = dict(K.LAUNCHES)
    K.chain_plain(got, spec, blob)
    assert K.LAUNCHES == before
    want = arena.clone()
    K.apply_op(want, spec, blob)       # the CPU route: the plain version
    assert torch.equal(got, want)
    ref = np.asarray(R.apply_op(
        jnp.asarray(arena.numpy()), _ref_spec(spec),
        tuple(jnp.asarray(w) for w in _filters(spec, blob)),
        interpret=True))
    if spec.rowlen:
        _compare_arena(spec, got.numpy(), ref)
        return
    isz = 4 if f32 else 1
    lo, hi = spec.out_off, spec.out_off + K._elems(spec.out_shape) * isz
    g, r = got.numpy(), ref
    outside = np.ones(g.size, bool)
    outside[lo:hi] = False
    np.testing.assert_array_equal(g[outside], r[outside])
    if f32:
        np.testing.assert_allclose(g[lo:hi].view(np.float32),
                                   r[lo:hi].view(np.float32),
                                   rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(g[lo:hi], r[lo:hi])
