"""Card-only tests of the PyTorch/CUDA port (marker ``gpu``): the CUDA
kernels against their plain versions, and the slice end to end on the card.
Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Without a card each test skips with its reason (decided in the fixture).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import zoo
from repro_torch.core.exec import compare_outputs, get_backend
from repro_torch.core.exec.cuda_backend import CudaExecutor
from repro_torch.core.pipeline import compile
from repro_torch.kernels import arena_ops as K

pytestmark = pytest.mark.gpu

PLAIN = {"conv2d": K.conv_plain, "depthwise_conv2d": K.conv_plain,
         "fully_connected": K.fully_connected_plain,
         "fused": K.fused_chain_plain}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _plain(arena, spec, w):
    fn = PLAIN.get(spec.kind)
    if fn is not None:
        fn(arena, spec, w)
    elif spec.kind == "mean":
        K.mean_plain(arena, spec)
    else:
        K.softmax_plain(arena, spec)


@pytest.mark.parametrize("bits", [1, 4])
def test_kernels_match_plain_versions_on_the_card(card, bits):
    cp = compile(zoo.mobilenet_v1(0.25, 128, bits))
    be = CudaExecutor(device=card)
    specs, ws, descs, state = be.program(cp)
    for spec, w, d in zip(specs, ws, descs):
        got, ref = state.clone(), state.clone()
        K.apply_op(got, spec, w, d)
        _plain(ref, spec, w)
        torch.cuda.synchronize()
        if bits == 1:
            err = (got.view(torch.int8).int() - ref.view(torch.int8).int())
            limit = 1 if spec.kind == "softmax" else 0
            assert err.abs().max().item() <= limit, spec.kind
        else:
            g, r = got.view(torch.float32), ref.view(torch.float32)
            assert torch.allclose(g, r, rtol=1e-4, atol=1e-4), spec.kind
        state = ref


def test_slice_on_the_card(card):
    cp = compile(zoo.mobilenet_v1(0.25, 128, 1), backend="cuda")
    assert (cp.verified, cp.winner, cp.peak_bytes) == \
        ("numeric+cuda", "fuse", 49_805)
    K.reset_launches()
    got = cp.execute()
    assert sum(K.LAUNCHES.values()) == 29
    assert all(v > 0 for v in K.LAUNCHES.values())
    compare_outputs(get_backend("numpy").execute(cp), got, exact=False,
                    label="cuda vs numpy")
    assert np.isfinite(got["prob_out"].astype(np.float64)).all()


def test_global_scratch_branch_on_the_card(card):
    g = zoo.TABLE3_MODELS["mobilenet_v1_1.0_224_8bit"][0]()
    cp = compile(g, backend="cuda")
    assert cp.peak_bytes == 517_052
    fused = [s for s in CudaExecutor(device=card).program(cp)[0]
             if s.kind == "fused"]
    assert fused and not K.fused_smem_plan(fused[0])[0]
    compare_outputs(get_backend("numpy").execute(cp), cp.execute(),
                    exact=False, label="1.0_224_8bit")
