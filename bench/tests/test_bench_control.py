"""The controls: the reference put in the port's place one precision
below what the configuration states, which must come out not correct
(float8 products for the bfloat16 served model). ``calibrate.py`` reads them at each cell's own size on
the card, over several seeds, for the limits; here one seed a cell (marked
``gpu``, skipping without a card) and a tiny CPU run."""
import pytest

from bench import calibrate, harness

from . import _tiny


def test_fp8_control_strays_far_beyond_the_port_on_the_cpu():
    """At tiny widths greedy tokens rarely tie, so the logits themselves:
    the float8 control's lie a hundred times farther from the float32
    reference's than the port's float32 prefill does."""
    import numpy as np
    import torch
    from bench.reference import qwen2
    from repro_torch.models import transformer as T
    c = _tiny.qwen2()
    w = qwen2.make_weights(c, 2**31 + 17, "cpu", torch.float32)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, 300))
    at = torch.tensor([299])
    with torch.inference_mode():
        port = T.prefill(harness.port_config(c), w, toks[None])[0][0, -1]
    ref = qwen2.logits_at(c, w, toks, at)[0]
    low = qwen2.logits_at(c, w, toks, at, low=True)[0]
    assert float((low - ref).abs().max()) > \
        100 * float((port - ref).abs().max())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read at the cells' "
                    "own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["qwen2.5-3b.serve-long"])
def test_control_fails_at_the_cells_size(card, cell):
    wl = harness.workload(cell)
    got = calibrate.readings(cell, 2**31 + 29, 5.0)
    lim = wl["check"]
    for name, v in got["checks"].items():
        assert v <= lim[name], (name, v)
    if "control_check" in got:
        assert any(v > lim[n] for n, v in got["control_check"].items())
        assert any(v > lim[n] for n, v in got["half_batch_check"].items())
    else:
        assert got["check"]["control_mean"] > lim["mean_logit_gap"]
