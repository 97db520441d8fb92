"""The frozen yardstick (bench/costs): each count follows from the model's
shapes alone, none from how a kernel cuts its work."""
import inspect

import pytest

from bench import harness
from bench.costs import flash, peaks, qwen2, rwkv6, wkv

from . import _tiny


def test_flash_count_is_the_causal_pair_formula_at_the_kv_heads():
    b, s, h, kv, d = 2, 37, 16, 2, 128
    pairs = sum(min(s, i + 1) for i in range(s))
    assert flash.causal_pairs(s) == pairs
    assert flash.forward_ops(b, s, h, d) == 4 * d * h * b * pairs
    assert flash.forward_bytes(b, s, h, kv, d, 2) == \
        2 * (2 * b * s * h * d + 2 * b * s * kv * d)
    # k and v at the model's 2 heads, not at the 16 a GQA copy gives them
    assert flash.forward_bytes(b, s, h, kv, d, 2) < \
        flash.forward_bytes(b, s, h, h, d, 2)
    bound = flash.forward_bound_s(b, s, h, kv, d, 2)
    assert bound == max(flash.forward_bytes(b, s, h, kv, d, 2)
                        / peaks.HBM_BYTES_S,
                        flash.forward_ops(b, s, h, d) / peaks.BF16_FLOPS)


def test_wkv_count_has_no_chunk_term():
    for fn in (wkv.forward_bytes, wkv.forward_ops, wkv.backward_bytes,
               wkv.backward_ops, wkv.forward_bound_s, wkv.backward_bound_s):
        assert list(inspect.signature(fn).parameters) == ["b", "s", "h", "d"]
    for s in (64, 100, 4096, 4111):
        assert wkv.forward_ops(1, s, 32, 64) == 4 * 64 * 64 * s * 32
        assert wkv.backward_ops(2, s, 32, 64) == 8 * 64 * 64 * 2 * s * 32
        # linear in the steps: no term per chunk or sub-chunk
        assert wkv.forward_bytes(1, 2 * s, 32, 64) - \
            wkv.forward_bytes(1, s, 32, 64) == 4 * 5 * s * 32 * 64


def _port_cfg(c):
    return harness.port_config(c)


def _count(cfg, shape):
    from repro_torch import sharding as SH
    from repro_torch.launch import dryrun, mesh as M, specs as SP
    mesh = M.make_host_mesh()
    with SH.axis_env(mesh, batch=dryrun.batch_axes_for(cfg, shape, mesh)):
        return dryrun.count_step(cfg, shape, mesh,
                                 SP.input_specs(cfg, shape))[0]


@pytest.mark.parametrize("s", [24, 64])
def test_serve_flops_match_the_dry_runs_count(s):
    """The dry run's FlopCounterMode counts a short prefill's attention
    over the whole (S, S) square, the model's FLOPs over the causal
    pairs; the rest agrees exactly."""
    from repro_torch.models.config import ShapeConfig
    c = _tiny.qwen2()
    got = _count(_port_cfg(c), ShapeConfig("t", s, 1, "prefill"))
    square = qwen2.attention_flops(c, s * s)
    assert got - square + qwen2.attention_flops(
        c, flash.causal_pairs(s)) == qwen2.prefill_flops(c, s)


def test_train_flops_match_the_dry_runs_count():
    """A train step with remat, counted by the dry run: 6·N a token, the
    recomputation of every layer up to its last product (the checkpoint
    stops once the backward has what it saves), attention's square four
    times (forward, recomputation, backward's two). The model's FLOPs
    leave the recomputation out and count the causal pairs."""
    from repro_torch.models.config import ShapeConfig
    c = _tiny.qwen2()
    b, s = 2, 32
    got = _count(_port_cfg(c), ShapeConfig("t", s, b, "train"))
    remat = (2 * c["num_hidden_layers"] * b * s
             * (qwen2.layer_matrix_params(c)
                - c["hidden_size"] * c["intermediate_size"]))
    assert got - remat - 4 * b * qwen2.attention_flops(c, s * s) \
        + 3 * b * qwen2.attention_flops(c, flash.causal_pairs(s)) \
        == qwen2.train_flops(c, b, s)


def test_rwkv6_train_flops_count_the_matrices_and_the_state_products():
    c = harness.config("rwkv6-1.6b")
    n = (24 * (6 * 2048 * 2048 + 2 * 2048 * 7168) + 2048 * 65536)
    assert rwkv6.train_flops(c, 2, 4096) == \
        6 * n * 8192 + 3 * 24 * 4 * 64 * 64 * 32 * 8192


def test_published_widths_and_the_port_block_agree():
    q = harness.config("qwen2.5-3b")
    p = q["port"]
    assert (p["num_layers"], p["d_model"], p["num_heads"],
            p["num_kv_heads"], p["d_ff"], p["vocab_size"]) == (
        q["num_hidden_layers"], q["hidden_size"], q["num_attention_heads"],
        q["num_key_value_heads"], q["intermediate_size"], q["vocab_size"])
    assert p["head_dim"] == qwen2.head_dim(q)
    assert p["tie_embeddings"] == q["tie_word_embeddings"]
    assert p["dtype"] == q["torch_dtype"]
    r = harness.config("rwkv6-1.6b")
    p = r["port"]
    assert (p["num_layers"], p["d_model"], p["head_dim"], p["d_ff"],
            p["vocab_size"], p["dtype"]) == (
        r["num_hidden_layers"], r["hidden_size"], r["head_size"],
        r["intermediate_size"], r["vocab_size"], r["torch_dtype"])
