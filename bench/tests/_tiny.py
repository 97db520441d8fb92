"""Tiny configurations and cells of the benchmark's own for the CPU
tests: the published files with their widths cut, float32."""
import copy

from bench import harness


def qwen2(dtype="float32"):
    c = harness.config("qwen2.5-3b")
    c.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
             torch_dtype=dtype)
    c["port"].update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                     head_dim=16, d_ff=128, vocab_size=256, dtype=dtype)
    return c


def rwkv6():
    """Float32, where the port's in-place AdamW moves every leaf: in
    bfloat16 it drops the warm-up's updates (PERF.md, Open questions)."""
    c = harness.config("rwkv6-1.6b")
    c.update(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
             vocab_size=256, torch_dtype="float32")
    c["port"].update(num_layers=2, d_model=128, d_ff=256, vocab_size=256,
                     dtype="float32")
    return c


def serve_cell():
    wl = copy.deepcopy(harness.workload("qwen2.5-3b.serve-long"))
    wl.update(slots=4, clients=4, cache_len=96, block=4, pool=64,
              prompt_len={"kind": "log_uniform", "min": 16, "max": 64},
              max_new_tokens={"kind": "uniform", "min": 2, "max": 8},
              profile_seconds=0.2)
    # float32 on the CPU: the port and the reference agree to round-off,
    # so the served gap reads 0 up to it
    wl["check"] = {"sample_tokens": 24, "mean_logit_gap": 1e-3}
    return wl


def train_cell():
    """A training cell for ``drivers/train_steps.py``, which no cell of
    the benchmark runs yet: AdamW as the port's ``OptConfig`` defaults,
    three checked steps, the limits of its float32 readings on the card."""
    return {"name": "tiny-rwkv6.train", "config": "rwkv6-1.6b",
            "traffic": "train", "chips": 1, "driver": "train_steps",
            "batch": 2, "seq_len": 128, "microbatches": 1, "remat": True,
            "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                          "weight_decay": 0.1, "clip_norm": 1.0,
                          "warmup_steps": 100, "total_steps": 10000,
                          "min_lr_ratio": 0.1},
            "checked_steps": 3, "profile_steps": 1,
            "check": {"loss_gap": 2e-6, "grad_norm_gap": 8e-6,
                      "change_norm_gap": 3e-6}}


def run(wl, config, seed=2**31 + 11, seconds=0.5):
    import time
    r = harness.Run(cell=wl["name"], workload=wl, config=config, seed=seed,
                    seconds=seconds, trace=False,
                    t_start=time.perf_counter(), device="cpu")
    harness.driver(wl["driver"]).run(r)
    return r
