"""Qwen3-MoE 235B-A22B — 128 experts, top-8. [hf:Qwen/Qwen3-30B-A3B scaled
per assignment: 94L, d_model 4096, 64 q heads / 4 kv, moe d_ff 1536,
vocab 151936]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    attention="gqa",
    activation="silu",
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
