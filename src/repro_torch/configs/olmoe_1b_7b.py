"""OLMoE-1B-7B — 64 experts, top-8, full MHA-as-GQA(kv=16).
[arXiv:2409.02060]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    attention="gqa",
    activation="silu",
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    rope_theta=1e4,
    source="arXiv:2409.02060",
)
