"""Qwen2.5-3B — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    activation="silu",
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)
