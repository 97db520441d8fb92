"""InternVL2-1B — InternViT vision encoder (stub) + Qwen2-0.5B-class LM
backbone (24L, d 896, 14H/2KV). [arXiv:2404.16821]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    attention="gqa",
    qkv_bias=True,
    activation="silu",
    rope_theta=1e6,
    frontend="vision_stub",
    frontend_prefix=256,   # patch embeddings per image tile
    source="arXiv:2404.16821",
)
