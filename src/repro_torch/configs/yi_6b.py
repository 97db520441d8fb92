"""Yi-6B — llama-arch GQA (32H/4KV). [arXiv:2403.04652]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    attention="gqa",
    activation="silu",
    rope_theta=5e6,
    source="arXiv:2403.04652",
)
