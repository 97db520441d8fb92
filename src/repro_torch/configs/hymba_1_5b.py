"""Hymba-1.5B — hybrid: parallel attention + Mamba heads per block,
ssm_state 16. [arXiv:2411.13676]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attention="hybrid",
    activation="silu",
    ssm_state=16,
    ssm_expand=2,
    conv_kernel=4,
    sliding_window=1024,
    rope_theta=1e4,
    source="arXiv:2411.13676",
)
