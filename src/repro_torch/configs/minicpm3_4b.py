"""MiniCPM3-4B — multi-head latent attention (MLA). [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,          # qk nope head dim
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    activation="silu",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    v_head_dim=64,
    rope_theta=1e4,
    source="hf:openbmb/MiniCPM3-4B",
)
