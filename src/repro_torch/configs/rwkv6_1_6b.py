"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    activation="sq_relu",   # rwkv channel mix uses squared relu
    ssm_state=64,           # wkv head size
    source="arXiv:2404.05892",
)
