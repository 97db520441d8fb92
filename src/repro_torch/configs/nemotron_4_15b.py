"""Nemotron-4 15B — GQA (48H/8KV), squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    attention="gqa",
    activation="sq_relu",
    rope_theta=1e4,
    source="arXiv:2402.16819",
)
