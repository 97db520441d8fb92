"""MusicGen-medium — decoder-only over EnCodec tokens; the EnCodec frontend
is a stub (input_specs supplies frame embeddings). [arXiv:2306.05284]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    attention="gqa",
    activation="gelu",
    rope_theta=1e4,
    frontend="audio_stub",
    frontend_prefix=0,
    source="arXiv:2306.05284",
)
