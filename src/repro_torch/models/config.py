"""Architecture configuration for the assigned model families."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One decoder architecture. Every assigned arch is an instance; reduced
    smoke variants are produced with :meth:`reduced`."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention
    attention: str = "gqa"        # gqa | mla | none | hybrid
    qkv_bias: bool = False
    rope_theta: float = 1e6
    #: window used by the sub-quadratic long-context decode variant; 0 = full
    sliding_window: int = 4096
    activation: str = "silu"      # silu | sq_relu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA (MiniCPM3 / DeepSeek-style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0        # per-head rope sub-dim for MLA
    v_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4

    # modality frontend ("stub": input_specs provides embeddings directly)
    frontend: str = "none"        # none | vision_stub | audio_stub
    #: number of prefix embedding positions supplied by the frontend stub
    frontend_prefix: int = 0

    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    #: store the GQA KV cache in int8 with per-(slot, kv-head) scales —
    #: halves decode's dominant HBM term (see EXPERIMENTS.md §Perf)
    kv_quant: bool = False
    source: str = ""              # citation

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.attention == "none"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode with bounded memory/compute?
        SSM/hybrid natively; attention archs via the sliding-window variant
        (enabled for all of them — recorded in DESIGN.md)."""
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attention in ("gqa", "hybrid"):
            per_layer += d * self.q_dim + self.q_dim * d + 2 * d * self.kv_dim
        if self.attention == "mla":
            qd = self.q_lora_rank or d
            per_layer += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * (
                self.head_dim + self.rope_head_dim)
            per_layer += d * (self.kv_lora_rank + self.rope_head_dim)
            per_layer += self.kv_lora_rank * self.num_heads * (
                self.head_dim + self.v_head_dim)
            per_layer += self.num_heads * self.v_head_dim * d
            del qd
        if self.attention in ("none", "hybrid"):  # ssm branch
            dint = self.d_model * self.ssm_expand
            per_layer += d * dint * 3 + dint * d
        n_mats = 3 if self.activation == "silu" else 2  # gated vs plain MLP
        if self.is_moe:
            per_layer += d * self.num_experts  # router
            per_layer += self.num_experts * 3 * d * self.moe_d_ff
        else:
            per_layer += n_mats * d * self.d_ff
        return n + per_layer * L

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        dense = self.param_count()
        moe_all = self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        moe_act = self.num_layers * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        return dense - moe_all + moe_act

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model<=512, <=4-expert smoke variant of the family."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(4, self.num_heads or 2))
        kv = max(1, min(heads, self.num_kv_heads or heads))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=0 if self.attn_free else heads,
            num_kv_heads=0 if self.attn_free else kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.is_moe else 0,
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            rope_head_dim=min(self.rope_head_dim, 16),
            v_head_dim=hd if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16),
            sliding_window=min(self.sliding_window, 64),
            frontend_prefix=min(self.frontend_prefix, 8),
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}
