"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A share of a
roofline or of a peak is stated against these, with the card's power
limit beside it."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_S = 3.35e12
#: tensor-core rates, operations a second
BF16_FLOPS = 989e12
#: float32 on the FMA units (no TF32)
F32_FLOPS = 67e12

#: the peak of a model's arithmetic, by the type its configuration states
FLOPS_BY_DTYPE = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}


def bound_s(nbytes: float, ops: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at ``flops``."""
    return max(nbytes / HBM_BYTES_S, ops / flops)
