"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, no sparsity, at the full 700 W power limit)."""

BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12
FP32_FLOP_S = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, flop_s: float = BF16_FLOP_S) -> float:
    """The least time the card needs: the slower of its compute and its
    memory at their peaks."""
    return max(flops / flop_s, nbytes / HBM_BYTES_S)
