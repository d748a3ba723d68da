"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  The benchmark
reports the card's power limit beside every run, since a card set below
700 W runs slower under load."""

#: HBM bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: float32 FLOP/s outside the tensor cores (every LDA kernel's arithmetic).
F32_FLOPS = 67e12


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S)
