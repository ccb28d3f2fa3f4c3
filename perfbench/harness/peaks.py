"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit): a frozen copy of the
numbers in ``repro_torch/roofline/hw.py``."""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 / fp16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12      # bytes/s, HBM3
HBM_CAPACITY = 80e9           # bytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_HBM_BYTES)
