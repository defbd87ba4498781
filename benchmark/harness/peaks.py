"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit): the denominators of every roofline and mfu."""
BF16_FLOPS = 989e12          # FLOP/s, bf16 / fp16 tensor cores, dense
HBM_BYTES = 3.35e12          # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
