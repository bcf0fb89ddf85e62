"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at its
700 W limit: the yardstick of every roofline and MFU share."""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12

FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "float32": FP32_FLOPS}


def least_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES)
