"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit).  A reading against them is stated with the
card's own power limit beside it."""

BF16_FLOPS = 989.0e12
TF32_FLOPS = 495.0e12
FP32_FLOPS = 67.0e12
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80.0e9
