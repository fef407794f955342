"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit). Every share of a peak or a roofline in the
benchmark divides by these; the run states the card's power limit beside
them."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores, an FMA counted as two
HBM_BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9
