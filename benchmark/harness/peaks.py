"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BYTES_PER_S = 3.35e12       # HBM3
TF32_FLOPS = 495e12         # tensor cores, TF32: the ceiling of any float32 product
F32_FLOPS = 67e12           # float32 outside the tensor cores
BF16_FLOPS = 989e12         # tensor cores, bf16
