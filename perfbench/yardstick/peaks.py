"""Published peaks of one NVIDIA H100 SXM (dense, without sparsity), at its
full 700 W power limit; a card set lower reads below them."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # HBM3 bytes per second
