"""The card's peaks that shares are stated against: NVIDIA's data sheet
for the H100 SXM (dense rates, no sparsity), at its full power limit of
700 W; the run prints the card's own limit."""

BF16_FLOPS = 989e12      # dense bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12       # fp32 outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes per second
