"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
without sparsity, at the full 700 W): every share of a peak or of a
roofline is taken against these, with the card's power limit reported
beside it."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
