"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit). Rooflines are shares of these; each traced run
prints the card's power limit beside them."""

PEAK_FP32_FLOPS = 67e12  # f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # HBM3, bytes/s
