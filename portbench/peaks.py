"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).

The exponential rate is the special-function units': 16 results a clock
an SM, 132 SMs, at the 1.98 GHz boost clock.
"""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9
