"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).

Frozen copy of ``chip_smoke.py:321-323`` at commit 090937a. A card set
below 700 W reaches less; the run prints the card's power limit beside
every share of these peaks.
"""

HBM_BYTES_PER_S = 3.35e12            # device memory bandwidth
BF16_FLOP_PER_S = 989e12             # dense bf16 tensor-core rate
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 132 SMs x 64 INT32 lanes x boost
