"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# int32 lane ORs have no published rate: the float32 rate stands in
ALU_OPS_PER_S = 67e12
