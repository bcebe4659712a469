"""Target-hardware constants of the port: one NVIDIA H100 SXM (80 GB HBM3),
from NVIDIA's published data sheet. Dense (no sparsity) tensor-core peak
for bf16; the fp32 peak is the CUDA cores' (no TF32)."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s per card
PEAK_FLOPS_FP32 = 67e12  # FLOP/s per card
HBM_BW = 3.35e12  # B/s per card
HBM_BYTES = 80e9  # bytes per card
