"""Target-hardware constants of the port: one NVIDIA H100 SXM (80 GB HBM3),
from NVIDIA's published data sheet. Dense (no sparsity) tensor-core peak
for bf16; the fp32 peak is the CUDA cores' (no TF32). ``NVLINK_BW`` is
the data sheet's NVLink 4 bandwidth, 900 GB/s summed over both
directions, taken per direction: what one card can send, the divisor of
the roofline's collective term (the reference divides by its TPU's ICI
link rate there)."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s per card
PEAK_FLOPS_FP32 = 67e12  # FLOP/s per card
HBM_BW = 3.35e12  # B/s per card
HBM_BYTES = 80e9  # bytes per card
NVLINK_BW = 450e9  # B/s per card, one direction (900 GB/s both ways)
