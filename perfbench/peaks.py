"""The chip's peak memory bandwidth and the bytes the roofline shares count.

NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 bandwidth.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12

#: Bytes one flow moves through the assignment, each read or written once:
#: ingress and egress port (int32), size (fp32) in, the core choice (int32)
#: out.
ASSIGN_BYTES_PER_FLOW = 16


def assign_bytes(n_flows: int) -> int:
    """Bytes an assignment of ``n_flows`` flows must move."""
    return ASSIGN_BYTES_PER_FLOW * int(n_flows)


def bytes_bound_s(n_bytes: float) -> float:
    """The least time the chip's memory can move ``n_bytes`` in."""
    return n_bytes / H100_HBM_BYTES_PER_S
