"""Public entry points of the port's kernels.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor runs
the kernel's plain PyTorch version. Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from .coflow_assign import coflow_assign_cuda, coflow_assign_plain

__all__ = ["coflow_assign"]


def coflow_assign(fi: torch.Tensor, fj: torch.Tensor, sizes: torch.Tensor,
                  rates: torch.Tensor, delta: float, *,
                  n_ports: int) -> torch.Tensor:
    """Tau-aware greedy assignment; per-flow core choices ``(F,)`` int32.

    Takes the flat flow tensors of ``core.coflow.extract_flows`` (any
    integer/float dtype; cast here to the kernel's int32/fp32) and the
    ``(K,)`` core rates, all on one device. The state accumulates in fp32,
    as in the Pallas kernel this replaces, so at large F a near-tie choice
    can differ from an fp64 oracle; both versions here give the same
    choices as the Pallas kernel.
    """
    dev = fi.device
    args = (fi.to(torch.int32).contiguous(), fj.to(torch.int32).contiguous(),
            sizes.to(torch.float32).contiguous(),
            rates.to(device=dev, dtype=torch.float32).contiguous())
    if dev.type == "cuda":
        return coflow_assign_cuda(*args, delta, n_ports=n_ports)
    if dev.type == "cpu":
        return coflow_assign_plain(*args, delta, n_ports=n_ports)
    raise ValueError(f"coflow_assign runs on cuda or cpu, not {dev.type}")
