"""Global coflow ordering (Alg. 1 lines 1-4): WSPT on the global lower bound.

Port of ``repro.core.ordering``, batched over all coflows on the device.
"""
from __future__ import annotations

import torch

from .coflow import Instance, col_loads, row_loads

__all__ = ["order_coflows", "priority_scores"]


def priority_scores(inst: Instance) -> torch.Tensor:
    """s_m = w_m / T_LB(D_m), with T_LB(D_m) = delta + rho_m / R; ``(M,)``.

    An all-zero coflow has LB 0; it completes instantly, so its priority is
    +inf.
    """
    D = inst.demand
    if inst.M == 0 or inst.N == 0:
        return torch.full((inst.M,), float("inf"), dtype=torch.float64,
                          device=inst.device)
    rho_m = torch.maximum(row_loads(D).amax(dim=1), col_loads(D).amax(dim=1))
    lbs = torch.where((D > 0).flatten(1).any(dim=1),
                      inst.delta + rho_m / inst.R, 0.0)
    return torch.where(lbs > 0, inst.weights / lbs.clamp_min(1e-300),
                       float("inf"))


def order_coflows(inst: Instance) -> torch.Tensor:
    """Permutation pi ``(M,)``: coflows in non-increasing score order, ties
    broken by original index (stable sort on -score)."""
    return torch.argsort(-priority_scores(inst), stable=True)
