"""Lower bounds of Section IV-A (port of ``repro.core.lower_bounds``).

Per-core lower bound (Eq. 1):
    T_LB^k(D) = max_p ( load_p / r^k + tau_p * delta )
over all ingress rows and egress columns p of D.

Global lower bound (Eq. 2 / Lemma 1):
    T_LB(D) = delta + rho(D) / R.

The incremental per-core state (``CoreState``) is not ported: on the port the
assignment kernel keeps that state itself.
"""
from __future__ import annotations

import torch

from .coflow import col_loads, rho, row_loads

__all__ = ["per_core_lb", "global_lb"]


def per_core_lb(D: torch.Tensor, rate: float, delta: float) -> float:
    """T_LB^k of an ``(N, N)`` demand on a core with per-port rate ``rate``."""
    if D.numel() == 0 or not bool((D > 0).any()):
        return 0.0
    nz = D > 0
    li = row_loads(D) / rate + nz.sum(dim=1).to(D.dtype) * delta
    lj = col_loads(D) / rate + nz.sum(dim=0).to(D.dtype) * delta
    return float(torch.maximum(li.max(), lj.max()))


def global_lb(D: torch.Tensor, R: float, delta: float) -> float:
    """Assignment-independent global lower bound T_LB(D) = delta + rho/R."""
    if D.numel() == 0 or not bool((D > 0).any()):
        return 0.0
    return float(delta + rho(D) / R)
