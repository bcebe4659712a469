"""Lower bounds of Section IV-A (port of ``repro.core.lower_bounds``).

Per-core lower bound (Eq. 1):
    T_LB^k(D) = max_p ( load_p / r^k + tau_p * delta )
over all ingress rows and egress columns p of D.

Global lower bound (Eq. 2 / Lemma 1):
    T_LB(D) = delta + rho(D) / R.

:class:`CoreState` is the incremental per-core prefix state of the
reference's dataclass assignment oracles (``assignment.assign_tau_aware``
and its baselines): host numpy fp64, expression for expression the
reference's, so the oracles' choices and final bounds are the reference's
bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coflow import col_loads, rho, row_loads

__all__ = ["per_core_lb", "global_lb", "CoreState"]


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


@dataclasses.dataclass
class CoreState:
    """Incremental prefix state of the assignment phase (Alg. 1 lines 5-17).

    Per core k: row/col loads and tau counts of the prefix matrix
    ``D^k_{1:m}``, the nonzero mask (tau grows only on the first traffic of
    an (i, j) on that core) and the running bound ``T_LB^k(D^k_{1:m})``.
    Row i and column j only grow, so a flow's candidate bound is
    ``max(old_bound, new_L_i, new_L_j)``. ``rates`` may be a tensor on any
    device or an array-like; the state is host numpy.
    """

    K: int
    N: int
    rates: np.ndarray
    delta: float
    row_load: np.ndarray = dataclasses.field(init=False)  # (K, N)
    col_load: np.ndarray = dataclasses.field(init=False)  # (K, N)
    row_tau: np.ndarray = dataclasses.field(init=False)   # (K, N) int64
    col_tau: np.ndarray = dataclasses.field(init=False)   # (K, N) int64
    nz: np.ndarray = dataclasses.field(init=False)        # (K, N, N) bool
    bound: np.ndarray = dataclasses.field(init=False)     # (K,)

    def __post_init__(self) -> None:
        if isinstance(self.rates, torch.Tensor):
            self.rates = self.rates.detach().cpu().numpy()
        self.rates = np.asarray(self.rates, dtype=np.float64)
        self.row_load = np.zeros((self.K, self.N))
        self.col_load = np.zeros((self.K, self.N))
        self.row_tau = np.zeros((self.K, self.N), dtype=np.int64)
        self.col_tau = np.zeros((self.K, self.N), dtype=np.int64)
        self.nz = np.zeros((self.K, self.N, self.N), dtype=bool)
        self.bound = np.zeros(self.K)

    def candidate_bounds(self, i: int, j: int, d: float) -> np.ndarray:
        """T_LB^k(D^k_{1:m} ⊕ d) for every core k, vectorized over k."""
        new_entry = ~self.nz[:, i, j]
        li = (self.row_load[:, i] + d) / self.rates \
            + (self.row_tau[:, i] + new_entry) * self.delta
        lj = (self.col_load[:, j] + d) / self.rates \
            + (self.col_tau[:, j] + new_entry) * self.delta
        return np.maximum(self.bound, np.maximum(li, lj))

    def candidate_rho_bounds(self, i: int, j: int, d: float) -> np.ndarray:
        """rho^k_{1:m}(after ⊕ d) / r^k for every core: the tau-blind
        RHO-ASSIGN metric."""
        li = self.row_load[:, i] + d
        lj = self.col_load[:, j] + d
        cur = np.maximum(self.row_load.max(axis=1), self.col_load.max(axis=1))
        return np.maximum(cur, np.maximum(li, lj)) / self.rates

    def assign(self, i: int, j: int, d: float, k: int) -> None:
        """Commit flow (i, j, d) to core k and refresh the state."""
        if not self.nz[k, i, j]:
            self.nz[k, i, j] = True
            self.row_tau[k, i] += 1
            self.col_tau[k, j] += 1
        self.row_load[k, i] += d
        self.col_load[k, j] += d
        li = self.row_load[k, i] / self.rates[k] + self.row_tau[k, i] * self.delta
        lj = self.col_load[k, j] / self.rates[k] + self.col_tau[k, j] * self.delta
        self.bound[k] = max(self.bound[k], li, lj)

    def max_bound(self) -> float:
        return float(self.bound.max())
