"""The host oracle of the assignment kernel (port of ``repro.kernels.ref``'s
``assign_ref``).

:func:`assign_ref` is the tau-aware greedy assignment in numpy with fp64
state, whatever the inputs' dtype: given the kernel's fp32-cast inputs it is
what the kernel computes, with the kernel's fp32 accumulation replaced by
fp64. It mirrors ``core.lower_bounds.CoreState`` and is the third
implementation of ``engine.cross_check``'s assignment gate. It is not the
kernel's plain version (``coflow_assign.coflow_assign_plain``), which is the
kernel's fp32 twin.
"""
from __future__ import annotations

import numpy as np

__all__ = ["assign_ref"]


def assign_ref(
    fi: np.ndarray,     # (F,) ingress ports, in global flow order
    fj: np.ndarray,     # (F,) egress ports
    sizes: np.ndarray,  # (F,)
    rates: np.ndarray,  # (K,)
    delta: float,
    n_ports: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Oracle of the tau-aware greedy assignment (Alg. 1 lines 5-17) over
    host arrays.

    Returns ``(choices (F,) int32, final per-core bounds (K,))``; argmin
    ties go to the lowest core.
    """
    K = len(rates)
    row_load = np.zeros((K, n_ports))
    col_load = np.zeros((K, n_ports))
    row_tau = np.zeros((K, n_ports))
    col_tau = np.zeros((K, n_ports))
    nz = np.zeros((K, n_ports, n_ports), bool)
    bound = np.zeros(K)
    choices = np.zeros(len(fi), np.int32)
    for t in range(len(fi)):
        i, j, d = int(fi[t]), int(fj[t]), float(sizes[t])
        new = ~nz[:, i, j]
        li = (row_load[:, i] + d) / rates + (row_tau[:, i] + new) * delta
        lj = (col_load[:, j] + d) / rates + (col_tau[:, j] + new) * delta
        cand = np.maximum(bound, np.maximum(li, lj))
        kstar = int(np.argmin(cand))
        choices[t] = kstar
        if not nz[kstar, i, j]:
            nz[kstar, i, j] = True
            row_tau[kstar, i] += 1
            col_tau[kstar, j] += 1
        row_load[kstar, i] += d
        col_load[kstar, j] += d
        li_k = row_load[kstar, i] / rates[kstar] + row_tau[kstar, i] * delta
        lj_k = col_load[kstar, j] / rates[kstar] + col_tau[kstar, j] * delta
        bound[kstar] = max(bound[kstar], li_k, lj_k)
    return choices, bound
