"""A flat schedule of every flow on every core, and the paper's CCT metrics.

Port of ``repro.core.scheduler``'s ``Schedule`` and metrics. The reference
keeps one ``ScheduledFlow`` object per flow; here a schedule is a set of
``(F,)`` tensors on the instance's device, in the reference's row order:
core-major, priority order within each core.

The metrics reduce the ``(M,)`` CCTs on the host with numpy, as the
reference does (one small copy): ``torch.sum`` and ``torch.quantile`` round
in another order, and these are the numbers the reference's tools diff.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coflow import Instance

__all__ = ["ALGORITHMS", "Schedule", "weighted_cct", "weighted_sum",
           "tail_quantile", "tail_cct"]

#: The paper's algorithm and the four baselines of its ablation.
ALGORITHMS = ("ours", "rho-assign", "rand-assign", "sunflow-core",
              "rand-sunflow")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A complete schedule plus per-coflow CCTs.

    Row f is one flow: coflow position ``pos[f]`` in ``pi`` (original id
    ``cid[f]``), ports ``(fi[f], fj[f])`` on core ``core[f]``, ``size[f]``
    bytes, its circuit established at ``t_establish[f]``, transmitting from
    ``t_start[f]`` and done at ``t_complete[f]``. ``ccts`` ``(M,)`` is
    indexed by original coflow order.
    """

    inst: Instance
    pi: torch.Tensor           # (M,) int64
    pos: torch.Tensor          # (F,) int64
    cid: torch.Tensor          # (F,) int64
    fi: torch.Tensor           # (F,) int64
    fj: torch.Tensor           # (F,) int64
    core: torch.Tensor         # (F,) int64
    size: torch.Tensor         # (F,) float64
    t_establish: torch.Tensor  # (F,) float64
    t_start: torch.Tensor      # (F,) float64
    t_complete: torch.Tensor   # (F,) float64
    ccts: torch.Tensor         # (M,) float64

    @property
    def n_flows(self) -> int:
        return int(self.pos.shape[0])

    @property
    def total_weighted_cct(self) -> float:
        return weighted_sum(self.inst.weights, self.ccts)


def _host(x: torch.Tensor | np.ndarray) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def weighted_sum(weights: torch.Tensor | np.ndarray,
                 ccts: torch.Tensor | np.ndarray) -> float:
    """``sum_m w_m * CCT_m`` reduced by numpy on host copies, the
    reference's floats."""
    return float((_host(weights) * _host(ccts)).sum())


def weighted_cct(s: Schedule) -> float:
    """sum_m w_m * CCT_m, the paper's objective."""
    return s.total_weighted_cct


def tail_quantile(ccts: torch.Tensor | np.ndarray, q: float) -> float:
    """q-quantile (``np.quantile``'s linear interpolation) of per-coflow
    CCTs; 0.0 for an empty instance."""
    ccts = _host(ccts)
    if ccts.size == 0:
        return 0.0
    return float(np.quantile(ccts, q))


def tail_cct(s: Schedule, q: float) -> float:
    """q-quantile of per-coflow CCTs (q=0.95 / 0.99 for the paper's tails)."""
    return tail_quantile(s.ccts, q)
