"""A flat schedule of every flow on every core, and the paper's CCT metrics.

Port of ``repro.core.scheduler``'s ``Schedule`` and metrics. The reference
keeps one ``ScheduledFlow`` object per flow; here a schedule is a set of
``(F,)`` tensors on the instance's device, in the reference's row order:
core-major, priority order within each core.

The metrics reduce the ``(M,)`` CCTs on the host with numpy, as the
reference does (one small copy): ``torch.sum`` and ``torch.quantile`` round
in another order, and these are the numbers the reference's tools diff.

:func:`run` is the reference's oracle pipeline (``repro.core.scheduler.run``):
the dataclass assignment of ``assignment`` and the per-core event loops of
``circuit_scheduler``, kept deliberately simple as the second implementation
``engine.cross_check`` holds the engine to. It returns the same flat
``Schedule`` as the engine, converted once from the loops'
``ScheduledFlow`` records, with ``assignment`` set (the theory certificates
need it); :func:`scheduled_flows` gives the records of any flat schedule.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import torch

from .assignment import (Assignment, assign_random, assign_rho_only,
                         assign_tau_aware)
from .circuit_scheduler import (ScheduledFlow, schedule_core_list,
                                schedule_core_reserving,
                                schedule_core_sunflow)
from .coflow import Instance
from .ordering import order_coflows

__all__ = ["ALGORITHMS", "Schedule", "run", "scheduled_flows",
           "weighted_cct", "weighted_sum", "tail_quantile", "tail_cct"]

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
    indexed by original coflow order. ``assignment`` is ``None`` on the
    engine's flat path (``engine.run_fast``); :func:`run`, ``online.
    run_online`` and ``engine.schedule_all_cores`` set it.
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
    assignment: Assignment | None = None

    @property
    def n_flows(self) -> int:
        return int(self.pos.shape[0])

    @property
    def total_weighted_cct(self) -> float:
        return weighted_sum(self.inst.weights, self.ccts)


_INT_COLS = (("pos", "coflow"), ("cid", "cid"), ("fi", "i"), ("fj", "j"),
             ("core", "core"))
_FLOAT_COLS = (("size", "size"), ("t_establish", "t_establish"),
               ("t_start", "t_start"), ("t_complete", "t_complete"))


def scheduled_flows(s: Schedule) -> list[ScheduledFlow]:
    """The reference's per-flow records of a flat schedule, in row order."""
    cols = [getattr(s, c).tolist() for c, _ in _INT_COLS + _FLOAT_COLS]
    return [ScheduledFlow(coflow=p, cid=c, i=i, j=j, core=k, size=z,
                          t_establish=te, t_start=ts, t_complete=tc)
            for p, c, i, j, k, z, te, ts, tc in zip(*cols)]


def _flat_schedule(inst: Instance, pi: torch.Tensor,
                   assignment: Assignment | None,
                   flows: list[ScheduledFlow]) -> Schedule:
    """A flat ``Schedule`` of ``ScheduledFlow`` records, rows in their
    order, on the instance's device. The CCTs are the reference's: per
    original coflow id, the max completion of its flows."""
    dev = inst.device
    pi = torch.as_tensor(pi, dtype=torch.int64, device=dev)
    pi_h = pi.tolist()
    ccts = np.zeros(inst.M)
    for f in flows:
        orig = pi_h[f.coflow]
        ccts[orig] = max(ccts[orig], f.t_complete)
    cols = {c: torch.tensor([getattr(f, a) for f in flows],
                            dtype=torch.int64, device=dev)
            for c, a in _INT_COLS}
    cols.update({c: torch.tensor([getattr(f, a) for f in flows],
                                 dtype=torch.float64, device=dev)
                 for c, a in _FLOAT_COLS})
    return Schedule(inst=inst, pi=pi, ccts=torch.from_numpy(ccts).to(dev),
                    assignment=assignment, **cols)


def _schedule_from_assignment(inst: Instance, pi: torch.Tensor,
                              assignment: Assignment,
                              percore: Callable) -> Schedule:
    """Each core's flows, in global priority order (coflow position in pi,
    then the intra-coflow assignment order), through ``percore``; rows
    core-major."""
    per_core: list[list] = [[] for _ in range(inst.K)]
    for coflow_flows in assignment.flows:
        for af in coflow_flows:
            per_core[af.core].append(af)
    rates = inst.rates.tolist()
    all_scheduled: list[ScheduledFlow] = []
    for k in range(inst.K):
        all_scheduled.extend(
            percore(per_core[k], k, rates[k], inst.delta, inst.N))
    return _flat_schedule(inst, pi, assignment, all_scheduled)


def run(
    inst: Instance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
) -> Schedule:
    """One of the named algorithms end to end, through the oracles.

    ``ours``          : Alg. 1 (tau-aware assignment + list scheduling)
    ``rho-assign``    : tau-blind assignment, same ordering/scheduling
    ``rand-assign``   : rate-proportional random assignment (PCG64 ``seed``)
    ``sunflow-core``  : Alg. 1 assignment, Sunflow per-core scheduling
    ``rand-sunflow``  : random assignment + Sunflow per-core scheduling

    ``scheduling`` is the intra-core policy of the first three:
    ``work-conserving`` (Alg. 1 lines 23-31 literally: any flow whose two
    ports are idle starts), ``priority-guard`` (pending higher-priority
    flows protect their port pairs) or ``reserving`` (strict in-order
    reservation). The result equals ``engine.run_fast(..., backend=
    "numpy")`` bit for bit, with ``assignment`` set.
    """
    percore = {
        "work-conserving": schedule_core_list,
        "priority-guard": partial(schedule_core_list, guard=True),
        "reserving": schedule_core_reserving,
    }[scheduling]
    pi = order_coflows(inst)
    if algorithm == "ours":
        a = assign_tau_aware(inst, pi)
    elif algorithm == "rho-assign":
        a = assign_rho_only(inst, pi)
    elif algorithm == "rand-assign":
        a = assign_random(inst, pi, seed=seed)
    elif algorithm == "sunflow-core":
        a, percore = assign_tau_aware(inst, pi), schedule_core_sunflow
    elif algorithm == "rand-sunflow":
        a, percore = assign_random(inst, pi, seed=seed), schedule_core_sunflow
    else:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {sorted(ALGORITHMS)}")
    return _schedule_from_assignment(inst, pi, a, percore)


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
