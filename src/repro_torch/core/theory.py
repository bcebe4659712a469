"""Executable certificates of the paper's guarantees (Lemmas 1-3, Theorems
1-2).

Port of ``repro.core.theory``. Each ``check_*`` returns a dict of the
quantities involved and raises ``AssertionError`` when the proven inequality
is violated (``check_lemma3`` and ``check_theorem2`` report instead under
``strict=False``). Lemmas 2 and 3 charge prefix traffic per core, so they
need the schedule's ``assignment``: ``scheduler.run``, ``online.run_online``
and ``engine.schedule_all_cores`` set it, ``engine.run_fast`` does not.

The sums are numpy fp64 on host copies, in the reference's order: each
coflow's demand through ``Instance.host_demand`` (one copy of the stack),
the CCTs, weights and flow records once each. So every number in every
returned dict (pairs, violations, ratios, bounds) is the reference's; the
arrays of Lemma 1's dict are tensors on the instance's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .assignment import Assignment, _host_f64
from .coflow import Instance
from .scheduler import Schedule

__all__ = [
    "gamma_w",
    "check_lemma1",
    "check_lemma2",
    "check_lemma3",
    "check_theorem1",
    "check_theorem2",
]


# The reference's numpy reductions over host matrices: the prefix sums of
# Lemmas 2-3 are built on the host in the reference's order, so these, not
# the device versions of ``coflow`` and ``lower_bounds``, reduce them.

def _rho(D: np.ndarray) -> float:
    """Max row or column sum of a host matrix."""
    if D.size == 0:
        return 0.0
    return float(max(D.sum(axis=1).max(), D.sum(axis=0).max()))


def _tau(D: np.ndarray) -> int:
    """Max number of nonzero entries in any row or column."""
    nz = D > 0
    if nz.size == 0:
        return 0
    return int(max(nz.sum(axis=1).max(), nz.sum(axis=0).max()))


def _per_core_lb(D: np.ndarray, rate: float, delta: float) -> float:
    """T_LB^k of a host matrix on a core of rate ``rate`` (Eq. 1)."""
    if D.size == 0 or not (D > 0).any():
        return 0.0
    nz = D > 0
    li = D.sum(axis=1) / rate + nz.sum(axis=1) * delta
    lj = D.sum(axis=0) / rate + nz.sum(axis=0) * delta
    return float(max(li.max(), lj.max()))


def _global_lbs(inst: Instance) -> np.ndarray:
    """T_LB(D_m) = delta + rho_m / R per coflow (Lemma 1; 0 for an all-zero
    coflow), by original id."""
    R = inst.R
    out = []
    for m in range(inst.M):
        D = inst.host_demand(m)
        out.append(0.0 if D.size == 0 or not (D > 0).any()
                   else float(inst.delta + _rho(D) / R))
    return np.array(out)


def gamma_w(weights: torch.Tensor | np.ndarray) -> float:
    """Weight concentration Gamma_w = M * sum(w^2) / (sum w)^2."""
    w = _host_f64(weights)
    return float(len(w) * (w**2).sum() / (w.sum() ** 2))


def _require_assignment(s: Schedule) -> Assignment:
    """Lemmas 2/3 need the per-coflow ``AssignedFlow`` lists, which the flat
    engine path does not build: fail with directions rather than an
    AttributeError."""
    if s.assignment is None:
        raise ValueError(
            "this certificate needs Schedule.assignment, which the flat "
            "engine path does not materialize; build the schedule via "
            "scheduler.run or engine.schedule_all_cores instead")
    return s.assignment


def check_lemma1(s: Schedule) -> dict:
    """T_m >= T_LB(D_m) = delta + rho_m / R for every coflow (any feasible
    schedule)."""
    inst = s.inst
    lbs = _global_lbs(inst)
    ccts = _host_f64(s.ccts)
    ok = ccts + 1e-9 >= lbs
    # Zero-demand coflows have LB 0 and CCT 0.
    if not ok.all():
        bad = np.nonzero(~ok)[0]
        raise AssertionError(
            f"Lemma 1 violated for coflows {bad}: cct={ccts[bad]} "
            f"lb={lbs[bad]}")
    return {"ccts": s.ccts, "lbs": torch.from_numpy(lbs).to(inst.device)}


def _prefix_bounds(s: Schedule, a: Assignment):
    """Per position m of pi: ``(m, max_k T_LB^k(D^k_{1:m}), D_{1:m})``, the
    prefix sums built in the reference's order (the aggregate is yielded
    live and must not be kept)."""
    inst = s.inst
    pi = s.pi.tolist()
    rates = inst.rates.tolist()
    prefix = np.zeros((inst.K, inst.N, inst.N))
    agg = np.zeros((inst.N, inst.N))
    for m_pos in range(inst.M):
        for af in a.flows[m_pos]:
            prefix[af.core, af.flow.i, af.flow.j] += af.flow.size
        agg += inst.host_demand(pi[m_pos])
        lb = max(_per_core_lb(prefix[k], rates[k], inst.delta)
                 for k in range(inst.K))
        yield m_pos, lb, agg


def check_lemma2(s: Schedule) -> dict:
    """max_k T_LB^k(D^k_{1:m}) <= rho_{1:m}/r_max + tau_{1:m}*delta for every
    m. Guaranteed only for the tau-aware assignment ('ours',
    'sunflow-core')."""
    inst, a = s.inst, _require_assignment(s)
    r_max = inst.r_max
    out = []
    for m_pos, lhs, agg in _prefix_bounds(s, a):
        rhs = _rho(agg) / r_max + _tau(agg) * inst.delta
        out.append((lhs, rhs))
        if lhs > rhs + 1e-6:
            raise AssertionError(
                f"Lemma 2 violated at m={m_pos}: {lhs} > {rhs}")
    return {"pairs": out}


def check_lemma3(s: Schedule, *, strict: bool = True) -> dict:
    """T_pi(m) <= 2 * max_k T_LB^k(D^k_{1:m}) for the work-conserving
    scheduler.

    The reference's reproduction finding: the literal non-preemptive policy
    lets lower-priority flows occupy ports the proof charges to prefix
    traffic only, so the inequality fails once coflows interleave (it holds
    for single coflows); Theorem 1's bound, with its 2*M*psi slack, still
    holds. ``strict=False`` returns the violations instead of raising.
    """
    inst, a = s.inst, _require_assignment(s)
    t_pos = np.zeros(inst.M)  # completion per coflow position
    np.maximum.at(t_pos, s.pos.cpu().numpy(), _host_f64(s.t_complete))
    pairs = []
    violations = []
    for m_pos, lb, _agg in _prefix_bounds(s, a):
        bound = 2 * lb
        pairs.append((t_pos[m_pos], bound))
        if t_pos[m_pos] > bound + 1e-6:
            violations.append((m_pos, float(t_pos[m_pos]), float(bound)))
    if strict and violations:
        raise AssertionError(
            f"Lemma 3 violated at (m, T, bound): {violations[:5]}")
    return {"pairs": pairs, "violations": violations}


def _weighted(s: Schedule) -> tuple[np.ndarray, float, float]:
    """``(w, sum w*T, sum w*T_LB)`` on the host."""
    w = _host_f64(s.inst.weights)
    lhs = float((w * _host_f64(s.ccts)).sum())
    denom = float((w * _global_lbs(s.inst)).sum())
    return w, lhs, denom


def check_theorem1(s: Schedule) -> dict:
    """sum w T <= 2 M (w_max/w_min) psi * sum w T_LB (stronger than vs
    OPT). Coflows with zero demand contribute 0 to both sides."""
    inst = s.inst
    w, lhs, denom = _weighted(s)
    ratio_bound = 2 * inst.M * (w.max() / w.min()) * inst.psi
    if denom > 0 and lhs > ratio_bound * denom + 1e-6:
        raise AssertionError(
            f"Theorem 1 violated: {lhs} > {ratio_bound} * {denom}")
    return {"alg": lhs, "lb_sum": denom, "bound": ratio_bound,
            "empirical_ratio": lhs / denom if denom > 0 else float("nan")}


def check_theorem2(s: Schedule, *, strict: bool = True) -> dict:
    """sum w T <= 2 psi Gamma_w * sum w T_LB (the appendix refinement,
    Eq. 41).

    The reference's reproduction finding: with equal weights Gamma_w = 1
    and the bound is M-independent, yet M identical coflows on one core
    finish at 1..M times their bound, so it cannot hold in general.
    ``strict=False`` reports instead of raising.
    """
    inst = s.inst
    w, lhs, denom = _weighted(s)
    bound = 2 * inst.psi * gamma_w(w)
    if strict and denom > 0 and lhs > bound * denom + 1e-6:
        raise AssertionError(f"Theorem 2 violated: {lhs} > {bound} * {denom}")
    return {"alg": lhs, "lb_sum": denom, "bound": bound,
            "empirical_ratio": lhs / denom if denom > 0 else float("nan")}
