"""Independent feasibility referee for flat schedules, on the device.

Port of ``repro.core.simulator.validate``, with the same tolerances:
  1. port exclusivity — per core, busy intervals [t_establish, t_complete)
     never overlap on any ingress or egress port;
  2. not-all-stop timing — every flow starts transmitting exactly delta
     after establishment and lasts exactly size/rate (non-preemption);
  3. demand conservation — per coflow, the assigned sizes sum back to the
     demand matrix entry-wise;
  4. CCT consistency — reported CCTs equal the max completion over each
     coflow's flows;
  5. (online, when ``releases`` is given) release respect — no flow
     establishes before its coflow's release. Exact comparison: the
     scheduler starts flows only at event times >= the release float.
Every check is a tensor comparison on the schedule's device; a violation
raises ``AssertionError`` naming the first offending flow.
"""
from __future__ import annotations

import torch

import numpy as np

from .scheduler import Schedule

__all__ = ["validate"]

_EPS = 1e-6


def _describe(s: Schedule, f: int) -> str:
    return (f"flow(coflow={int(s.pos[f])}, cid={int(s.cid[f])}, "
            f"i={int(s.fi[f])}, j={int(s.fj[f])}, core={int(s.core[f])}, "
            f"size={float(s.size[f])!r}, t_establish="
            f"{float(s.t_establish[f])!r})")


def _first_bad(mask: torch.Tensor) -> int | None:
    hits = torch.nonzero(mask)
    return int(hits[0, 0]) if hits.numel() else None


def _check_exclusivity(s: Schedule, port: torch.Tensor, axis: str) -> None:
    """Sort-based interval overlap over merged (core, port) resources.

    After a stable sort by (resource, start, end), each interval may only
    overlap its in-resource successor, so one comparison of consecutive
    rows finds any violation.
    """
    rid = s.core * s.inst.N + port
    t_est, t_comp = s.t_establish, s.t_complete
    order = torch.argsort(t_comp, stable=True)
    order = order[torch.argsort(t_est[order], stable=True)]
    order = order[torch.argsort(rid[order], stable=True)]
    r = rid[order]
    same = r[1:] == r[:-1]
    overlap = same & (t_est[order][1:] < t_comp[order][:-1] - _EPS)
    at = _first_bad(overlap)
    if at is not None:
        a, b = int(order[at]), int(order[at + 1])
        raise AssertionError(
            f"port exclusivity violated on core {int(s.core[a])} "
            f"{'ingress' if axis == 'i' else 'egress'} port {int(port[a])}: "
            f"[{float(t_est[a])},{float(t_comp[a])}) overlaps "
            f"[{float(t_est[b])},...)")


def validate(s: Schedule,
             releases: torch.Tensor | np.ndarray | None = None,
             flow_delta: torch.Tensor | np.ndarray | None = None) -> None:
    """Raise ``AssertionError`` unless ``s`` is a feasible schedule of its
    instance with consistent CCTs.

    ``releases`` (``(M,)``, by original coflow id) adds the online check of
    release respect. ``flow_delta`` (per flow, aligned with the schedule's
    rows) overrides the uniform delay in the timing checks (drifted cores).
    """
    inst = s.inst
    dev = inst.device
    orig = s.pi[s.pos]
    if s.n_flows:
        # --- 5. release respect (online schedules) ------------------------
        if releases is not None:
            rel = torch.as_tensor(releases, dtype=torch.float64,
                                  device=dev)[orig]
            b = _first_bad(s.t_establish < rel)
            if b is not None:
                raise AssertionError(
                    f"{_describe(s, b)} establishes before coflow "
                    f"{int(orig[b])}'s release {float(rel[b])!r}")

        # --- 2. timing / non-preemption -----------------------------------
        dl = (inst.delta if flow_delta is None else torch.as_tensor(
            flow_delta, dtype=torch.float64, device=dev))
        b = _first_bad(s.t_establish < -_EPS)
        if b is not None:
            raise AssertionError(f"{_describe(s, b)} scheduled before t=0")
        b = _first_bad((s.t_start - (s.t_establish + dl)).abs() > _EPS)
        if b is not None:
            raise AssertionError(
                f"{_describe(s, b)} violates start = establish + delta")
        want = s.t_establish + dl + s.size / inst.rates[s.core]
        b = _first_bad((s.t_complete - want).abs() > _EPS)
        if b is not None:
            raise AssertionError(
                f"{_describe(s, b)} violates non-preemptive duration")

        # --- 1. port exclusivity ------------------------------------------
        _check_exclusivity(s, s.fi, "i")
        _check_exclusivity(s, s.fj, "j")

    # --- 3. demand conservation -------------------------------------------
    if inst.M:
        sent = torch.zeros_like(inst.demand)
        sent.index_put_((orig, s.fi, s.fj), s.size, accumulate=True)
        ok = torch.isclose(sent, inst.demand, atol=1e-6, rtol=1e-9)
        if not bool(ok.all()):
            bad = torch.nonzero(~ok)[:5].tolist()
            raise AssertionError(f"demand conservation violated at (m,i,j)={bad}")

    # --- 4. CCT consistency -----------------------------------------------
    ccts = torch.zeros(inst.M, dtype=torch.float64, device=dev)
    ccts = ccts.scatter_reduce(0, orig, s.t_complete, "amax")
    if not torch.allclose(ccts, s.ccts, atol=1e-9):
        raise AssertionError("reported CCTs inconsistent with flow completions")
