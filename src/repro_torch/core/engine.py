"""Offline Algorithm 1 end to end: flat flow table, assignment, event loop.

Port of the offline path of ``repro.core.engine``. The pipeline of
:func:`run_fast` is

  1. WSPT order pi and flow extraction, on the device (``ordering``,
     ``coflow.extract_flows``);
  2. tau-aware cross-core assignment, the CUDA kernel
     (``kernels.ops.coflow_assign``);
  3. service times, on the device, then the merged all-cores circuit event
     loop on the host: the flow table goes to the host once and the
     establishment times come back once;
  4. CCTs on the device (``scatter_reduce(..., "amax")``).

The event loop stays host code over numpy arrays, in a copy the port owns.
It is sequential logic with no kernel in the reference, it relies on numpy's
last-write-wins fancy assignment with duplicate indices (``_first_occurrence``;
torch's ``index_put_`` leaves that order undefined), and it runs per-event
operations on tiny arrays, where torch's per-call overhead would dominate.
Moving it onto the card is later work.

Completion times keep the reference's float associativity,
``(t + delta) + size/rate``, so establishment times and CCTs are
bit-identical to the reference given the same core choices.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.kernels.ops import coflow_assign

from .coflow import Instance, extract_flows
from .ordering import order_coflows
from .scheduler import Schedule

__all__ = ["FlowTable", "SCHEDULINGS", "ALGORITHMS", "build_flow_table",
           "run_fast", "run_fast_metrics"]

#: Intra-core policies of the offline port (``sunflow`` is not ported yet).
SCHEDULINGS = ("work-conserving", "priority-guard", "reserving")

#: Algorithms the port runs. The reference's others raise
#: ``NotImplementedError`` naming the ROADMAP entry that ports them.
ALGORITHMS = ("ours",)

_NOT_PORTED = {
    "rho-assign": "ROADMAP queue 1, item 2 (rho-only FlatAssignState)",
    "rand-assign": "ROADMAP queue 1, item 2 (random FlatAssignState)",
    "sunflow-core": "ROADMAP queue 1, item 3 (_sunflow_times)",
    "rand-sunflow": "ROADMAP queue 1, items 2-3 (random policy, _sunflow_times)",
}


@dataclasses.dataclass(frozen=True)
class FlowTable:
    """All assigned flows of an instance as flat ``(F,)`` tensors, in global
    pi order, on the instance's device."""

    pos: torch.Tensor   # coflow position in pi, int64
    cid: torch.Tensor   # original coflow id, int64
    fi: torch.Tensor    # ingress port, int64
    fj: torch.Tensor    # egress port, int64
    core: torch.Tensor  # assigned core, int64
    size: torch.Tensor  # float64

    @property
    def n_flows(self) -> int:
        return int(self.pos.shape[0])


def _check_algorithm(algorithm: str) -> None:
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {algorithm!r} is not ported yet: "
            f"{_NOT_PORTED[algorithm]}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; one of "
                         f"{sorted((*ALGORITHMS, *_NOT_PORTED))}")


def _check_options(scheduling: str, delta_k: object, locality: float,
                   releases: object = None) -> None:
    if scheduling == "sunflow":
        raise NotImplementedError(
            "scheduling 'sunflow' is not ported yet: ROADMAP queue 1, "
            "item 3 (_sunflow_times)")
    if scheduling not in SCHEDULINGS:
        raise ValueError(
            f"unknown scheduling {scheduling!r}; one of {SCHEDULINGS}")
    if delta_k is not None or locality:
        raise NotImplementedError(
            "delta_k and locality run the fp64 FlatAssignState, which is "
            "not ported yet: ROADMAP queue 1, item 2")
    if releases is not None:
        raise NotImplementedError(
            "releases (the online path) are not ported yet: ROADMAP "
            "queue 1, item 4")


def build_flow_table(inst: Instance, pi: torch.Tensor,
                     algorithm: str = "ours") -> FlowTable:
    """Demand tensor -> assigned ``FlowTable``, on the instance's device.

    Extracts the flows in pi order and assigns them with the tau-aware
    kernel (on the CPU, its plain version). Choices equal the reference's
    ``backend="pallas"`` (fp32 state), not its fp64 numpy backend.
    """
    _check_algorithm(algorithm)
    pos, cid, fi, fj, size = extract_flows(inst, pi)
    core = coflow_assign(fi, fj, size, inst.rates, inst.delta,
                         n_ports=inst.N).to(torch.int64)
    return FlowTable(pos=pos, cid=cid, fi=fi, fj=fj, core=core, size=size)


def _first_occurrence(vals: np.ndarray, scratch: np.ndarray) -> np.ndarray:
    """Boolean mask marking the first occurrence of each value, in order.

    Writing positions in reverse leaves each slot of ``scratch`` holding the
    *first* position of its value (numpy's fancy assignment keeps the last
    write), so a flow is first on its resource iff the slot points back at
    it. ``scratch`` is int64 with at least ``vals.max() + 1`` entries.
    """
    n = vals.size
    scratch[vals[::-1]] = np.arange(n - 1, -1, -1)
    return scratch[vals] == np.arange(n)


def _by_resource(res_ids: np.ndarray, n_res: int) -> list[np.ndarray]:
    """Flow indices using each resource, in priority (index) order."""
    order = np.argsort(res_ids, kind="stable")
    counts = np.bincount(res_ids, minlength=n_res)
    return np.split(order, np.cumsum(counts)[:-1])


def _pop_next_event(events: list[float], t: float) -> float:
    """Earliest completion strictly after t (``events`` is a heap)."""
    while events and events[0] <= t:
        heapq.heappop(events)
    if not events:
        raise RuntimeError("scheduler deadlock: pending flows but no events")
    return heapq.heappop(events)


def _event_loop(
    rin: np.ndarray,    # (F,) int64 ingress resource ids (core*N + i)
    rout: np.ndarray,   # (F,) int64 egress resource ids (core*N + j)
    srv: np.ndarray,    # (F,) float64 service times size/rate[core]
    core: np.ndarray,   # (F,) int64
    delta: float,
    n_res: int,
    n_ports: int,
    guard: bool = False,
) -> np.ndarray:
    """Merged offline event loop over all cores; flows in priority order.

    Returns t_establish per flow, exactly as the reference's sequential
    list scan: at each event the started set is {flows whose two resources
    are free and which are the first pending user of both}, iterated to a
    fixed point for ``guard=False`` (work-conserving), single-pass for
    ``guard=True`` (priority-guard: a pending higher-priority flow holds
    both its resources whether or not it starts).

    Work-conserving: after each event's fixed point every pending flow has
    a busy resource, so only flows on resources freed exactly at the next
    event can start then; candidates come from those resources' flow lists.
    Event times are copied verbatim from completion times, so the exact
    float comparisons below are the convention, not a hazard.
    """
    F = rin.size
    t_est = np.full(F, -1.0)
    if F == 0:
        return t_est
    free_in = np.zeros(n_res)
    free_out = np.zeros(n_res)
    done = np.zeros(F, dtype=bool)
    scratch = np.empty(n_res, dtype=np.int64)
    events: list[float] = []  # heap of future completion times
    remaining = F
    t = 0.0

    if guard:
        pending = np.arange(F)
        first_event = True
        while remaining:
            if first_event:
                pend = pending
                first_event = False
            else:
                # Only cores with a completion at t can start flows now.
                act = np.zeros(n_res // n_ports, dtype=bool)
                act[np.nonzero(free_in == t)[0] // n_ports] = True
                act[np.nonzero(free_out == t)[0] // n_ports] = True
                pend = pending[act[core[pending]]]
            if pend.size:
                ri, rj = rin[pend], rout[pend]
                feas = ((free_in[ri] <= t) & (free_out[rj] <= t)
                        & _first_occurrence(ri, scratch)
                        & _first_occurrence(rj, scratch))
                start = pend[feas]
                if start.size:
                    tc = (t + delta) + srv[start]
                    free_in[rin[start]] = tc
                    free_out[rout[start]] = tc
                    t_est[start] = t
                    done[start] = True
                    remaining -= start.size
                    for v in tc.tolist():
                        heapq.heappush(events, v)
                    pending = pending[~done[pending]]
                    if not remaining:
                        break
            t = _pop_next_event(events, t)
        return t_est

    in_lists = _by_resource(rin, n_res)
    out_lists = _by_resource(rout, n_res)
    cand = np.arange(F)  # at t=0 every flow is a candidate
    while remaining:
        cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        while cand.size:
            safe = _first_occurrence(rin[cand], scratch) \
                & _first_occurrence(rout[cand], scratch)
            start = cand[safe]
            tc = (t + delta) + srv[start]
            free_in[rin[start]] = tc
            free_out[rout[start]] = tc
            t_est[start] = t
            done[start] = True
            remaining -= start.size
            for v in tc.tolist():
                heapq.heappush(events, v)
            cand = cand[~safe]
            cand = cand[(free_in[rin[cand]] <= t) & (free_out[rout[cand]] <= t)]
        if not remaining:
            break
        t = _pop_next_event(events, t)
        pool = [in_lists[r] for r in np.nonzero(free_in == t)[0]]
        pool += [out_lists[r] for r in np.nonzero(free_out == t)[0]]
        cand = np.unique(np.concatenate(pool)) if pool else np.empty(0, np.int64)
        cand = cand[~done[cand]]
    return t_est


def _reserving_times(rin: np.ndarray, rout: np.ndarray, srv: np.ndarray,
                     delta: float, n_res: int) -> np.ndarray:
    """Strict in-order reservation (no backfill) over merged resources."""
    avail_in = np.zeros(n_res)
    avail_out = np.zeros(n_res)
    t_est = np.empty(rin.size)
    for f in range(rin.size):
        i, j = rin[f], rout[f]
        t = avail_in[i] if avail_in[i] >= avail_out[j] else avail_out[j]
        tc = t + delta + srv[f]
        avail_in[i] = tc
        avail_out[j] = tc
        t_est[f] = t
    return t_est


def _times_for_table(inst: Instance, table: FlowTable,
                     scheduling: str = "work-conserving",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scheduling phase over a ``FlowTable``: ``(t_est, srv)`` on the device.

    Resource ids and service times are computed on the device; the loop
    runs on host copies and its establishment times go back in one copy.
    """
    if scheduling not in SCHEDULINGS:
        raise ValueError(
            f"unknown scheduling {scheduling!r}; one of {SCHEDULINGS}")
    K, N = inst.K, inst.N
    rin = table.core * N + table.fi
    rout = table.core * N + table.fj
    srv = table.size / inst.rates[table.core]
    rin_h, rout_h, srv_h = rin.cpu().numpy(), rout.cpu().numpy(), srv.cpu().numpy()
    if scheduling == "reserving":
        t_est_h = _reserving_times(rin_h, rout_h, srv_h, inst.delta, K * N)
    else:
        t_est_h = _event_loop(rin_h, rout_h, srv_h, table.core.cpu().numpy(),
                              inst.delta, K * N, N,
                              guard=(scheduling == "priority-guard"))
    return torch.from_numpy(t_est_h).to(inst.device), srv


def _ccts_from_times(inst: Instance, pi: torch.Tensor, table: FlowTable,
                     t_est: torch.Tensor, srv: torch.Tensor) -> torch.Tensor:
    """Per-coflow CCTs ``(M,)`` in original id order, on the device."""
    t_complete = (t_est + inst.delta) + srv
    ccts = torch.zeros(inst.M, dtype=torch.float64, device=inst.device)
    return ccts.scatter_reduce(0, pi[table.pos], t_complete, "amax")


def _schedule_from_times(inst: Instance, pi: torch.Tensor, table: FlowTable,
                         t_est: torch.Tensor, srv: torch.Tensor) -> Schedule:
    """Rows in the reference's order: core-major, priority order within
    each core."""
    order = torch.argsort(table.core, stable=True)
    te = t_est[order]
    t_start = te + inst.delta
    return Schedule(inst=inst, pi=pi, pos=table.pos[order],
                    cid=table.cid[order], fi=table.fi[order],
                    fj=table.fj[order], core=table.core[order],
                    size=table.size[order], t_establish=te, t_start=t_start,
                    t_complete=t_start + srv[order],
                    ccts=_ccts_from_times(inst, pi, table, t_est, srv))


def run_fast(inst: Instance, algorithm: str = "ours", *,
             scheduling: str = "work-conserving", delta_k: object = None,
             locality: float = 0.0) -> Schedule:
    """Algorithm 1, offline, on the instance's device: the port of
    ``repro.core.run_fast(..., backend="pallas")``, with the same choices,
    establishment times and CCTs.

    ``scheduling`` is ``work-conserving`` (Alg. 1 lines 23-31: any flow
    whose two ports are idle starts), ``priority-guard`` (pending
    higher-priority flows protect their ports from backfill) or
    ``reserving`` (strict in-order reservation). ``delta_k`` and
    ``locality`` are not ported and raise unless left at their defaults.
    """
    _check_algorithm(algorithm)
    _check_options(scheduling, delta_k, locality)
    pi = order_coflows(inst)
    table = build_flow_table(inst, pi, algorithm)
    t_est, srv = _times_for_table(inst, table, scheduling)
    return _schedule_from_times(inst, pi, table, t_est, srv)


def run_fast_metrics(inst: Instance, algorithm: str = "ours", *,
                     scheduling: str = "work-conserving",
                     releases: object = None, delta_k: object = None,
                     locality: float = 0.0) -> tuple[torch.Tensor, int]:
    """Same pipeline as :func:`run_fast`, stopped at the CCTs: returns
    ``(ccts (M,), n_flows)`` without building a ``Schedule``. ``releases``
    (the online path) is not ported and raises unless ``None``."""
    _check_algorithm(algorithm)
    _check_options(scheduling, delta_k, locality, releases)
    pi = order_coflows(inst)
    table = build_flow_table(inst, pi, algorithm)
    t_est, srv = _times_for_table(inst, table, scheduling)
    return _ccts_from_times(inst, pi, table, t_est, srv), table.n_flows
