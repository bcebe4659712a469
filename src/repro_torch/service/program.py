"""Circuit programs: the fabric manager's output artifact.

The port of ``repro.service.program``. A :class:`CircuitProgram` is the
compiled, per-core, time-ordered list of circuit segments the fabric would
physically program -- one segment per scheduled flow, holding the (ingress,
egress) port matching from circuit establishment through transmission
completion (teardown). Its segments are flat tensors on the device of the
schedule or tick they were compiled from.

Programs are self-validating: :meth:`CircuitProgram.as_schedule` rebuilds
the port's flat ``core.scheduler.Schedule`` against the instance implied by
the program's own segments, on the program's device, so the port's
referee ``core.simulator.validate`` checks port exclusivity, not-all-stop
timing, demand conservation and CCT consistency on every emitted program.
Programs from successive service ticks concatenate (:meth:`merge`) into the
stream-wide program.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.coflow import Instance
from repro_torch.core.scheduler import Schedule
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.core.fabric import TickCommit

__all__ = ["CircuitEvent", "CircuitProgram", "compile_commit",
           "compile_schedule", "merge_programs"]


@dataclasses.dataclass(frozen=True)
class CircuitEvent:
    """One switch action: (un)program the (ingress -> egress) matching."""

    t: float
    core: int
    kind: str       # "establish" | "teardown"
    ingress: int
    egress: int
    cid: int        # coflow the circuit serves (telemetry)


def _stable_lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``np.lexsort(keys)`` (last key primary) as stable argsorts, least
    significant key first."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


@dataclasses.dataclass(frozen=True)
class CircuitProgram:
    """Per-core, time-ordered circuit segments over a K-core, N-port fabric.

    Segments are flat ``(S,)`` tensors (int64 ports, cores and labels,
    float64 sizes and times) sorted by (core, establishment time, ingress
    port); a segment occupies its ingress and egress port on its core for
    ``[t_establish, t_complete)``: establishment at ``t_establish``,
    transmission in ``[t_establish + delta, t_complete)``, teardown at
    ``t_complete``.
    """

    rates: torch.Tensor        # (K,) float64
    delta: float
    N: int
    core: torch.Tensor         # (S,) int64
    ingress: torch.Tensor      # (S,) int64
    egress: torch.Tensor       # (S,) int64
    cid: torch.Tensor          # (S,) int64, served coflow id
    size: torch.Tensor         # (S,) float64, bytes carried
    t_establish: torch.Tensor  # (S,) float64
    t_complete: torch.Tensor   # (S,) float64
    #: per-segment reconfiguration delay in force at establishment (fault
    #: model: ``core.fault.DeltaDrift`` gives cores individual delays);
    #: ``None`` means the uniform nominal ``delta``.
    delta_seg: torch.Tensor | None = None

    @classmethod
    def empty(cls, rates: torch.Tensor | np.ndarray, delta: float,
              N: int) -> "CircuitProgram":
        """A program with no segments, on the device of ``rates`` when it is
        a tensor, else on CUDA (``resolve_device``: never the CPU unless
        asked for with CPU ``rates``)."""
        device = (rates.device if isinstance(rates, torch.Tensor)
                  else resolve_device(None))
        ei = torch.zeros(0, dtype=torch.int64, device=device)
        ef = torch.zeros(0, dtype=torch.float64, device=device)
        return cls(rates=_rates_on(rates, ei.device), delta=float(delta),
                   N=int(N), core=ei, ingress=ei.clone(), egress=ei.clone(),
                   cid=ei.clone(), size=ef, t_establish=ef.clone(),
                   t_complete=ef.clone())

    @property
    def device(self) -> torch.device:
        return self.core.device

    @property
    def n_segments(self) -> int:
        return int(self.core.numel())

    @property
    def K(self) -> int:
        return int(self.rates.shape[0])

    @property
    def makespan(self) -> float:
        return float(self.t_complete.max()) if self.n_segments else 0.0

    def events(self) -> Iterator[CircuitEvent]:
        """Time-ordered establish/teardown events (ties: teardown first,
        then by core -- a port freed at t may be re-matched at t). Ordered
        on one host copy of the segments, by the reference's ``lexsort``."""
        S = self.n_segments
        core, ing, egr, cid = (x.cpu().numpy() for x in (
            self.core, self.ingress, self.egress, self.cid))
        t = np.concatenate([self.t_complete.cpu().numpy(),
                            self.t_establish.cpu().numpy()])
        kind = np.concatenate([np.zeros(S, np.int64), np.ones(S, np.int64)])
        seg = np.concatenate([np.arange(S), np.arange(S)])
        for x in np.lexsort((core[seg], kind, t)).tolist():
            s = int(seg[x])
            yield CircuitEvent(
                t=float(t[x]), core=int(core[s]),
                kind="establish" if kind[x] else "teardown",
                ingress=int(ing[s]), egress=int(egr[s]), cid=int(cid[s]))

    def per_core(self) -> dict[int, torch.Tensor]:
        """Segment indices per core (already time-ordered within a core)."""
        return {k: torch.nonzero(self.core == k)[:, 0] for k in range(self.K)}

    def seg_delta(self) -> torch.Tensor:
        """Per-segment reconfiguration delay, materialized."""
        if self.delta_seg is not None:
            return self.delta_seg
        return torch.full((self.n_segments,), self.delta, dtype=torch.float64,
                          device=self.device)

    def merge(self, other: "CircuitProgram") -> "CircuitProgram":
        """Concatenate two programs (e.g. successive service ticks)."""
        return merge_programs([self, other], self.rates, self.delta, self.N)

    def as_schedule(self) -> Schedule:
        """Rebuild the port's flat ``Schedule`` for the instance the program
        itself serves, on the program's device.

        The reconstructed instance has one coflow per distinct ``cid`` (in
        first-establishment order) whose demand is the program's carried
        bytes, so ``validate`` checks what a program can violate: port
        exclusivity, not-all-stop timing and CCT consistency. For an
        end-of-stream program this is the schedule of the true instance.
        """
        dev = self.device
        uniq, inv = torch.unique(self.cid, return_inverse=True)
        U = int(uniq.numel())
        # positions in first-establishment order, to keep pi meaningful
        first = torch.full((U,), float("inf"), dtype=torch.float64, device=dev)
        first = first.scatter_reduce(0, inv, self.t_establish, "amin")
        rank = torch.argsort(torch.argsort(first, stable=True), stable=True)
        pos = rank[inv]
        demand = torch.zeros((U, self.N, self.N), dtype=torch.float64,
                             device=dev)
        demand.index_put_((pos, self.ingress, self.egress), self.size,
                          accumulate=True)
        order = torch.argsort(rank, stable=True)  # cid index at each position
        inst = Instance(demand=demand,
                        weights=torch.ones(U, dtype=torch.float64, device=dev),
                        cids=uniq[order], rates=self.rates, delta=self.delta)
        ccts = torch.zeros(U, dtype=torch.float64, device=dev)
        ccts = ccts.scatter_reduce(0, pos, self.t_complete, "amax")
        return Schedule(
            inst=inst, pi=torch.arange(U, device=dev), pos=pos, cid=self.cid,
            fi=self.ingress, fj=self.egress, core=self.core, size=self.size,
            t_establish=self.t_establish,
            t_start=self.t_establish + self.seg_delta(),
            t_complete=self.t_complete, ccts=ccts)

    def drop(self, keys: set) -> "CircuitProgram":
        """Remove the segments whose ``(cid, ingress, egress, core,
        t_establish)`` identity is in ``keys`` -- the aborted-circuit keys of
        the fault model (``fabric.FabricState.aborted_keys``). The aborted
        establishments physically happened and are audited by the corrective
        teardown events; the *program of record* excludes them so that bytes
        are accounted exactly once and a recovered core's new circuits never
        collide with stale intervals."""
        if not keys:
            return self
        rows = zip(self.cid.tolist(), self.ingress.tolist(),
                   self.egress.tolist(), self.core.tolist(),
                   self.t_establish.tolist())
        keep_l = [r not in keys for r in rows]
        if all(keep_l):
            return self
        keep = torch.tensor(keep_l, dtype=torch.bool, device=self.device)
        dseg = None if self.delta_seg is None else self.delta_seg[keep]
        return dataclasses.replace(
            self, core=self.core[keep], ingress=self.ingress[keep],
            egress=self.egress[keep], cid=self.cid[keep],
            size=self.size[keep], t_establish=self.t_establish[keep],
            t_complete=self.t_complete[keep], delta_seg=dseg)

    def validate(self) -> None:
        """Run the port's referee on this program, on its device."""
        from repro_torch.core.simulator import validate

        validate(self.as_schedule(), flow_delta=self.delta_seg)


def _rates_on(rates: torch.Tensor | np.ndarray,
              device: torch.device) -> torch.Tensor:
    return torch.as_tensor(rates, dtype=torch.float64).to(device)


def merge_programs(programs: Sequence[CircuitProgram],
                   rates: torch.Tensor | np.ndarray, delta: float,
                   N: int) -> CircuitProgram:
    """Concatenate any number of programs for one fabric (re-sorted); no
    programs give :meth:`CircuitProgram.empty`."""
    programs = list(programs)
    if not programs:
        return CircuitProgram.empty(rates, delta, N)
    rates_h = torch.as_tensor(rates, dtype=torch.float64).cpu()
    for p in programs:
        if (p.N != int(N) or p.delta != float(delta)  # reprolint: disable=float-eq -- fabric-identity check: programs merge only for bit-identical delta (cache keys hash the exact value)
                or not torch.equal(p.rates.cpu(), rates_h)):
            raise ValueError("cannot merge programs for different fabrics")

    def cat(attr: str) -> torch.Tensor:
        return torch.cat([getattr(p, attr) for p in programs])

    if any(p.delta_seg is not None for p in programs):
        dseg = torch.cat([p.seg_delta() for p in programs])
    else:
        dseg = None
    return _sorted_program(rates, delta, N, cat("core"), cat("ingress"),
                           cat("egress"), cat("cid"), cat("size"),
                           cat("t_establish"), cat("t_complete"), dseg)


def _sorted_program(rates: torch.Tensor | np.ndarray, delta: float, N: int,
                    core: torch.Tensor, ingress: torch.Tensor,
                    egress: torch.Tensor, cid: torch.Tensor,
                    size: torch.Tensor, t_est: torch.Tensor,
                    t_comp: torch.Tensor,
                    delta_seg: torch.Tensor | None = None) -> CircuitProgram:
    order = _stable_lexsort(ingress, t_est, core)
    return CircuitProgram(
        rates=_rates_on(rates, core.device), delta=float(delta), N=int(N),
        core=core[order], ingress=ingress[order], egress=egress[order],
        cid=cid[order], size=size[order], t_establish=t_est[order],
        t_complete=t_comp[order],
        delta_seg=None if delta_seg is None else delta_seg[order])


def compile_commit(commit: "TickCommit", rates: torch.Tensor | np.ndarray,
                   delta: float, N: int) -> CircuitProgram:
    """Compile one ``fabric.TickCommit`` into its circuit program, on the
    commit's device.

    The program's ``cid`` field carries the stream admission id
    (``TickCommit.gid``) -- the service's coflow identity, unique across the
    stream even when submitted ``Coflow.cid`` values collide. A drifted
    tick's per-flow delays ride along as ``delta_seg``.
    """
    return _sorted_program(rates, delta, N, commit.core, commit.fi, commit.fj,
                           commit.gid, commit.size, commit.t_establish,
                           commit.t_complete, commit.delta_f)


def compile_schedule(s: Schedule, *,
                     index_labels: bool = False) -> CircuitProgram:
    """Compile a full flat ``Schedule`` (e.g. the one-shot cached path).

    ``index_labels=True`` labels segments with each coflow's ORIGINAL
    instance index instead of its ``cid`` -- the canonical form the program
    cache stores, since indices are unique by construction and map to any
    later submission's cids with one lookup.
    """
    inst = s.inst
    if s.n_flows == 0:
        return CircuitProgram.empty(inst.rates, inst.delta, inst.N)
    labels = s.pi[s.pos] if index_labels else s.cid
    return _sorted_program(inst.rates, inst.delta, inst.N, s.core, s.fi,
                           s.fj, labels, s.size, s.t_establish, s.t_complete)
