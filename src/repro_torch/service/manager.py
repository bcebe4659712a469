"""The fabric manager: a long-running scheduling service over the engine.

The port of ``repro.service.manager``: the same planes, reports and
counters over the port's engine. The streaming plane runs
``core.fabric.FabricState`` on the manager's device (CUDA unless
``device="cpu"``; it never falls back): coflow demands must be there, the
batches are extracted there and every tick program lives there. The
one-shot plane runs ``run_fast`` / ``run_fast_online`` on the instance's
device, ``backend="numpy"`` by default as in the reference; with
``backend="kernel"`` a cache miss launches the tau-aware assignment kernel
once and a hit launches nothing.

``FabricManager`` is the control-plane loop the paper's Algorithm 1 lives
inside in a real deployment (cf. Jupiter-style OCS fabrics): coflow-arrival
requests stream in, are micro-batched by the admission queue, scheduled
incrementally against the already-committed circuits
(``core.fabric.FabricState``), and compiled into per-core
:class:`~repro_torch.service.program.CircuitProgram` artifacts — the
establish/teardown sequences the optical switches would execute.

Two request planes:

  - **streaming** (``submit`` + ``tick``): the production path. Per tick,
    only pending flows are scheduled -- work scales with the backlog, not
    with the stream history.
  - **one-shot** (``schedule_instance``): schedule a whole instance at
    once, fronted by the canonical-hash LRU program cache — repeated demand
    patterns (e.g. a training job's identical steps) skip the engine
    entirely. Grid sweeps dispatch to ``core.run_batch`` via
    ``sweep_instances``.

Every emitted program can be round-tripped through the independent referee
(``CircuitProgram.validate``); ``validate_every_tick=True`` does it inline.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.batch import ResultTable, run_batch
from repro_torch.core.coflow import (
    Coflow,
    Instance,
    OnlineInstance,
    instance_from_coflows,
)
from repro_torch.core.engine import run_fast, run_fast_online
from repro_torch.core.fabric import INCREMENTAL_SCHEDULINGS, FabricState
from repro_torch.core.fault import CoreDown, FaultApplication, FaultEvent
from repro_torch.core.ordering import priority_scores
from repro_torch.obs.clock import now
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, current_tracer

from .admission import (
    AdmissionPolicy,
    AdmissionQueue,
    ArrivalRequest,
    BackpressureError,
)
from .cache import ProgramCache, instance_key
from .program import (
    CircuitEvent,
    CircuitProgram,
    compile_commit,
    compile_schedule,
    merge_programs,
)

__all__ = ["FabricConfig", "TickReport", "FaultReport", "FabricManager",
           "AdmissionPolicy", "BackpressureError"]


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Static configuration of one fabric-manager service."""

    rates: tuple = (10.0, 20.0, 30.0)
    delta: float = 8.0
    N: int = 16
    algorithm: str = "ours"
    scheduling: str = "work-conserving"
    seed: int = 0
    max_queue_depth: int = 1024       # admission backpressure threshold
    cache_capacity: int = 128         # one-shot program cache entries
    validate_every_tick: bool = False  # referee every emitted tick program
    #: Tick reports (each holding its circuit program) retained for
    #: ``program()`` / inspection. ``None`` keeps the whole stream — right
    #: for tests and bounded runs; set a bound for a long-running service
    #: (summary() stats stay exact either way via running counters, but
    #: ``program()`` then only covers the retained window).
    max_history_ticks: int | None = None
    #: Sliding window of per-coflow decision-latency samples for the
    #: p50/p99 telemetry.
    max_latency_samples: int = 65536
    #: Scripted topology churn (a ``core.fault.FaultInjector``): events are
    #: applied at the first tick at or after their timestamp. Faults
    #: discovered out-of-band go through :meth:`FabricManager.report_fault`
    #: instead.
    faults: object | None = None
    #: Overload-survival policy (flow-budget caps, shedding, backfilling;
    #: see ``admission.AdmissionPolicy``). ``None`` enforces nothing — the
    #: plain bounded-FIFO behavior.
    admission: AdmissionPolicy | None = None
    #: Committed-circuit retention window for late fault discovery: commits
    #: completing before ``t_now - fault_lookback`` are garbage-collected
    #: (see ``core.fault``); ``inf`` retains everything forever.
    fault_lookback: float = np.inf
    #: Delta-scheduling (touched-set) in the incremental engine: re-run the
    #: event loop only over resource components a new arrival touches.
    #: ``False`` replays the whole tentative backlog every tick (the
    #: bit-identical reference; see ``fabric.cross_check_incremental``).
    delta_schedule: bool = True
    #: Locality-aware assignment strength (``assignment.FlatAssignState``):
    #: each core/port choice pays ``locality * delta`` per resource-
    #: component the flow would newly open, biasing a coflow's flows to
    #: stay inside few components so the delta-splice has something to
    #: reuse. ``0.0`` is the unbiased tau-aware assignment; nonzero changes
    #: schedules (gated by the referee, not bit-exactness).
    locality: float = 0.0


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one service tick did."""

    t_now: float
    admitted: int          # coflows admitted this tick
    committed_flows: int   # circuits committed this tick
    finalized: int         # coflows whose CCT became final
    pending_flows: int     # backlog after the tick
    queue_depth: int       # requests still queued after the tick
    wall_s: float          # tick wall-clock
    program: CircuitProgram
    aborted: int = 0       # circuits torn down by faults applied this tick
    unfinalized: int = 0   # final CCTs retracted by those faults
    deferred: int = 0      # flow-budget deferral events this tick
    shed: int = 0          # requests moved to standby this tick
    backfilled: int = 0    # standby requests re-queued this tick
    standby_depth: int = 0  # standby backlog after the tick
    #: resource-sharing components in the tick's pending set / components
    #: the tick re-scheduled (delta-scheduling leverage; 0/0 when off)
    components_total: int = 0
    components_touched: int = 0


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """One applied fault event plus the corrective actions it triggered."""

    event: object            # the core.fault event
    teardowns: tuple         # corrective CircuitEvent teardown actions
    aborted: int             # committed circuits torn down
    requeued: int            # flows re-queued as residual demand
    reassigned_pending: int  # tentative flows moved off the affected core
    unfinalized: tuple       # gids whose final CCT was retracted
    cache_purged: int        # one-shot cache entries invalidated


class FabricManager:
    """Streaming coflow admission -> incremental scheduling -> programs."""

    def __init__(self, config: FabricConfig = FabricConfig(), *,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device | None = None) -> None:
        if config.scheduling not in INCREMENTAL_SCHEDULINGS:
            raise ValueError(
                f"service scheduling must be incremental "
                f"({INCREMENTAL_SCHEDULINGS}), got {config.scheduling!r}")
        self.config = config
        # one shared observability plane: the engine, queue, and cache all
        # record into this manager's tracer + registry
        self._tracer: Tracer = current_tracer() if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        # commit tracking is always on for a managed fabric: report_fault
        # must be able to classify committed circuits at any moment
        self.state = FabricState(
            rates=np.asarray(config.rates, dtype=np.float64),
            delta=config.delta, N=config.N, algorithm=config.algorithm,
            scheduling=config.scheduling, seed=config.seed,
            faults=config.faults, track_commits=True,
            delta_schedule=config.delta_schedule,
            fault_lookback=config.fault_lookback,
            locality=config.locality,
            tracer=self._tracer, device=device)
        self.device = self.state.device
        self.fault_reports: list[FaultReport] = []
        self.queue = AdmissionQueue(max_depth=config.max_queue_depth,
                                    policy=config.admission,
                                    metrics=self.metrics)
        self.cache = ProgramCache(capacity=config.cache_capacity,
                                  metrics=self.metrics, tracer=self._tracer)
        self.reports: "deque[TickReport]" = deque(
            maxlen=config.max_history_ticks)
        self._submitted_s: dict[int, float] = {}  # gid -> submit wall-clock
        # running counters (exact regardless of history trimming); per-coflow
        # results live in FabricState's registry (ccts()/weights() by gid)
        self._c_finalized = self.metrics.counter("service.finalized")
        self._c_ticks = self.metrics.counter("service.ticks")
        self._c_flows = self.metrics.counter("service.flows_committed")
        self._g_depth_max = self.metrics.gauge("service.queue_depth_max")
        self._g_depth_sum = self.metrics.gauge("service.queue_depth_sum")
        # per-tick wall + per-coflow decision latency; the histogram window
        # truncates samples but counts every observation, so summary() can
        # report honest window coverage for its percentiles
        self._h_tick_wall = self.metrics.histogram("service.tick_wall_s")
        self._h_latency = self.metrics.histogram(
            "service.decision_latency_s", window=config.max_latency_samples)

    @property
    def latencies_s(self) -> "deque[float]":
        """Retained decision-latency samples (the histogram's window)."""
        return self._h_latency.samples

    # -- streaming plane ---------------------------------------------------
    def submit(self, coflow: Coflow, release: float) -> None:
        """Enqueue one arrival; raises BackpressureError when the queue is
        full (the caller must back off until the next tick drains it).
        Malformed requests are rejected HERE, before they can enter the
        queue and poison a later tick's whole batch."""
        if coflow.n_ports != self.config.N:
            raise ValueError(
                f"coflow {coflow.cid} has N={coflow.n_ports}, fabric has "
                f"N={self.config.N}")
        if coflow.demand.device != self.device:
            raise ValueError(
                f"coflow {coflow.cid}'s demand is on {coflow.demand.device}, "
                f"but the fabric runs on {self.device}")
        score = 0.0
        if self.queue.policy.shed_depth is not None:
            # shedding victims are picked by WSPT score, through the one
            # shared definition (scores are per-coflow, priced over the
            # surviving fabric -- same floats _admit computes)
            score = float(priority_scores(instance_from_coflows(
                (coflow,), self.state.rates[self.state.core_up],
                self.config.delta, device=self.device))[0])
        self.queue.push(ArrivalRequest(
            coflow=coflow, release=float(release),
            submitted_s=now(),
            score=score, n_flows=coflow.num_flows))

    def tick(self, t_now: float) -> TickReport:
        """One service tick at stream time ``t_now``: drain the admission
        queue (under the admission policy's flow budget), schedule pending
        flows incrementally, commit + compile this tick's circuits."""
        return self._tick(t_now, capped=True)

    def _flow_budget(self) -> int | None:
        """Tentative flows the engine can still take under the policy cap
        (None = uncapped): the backlog the event loop re-derives each tick
        never exceeds ``max_pending_flows`` plus what commits free up."""
        cap = self.config.admission
        if cap is None or cap.max_pending_flows is None:
            return None
        return max(0, cap.max_pending_flows - self.state.n_pending_flows)

    def _tick(self, t_now: float, *, capped: bool) -> TickReport:
        tracer = self._tracer
        with tracer.span("tick") as tick_sp:
            t0 = now()
            q = self.queue
            before = (q.deferred, q.shed, q.backfilled)
            with tracer.span("tick/admit") as admit_sp:
                admitted = q.drain(t_now, self.state.commit_floor,
                                   flow_budget=self._flow_budget() if capped
                                   else None)
                if admit_sp.live:
                    admit_sp.set(admitted=len(admitted),
                                 queue_depth=q.depth)
            gid0 = self.state.n_coflows
            try:
                commit = self.state.step(
                    [r.coflow for r in admitted],
                    np.array([r.release for r in admitted],
                             dtype=np.float64),
                    t_now)
            except Exception:
                # the batch was rejected whole — put the drained requests
                # back (front, original order) instead of silently losing
                # them
                self.queue.requeue_front(admitted)
                raise
            for off, r in enumerate(admitted):
                self._submitted_s[gid0 + off] = r.submitted_s
            for app in commit.faults:  # scripted churn applied at this tick
                self._register_fault(app)
            with tracer.span("tick/program_emit") as emit_sp:
                program = compile_commit(commit, self.state.rates,
                                         self.state.delta, self.state.N)
                if self.config.validate_every_tick:
                    program.validate()
                if emit_sp.live:
                    emit_sp.set(segments=program.n_segments,
                                validated=self.config.validate_every_tick)
            if self.device.type == "cuda":
                # the tick's wall time ends on its device work
                torch.cuda.synchronize(self.device)
            end = now()
            self._c_finalized.inc(len(commit.finalized))
            for fin in commit.finalized:
                # a fault-retracted coflow re-finalizing here has no pending
                # submission stamp (popped at its first finalization) — skip
                # the sample rather than record a bogus 0.0 latency
                sub = self._submitted_s.pop(fin[0], None)
                if sub is not None:
                    self._h_latency.observe(end - sub)
            report = TickReport(
                t_now=float(t_now), admitted=len(admitted),
                committed_flows=commit.n_flows,
                finalized=len(commit.finalized),
                pending_flows=commit.n_pending, queue_depth=self.queue.depth,
                wall_s=end - t0, program=program,
                aborted=sum(app.n_aborted for app in commit.faults),
                unfinalized=len(commit.unfinalized),
                deferred=q.deferred - before[0], shed=q.shed - before[1],
                backfilled=q.backfilled - before[2],
                standby_depth=q.standby_depth,
                components_total=commit.components_total,
                components_touched=commit.components_touched)
            self.reports.append(report)
            self._c_ticks.inc()
            self._c_flows.inc(commit.n_flows)
            self._h_tick_wall.observe(report.wall_s)
            self._g_depth_max.set(max(self._g_depth_max.value,
                                      report.queue_depth))
            self._g_depth_sum.set(self._g_depth_sum.value
                                  + report.queue_depth)
            if tick_sp.live:
                up = self.state.core_up
                reuse_den = commit.components_total
                tick_sp.set(
                    tick=self._c_ticks.value, t_now=float(t_now),
                    admitted=len(admitted), flows=commit.n_flows,
                    finalized=len(commit.finalized),
                    pending_flows=commit.n_pending,
                    components_touched=commit.components_touched,
                    components_total=commit.components_total,
                    tent_reuse_fraction=(
                        1.0 - commit.components_touched / reuse_den
                        if reuse_den else 0.0),
                    core_mask="".join("1" if u else "0" for u in up))
            return report

    def flush(self) -> TickReport:
        """End-of-stream: commit everything still pending, queued, or shed.

        Standby requests are recalled first and the closing ticks run with
        the flow budget off — the cap bounds per-tick scheduling work in
        steady state, but at end-of-stream there is no next tick to defer
        to, and the policy's contract is that shed work is deferred, never
        silently lost (only ``rejected``/``dropped`` requests are gone)."""
        self.queue.recall_standby()
        if self.queue.depth:
            # admit every queued request at its own release, then finalize
            self._tick(max(self.queue.max_release,
                           np.nextafter(self.state.t_now, np.inf)),
                       capped=False)
        return self._tick(np.inf, capped=False)

    # -- fault plane --------------------------------------------------------
    def _register_fault(self, app: FaultApplication) -> FaultReport:
        """Turn one ``FaultApplication`` into its corrective actions: emit
        teardown events for every aborted circuit, retract retracted final
        CCTs from the counters, and purge one-shot cache entries that
        matched circuits through a failed core."""
        self._c_finalized.inc(-len(app.unfinalized))
        teardowns = tuple(
            CircuitEvent(t=float(a.t_abort), core=a.core, kind="teardown",
                         ingress=a.i, egress=a.j, cid=a.gid)
            for a in app.aborted)
        purged = 0
        if isinstance(app.event, CoreDown):
            k = int(app.event.core)
            purged = self.cache.invalidate(
                lambda prog: bool((prog.core == k).any()))
        report = FaultReport(
            event=app.event, teardowns=teardowns, aborted=app.n_aborted,
            requeued=app.requeued,
            reassigned_pending=app.reassigned_pending,
            unfinalized=app.unfinalized, cache_purged=purged)
        self.fault_reports.append(report)
        return report

    def report_fault(self, event: FaultEvent) -> FaultReport:
        """Apply one topology-churn event (``core.fault``) right now.

        The event is applied to the incremental state immediately — commits
        on the affected core are classified, in-flight circuits aborted and
        re-queued, the next ``tick`` re-derives the tentative schedule over
        the survivors — and the corrective actions are returned: teardown
        events for the switches, retracted finalizations, purged cache
        entries. Events timestamped in the past model late discovery.
        """
        return self._register_fault(self.state.apply_fault(event))

    def program(self) -> CircuitProgram:
        """The merged program of record across the retained tick history
        (the whole stream unless ``max_history_ticks`` trimmed it).
        Circuits aborted by faults are excluded: their bytes were re-served
        by later commits, and their stale intervals must not collide with a
        recovered core's new circuits (the corrective teardown events in
        ``fault_reports`` are the audit trail of the aborts)."""
        rates = torch.as_tensor(self.state.rates).to(self.device)
        merged = merge_programs([r.program for r in self.reports], rates,
                                self.state.delta, self.state.N)
        return merged.drop(self.state.aborted_keys())

    def ccts(self) -> torch.Tensor:
        """Per-coflow CCTs by admission id (final for finalized coflows), on
        the manager's device."""
        return self.state.ccts()

    # -- one-shot plane ----------------------------------------------------
    def schedule_instance(
        self,
        inst: Instance | OnlineInstance,
        *,
        algorithm: str | None = None,
        scheduling: str | None = None,
        seed: int | None = None,
        backend: str = "numpy",
    ) -> tuple[CircuitProgram, bool]:
        """Schedule a whole instance, through the program cache.

        Returns ``(program, hit)`` -- on a hit the engine never runs; the
        cached program is the byte-identical artifact of the earlier
        computation (the pipeline is deterministic in the hashed inputs).
        The program lives on the instance's device. ``backend`` is the
        assignment backend (``"numpy"``, the reference's default, or
        ``"kernel"``).
        """
        algorithm = self.config.algorithm if algorithm is None else algorithm
        scheduling = self.config.scheduling if scheduling is None else scheduling
        seed = self.config.seed if seed is None else seed
        releases = None
        if isinstance(inst, OnlineInstance):
            inst, releases = inst.inst, inst.releases
        # A degraded fabric (cores down) schedules over the survivors only;
        # the up-mask fingerprint keeps degraded programs from ever hitting
        # healthy-fabric cache entries (and vice versa). Drifted per-core
        # reconfiguration delays (fault.DeltaDrift) likewise join the
        # fingerprint: a drift re-keys every request, so stale
        # nominal-delta programs are never served while the drift holds —
        # and drifting back to nominal restores the original keys (the old
        # entries hit again, still byte-correct). Healthy keys are
        # byte-identical to the pre-fault scheme.
        up = self.state.core_up
        degraded = not bool(up.all())
        drifted = self.state.delta_drifted
        delta_k = self.state.delta_k.copy() if drifted else None
        fp = []
        if degraded:
            fp.append("up=" + "".join("1" if u else "0" for u in up))
        if drifted:
            fp.append("delta_k="
                      + ",".join(repr(float(d)) for d in delta_k))
        fingerprint = ";".join(fp)
        key = instance_key(inst, releases, algorithm=algorithm,
                           scheduling=scheduling, seed=seed, backend=backend,
                           fabric=fingerprint)
        # The cache stores programs labeled by coflow INDEX (canonical: the
        # key excludes cid labels, so a hit may come from a submission with
        # different cids); relabel to this caller's ids with one lookup.
        sub_cids = inst.cids
        canonical = self.cache.get(key)
        hit = canonical is not None
        if not hit:
            run_inst = inst
            up_idx = None
            run_delta_k = delta_k
            if degraded:
                if inst.K != self.state.K:
                    raise ValueError(
                        f"instance has K={inst.K} cores but the degraded "
                        f"fabric has K={self.state.K}; cannot mask")
                up_idx = np.nonzero(up)[0]
                up_idx_t = torch.from_numpy(up_idx).to(inst.device)
                run_inst = dataclasses.replace(inst,
                                               rates=inst.rates[up_idx_t])
                if drifted:
                    run_delta_k = delta_k[up_idx]
            if drifted and inst.K != self.state.K:
                raise ValueError(
                    f"instance has K={inst.K} cores but the drifted fabric "
                    f"has K={self.state.K}; cannot price per-core delays")
            if releases is None:
                s = run_fast(run_inst, algorithm, seed=seed,
                             scheduling=scheduling, backend=backend,
                             delta_k=run_delta_k)
            else:
                s = run_fast_online(
                    OnlineInstance(inst=run_inst, releases=releases),
                    algorithm, seed=seed, scheduling=scheduling,
                    backend=backend, delta_k=run_delta_k)
            canonical = compile_schedule(s, index_labels=True)
            if drifted:
                # stamp each segment's delay in force so emitted programs
                # (and the referee) see the drifted establish->start gap
                canonical = dataclasses.replace(
                    canonical, delta_seg=torch.from_numpy(run_delta_k).to(
                        inst.device)[canonical.core])
            if degraded:
                # back to physical core labels + the full-fabric rate vector
                # (up_idx is monotone, so the canonical sort order holds)
                canonical = dataclasses.replace(
                    canonical, rates=inst.rates, core=up_idx_t[canonical.core])
        program = dataclasses.replace(canonical, cid=sub_cids[canonical.cid])
        if not hit:
            if self.config.validate_every_tick:
                program.validate()  # before caching: never store unvetted
            self.cache.put(key, canonical)
        return program, hit

    def sweep_instances(self, instances: Sequence[Instance],
                        algorithms: Sequence[str] = ("ours",),
                        **kw: object) -> ResultTable:
        """Grid dispatch to the port's serial ``core.run_batch``
        (validator-gated sweeps)."""
        return run_batch(instances, algorithms, **kw)

    # -- telemetry ---------------------------------------------------------
    def summary(self) -> dict:
        """Service-level metrics for dashboards / the load harness.

        A flat compatibility view over the manager's
        :class:`~repro_torch.obs.metrics.MetricsRegistry`: counters are
        maintained incrementally, so they stay exact even when
        ``max_history_ticks`` bounds the retained tick reports. The latency
        percentiles cover the ``max_latency_samples`` most recent coflows —
        the ``latency_samples_*``/``latency_window_coverage`` keys say
        exactly how much of the observed population that window retains, so
        a truncated p99 is never silently presented as exact.
        """
        lat_h = self._h_latency
        n_finalized = self._c_finalized.value
        n_ticks = self._c_ticks.value
        total_wall = self._h_tick_wall.total
        return {
            "coflows_admitted": self.state.n_coflows,
            "coflows_finalized": n_finalized,
            "flows_committed": self._c_flows.value,
            "ticks": n_ticks,
            "total_tick_wall_s": total_wall,
            "coflows_per_s": (n_finalized / total_wall
                              if total_wall > 0 else 0.0),
            "decision_latency_p50_s": lat_h.quantile(0.50),
            "decision_latency_p99_s": lat_h.quantile(0.99),
            "latency_samples_retained": lat_h.n_retained,
            "latency_samples_observed": lat_h.n_observed,
            "latency_window_coverage": lat_h.coverage,
            "queue_depth_max": int(self._g_depth_max.value),
            "queue_depth_mean": (self._g_depth_sum.value / n_ticks
                                 if n_ticks else 0.0),
            "rejected": self.queue.rejected,
            "late_arrivals": self.queue.late,
            # overload-policy accounting (exact; see admission.py):
            # admitted + queued + standby + rejected + dropped == submitted
            "deferred": self.queue.deferred,
            "deferred_flows": self.queue.deferred_flows,
            "shed": self.queue.shed,
            "backfilled": self.queue.backfilled,
            "dropped": self.queue.dropped,
            "standby_depth": self.queue.standby_depth,
            "pending_flows": self.state.n_pending_flows,
            # delta-scheduling effectiveness + retention GC
            "tent_reused": self.state.tent_reused,
            "tent_recomputed": self.state.tent_recomputed,
            "tent_reuse_fraction": (
                self.state.tent_reused
                / (self.state.tent_reused + self.state.tent_recomputed)
                if (self.state.tent_reused
                    + self.state.tent_recomputed) else 0.0),
            "components_total": self.state.components_total,
            "components_touched": self.state.components_touched,
            "tent_invalidated": self.state.tent_invalidated,
            # {component size -> count} over every tick's pending set, and
            # the same histogram restricted to components whose cached rows
            # were spliced — *where* the delta-splice pays, not just how much
            "component_size_hist": dict(self.state.component_size_hist),
            "component_reused_hist": dict(self.state.component_reused_hist),
            "commits_retained": self.state.n_commits_retained,
            "commits_gced": self.state.commits_gced,
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_hit_rate": self.cache.hit_rate,
            "cores_up": int(self.state.core_up.sum()),
            "faults_applied": len(self.state.fault_log),
            "circuits_aborted": sum(r.aborted for r in self.fault_reports),
            "flows_requeued": sum(r.requeued for r in self.fault_reports),
        }
