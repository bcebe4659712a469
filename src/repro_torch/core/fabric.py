"""The incremental (streaming) engine: Algorithm 1 tick by tick over
committed circuits, with the fault plane.

Port of ``repro.core.engine``'s streaming half (``src/repro/core/engine.py``
lines 811-1966): ``INCREMENTAL_SCHEDULINGS``, ``_resource_components``,
``_touched_rows``, ``ComponentIndex``, ``TickCommit``, ``FabricState`` (its
admission, ticks, delta-scheduling splice, component telemetry, watermark GC
and fault methods), ``_assert_commits_equal`` and
``cross_check_incremental``.

``FabricState`` carries committed per-core port-availability horizons and
the persistent assignment state across service ticks, so each tick
schedules only the *pending* flows (new arrivals + not-yet-committed
leftovers) against the circuits already programmed, instead of replaying
the whole arrival history through ``run_fast_online``. Bit-exactness
against that replay rests on the commit rule: a circuit is committed at
tick time T iff its establishment time is <= T. Release gating is the exact
comparison ``release <= t`` and every coflow admitted after tick T has
release > T, so no later arrival can take part in (or, under
``priority-guard``, protect ports at) any event at or before T.

Where things run: a batch's demand arrives as device tensors; the WSPT
scores and the flow extraction run on the state's device (CUDA unless
``device="cpu"``); the flows come to the host once for the fp64 assignment
(``FlatAssignState``, the reference's choice here: no kernel runs on this
path, in the reference or in the port) and the event loops, which stay host
numpy as in ``run_fast``; each tick's ``TickCommit`` goes back to the device
in one copy per field. The pending set, the tentative cache and the
committed-circuit retention are host arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Annotated, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import NULL_TRACER, Tracer

from .arrays import F8, I8
from .assignment import FlatAssignState, _host_f64
from .coflow import Coflow, OnlineInstance, extract_flows, instance_from_coflows
from .effects import effects
from .engine import (
    _event_loop,
    _reserving_times,
    _resolve_algorithm,
    run_fast_online,
)
from .fault import (
    FAULT_EVENTS,
    AbortedCircuit,
    CoreDown,
    CoreUp,
    DeltaDrift,
    FaultApplication,
    FaultEvent,
    FaultInjector,
    PortFlap,
)
from .ordering import priority_scores

__all__ = ["INCREMENTAL_SCHEDULINGS", "ComponentIndex", "TickCommit",
           "FabricState", "cross_check_incremental"]

#: Intra-core policies the incremental path supports. The sunflow baselines
#: pick the next coflow at core-free time — a decision that arrivals *after*
#: the current tick can overturn (the pick may happen arbitrarily far in the
#: future), so they cannot commit tick-by-tick and require full replay.
INCREMENTAL_SCHEDULINGS = ("work-conserving", "priority-guard", "reserving")

_PEND_FIELDS = (
    ("gid", np.int64), ("cid", np.int64), ("fi", np.int64), ("fj", np.int64),
    ("core", np.int64), ("size", np.float64), ("srv", np.float64),
    ("rel", np.float64), ("score", np.float64), ("intra", np.int64),
)

#: Committed-circuit retention (``track_commits``): the pending fields plus
#: the committed times (what fault classification and horizon rebuilds
#: read; the delay in force reaches programs via ``TickCommit.delta_f``).
_COMMIT_FIELDS = _PEND_FIELDS + (
    ("t_est", np.float64), ("t_comp", np.float64),
)


def _resource_components(rin: np.ndarray, rout: np.ndarray,
                         n_res: int) -> np.ndarray:
    """Per-row component labels of the bipartite resource-sharing graph.

    Flows interact ONLY through shared (core, port) resources — the event
    loop starts a flow by comparing it against the other users of its two
    resources, and nothing else. So the pending set decomposes exactly into
    connected components of the bipartite graph over ingress resources and
    egress resources (offset by ``n_res``), one edge per flow. Returns, for
    each row, the union-find root of its ingress resource — rows share a
    label iff they are in the same component (the row's egress resource is
    always unioned with its ingress, so either endpoint labels it).

    Union-find over the ``2 * n_res`` resource nodes with one union per
    *distinct* resource pair — O(unique pairs + n_res), independent of the
    backlog's flow count.
    """
    span = 2 * n_res
    pairs = np.unique(rin * span + (rout + n_res))
    parent = list(range(span))

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for p in pairs.tolist():
        a, b = find(p // span), find(p % span)
        if a != b:
            parent[b] = a
    root_of = np.fromiter((find(r) for r in range(n_res)),
                          dtype=np.int64, count=n_res)
    return root_of[rin]


def _touched_rows(rin: np.ndarray, rout: np.ndarray, n_res: int,
                  n_new_from: int) -> np.ndarray:
    """Delta-scheduling touched set: which pending rows a new arrival can
    perturb.

    A batch of new rows (indices ``>= n_new_from``) can only change the
    tentative times of rows in resource components it touches:
    cross-component flows share no resource with any new flow, directly or
    transitively, so every availability horizon and first-pending-candidate
    test they see is unchanged (the not-all-stop property of the OCS model,
    applied to scheduling work instead of circuits). Returns a boolean row
    mask over the components of ``_resource_components``.
    """
    F = rin.size
    if n_new_from <= 0:
        return np.ones(F, dtype=bool)
    if n_new_from >= F:
        return np.zeros(F, dtype=bool)
    roots = _resource_components(rin, rout, n_res)
    return np.isin(roots, roots[n_new_from:])


class ComponentIndex:
    """Incremental resource-component index over the pending set.

    Maintains the union-find of ``_resource_components`` ACROSS ticks
    instead of rebuilding it from every pending row each tick: the pending
    set changes by small deltas (an arrival batch in, committed rows out,
    fault strand/requeue churn), so the index tracks the multiset of
    distinct ``(rin, rout)`` resource pairs and updates the union-find only
    for pairs entering or leaving. ``labels()`` then answers the per-tick
    component query in one vectorized pointer-jumping pass — replacing the
    two from-scratch union-finds (``_touched_rows`` + the telemetry call)
    the splice used to pay per tick, each O(F log F) in the backlog size.

    Exactness contract: after any add/remove sequence, ``labels()`` induces the
    SAME PARTITION of the pending rows as the from-scratch oracle
    ``_resource_components`` on the same rows. Raw label values may differ
    while the index is ahead of its last rebuild (union order differs from
    the oracle's sorted-pair order), but every consumer — the touched-row
    mask ``isin(roots, roots[seed])``, the component counts, the size
    histograms — is a partition function, so all computed schedules and
    telemetry are bit-identical either way. Removing the last copy of a
    pair can SPLIT a component, which a union-find cannot express
    incrementally; the index marks itself dirty and the next ``labels()``
    call rebuilds from the surviving pairs in sorted order (exactly the
    oracle's procedure — after a rebuild even the raw labels match).

    The internal arrays (``_parent``, the pair multiset) are committed
    scheduling state, mutated only by this class.
    """

    __slots__ = ("n_res", "span", "_count", "_parent", "_dirty")

    def __init__(self, n_res: int) -> None:
        self.n_res = int(n_res)
        #: node ids: ingress resource r -> r, egress resource r -> r + n_res
        self.span = 2 * self.n_res
        #: pair-key multiset: rin * span + (rout + n_res) -> multiplicity
        self._count: dict[int, int] = {}
        self._parent = np.arange(self.span, dtype=np.int64)
        self._dirty = False

    @property
    def n_pairs(self) -> int:
        """Distinct resource pairs currently present."""
        return len(self._count)

    def _find(self, x: int) -> int:
        parent = self._parent
        root = x
        while parent[root] != root:
            root = int(parent[root])
        while parent[x] != root:
            parent[x], x = root, int(parent[x])
        return root

    def add(self, rin: Annotated[I8, "B"],
            rout: Annotated[I8, "B"]) -> None:
        """Pending rows entered (arrival batch / fault requeue)."""
        count = self._count
        span, n_res = self.span, self.n_res
        for a, b in zip(rin.tolist(), rout.tolist()):
            b += n_res
            key = a * span + b
            c = count.get(key)
            if c:
                count[key] = c + 1
            else:
                count[key] = 1
                ra, rb = self._find(a), self._find(b)
                if ra != rb:
                    self._parent[rb] = ra

    def remove(self, rin: Annotated[I8, "B"],
               rout: Annotated[I8, "B"]) -> None:
        """Pending rows left (commit / fault strand).

        Dropping the last copy of a pair may split its component; the
        union-find can only merge, so the index goes dirty and the next
        ``labels()`` rebuilds from the surviving pairs.
        """
        count = self._count
        span, n_res = self.span, self.n_res
        for a, b in zip(rin.tolist(), rout.tolist()):
            key = a * span + (b + n_res)
            c = count[key] - 1
            if c:
                count[key] = c
            else:
                del count[key]
                self._dirty = True

    def _rebuild(self) -> None:
        """From-scratch union over the surviving pairs, in sorted-key order
        — the oracle's exact procedure (``_resource_components``), so the
        rebuilt parent forest is identical to a fresh one."""
        self._parent = np.arange(self.span, dtype=np.int64)
        span = self.span
        for key in sorted(self._count):
            a, b = self._find(key // span), self._find(key % span)
            if a != b:
                self._parent[b] = a
        self._dirty = False

    def labels(self, nodes: Annotated[I8, "Q"]) -> Annotated[I8, "Q"]:
        """Component label per node id (use ``labels(rin)`` for row labels,
        matching the oracle's ingress-root convention; egress nodes are
        ``r + n_res``). Vectorized pointer jumping — terminates because the
        parent forest is acyclic with self-loop roots."""
        if self._dirty:
            self._rebuild()
        parent = self._parent
        lab = parent[nodes]
        while True:
            nxt = parent[lab]
            if np.array_equal(nxt, lab):
                return lab
            lab = nxt


@dataclasses.dataclass(frozen=True)
class TickCommit:
    """Circuits committed by one ``FabricState`` tick, as flat ``(Fc,)``
    tensors on the state's device (int64 ids and ports, float64 sizes and
    times).

    ``gid`` is the stream-wide admission index of the flow's coflow (the
    service's coflow identity); ``cid`` echoes the submitted ``Coflow.cid``.
    ``finalized`` lists the coflows whose last flow committed this tick as
    ``(gid, cid, cct, weight)`` tuples — their CCT is now final.

    ``delta_f`` is the per-flow reconfiguration delay in force at commit
    time (``None`` = the fabric's uniform nominal delta; an array only after
    a ``fault.DeltaDrift``). ``faults`` lists the ``FaultApplication``
    records of injector events applied at this tick, and ``unfinalized``
    the gids whose previously reported final CCT those faults retracted.
    """

    t_now: float
    gid: torch.Tensor
    cid: torch.Tensor
    fi: torch.Tensor
    fj: torch.Tensor
    core: torch.Tensor
    size: torch.Tensor
    t_establish: torch.Tensor
    t_complete: torch.Tensor
    finalized: tuple         # ((gid, cid, cct, weight), ...)
    n_pending: int           # flows still tentative after this tick
    delta_f: torch.Tensor | None = None  # set after a DeltaDrift
    faults: tuple = ()       # (FaultApplication, ...) applied this tick
    unfinalized: tuple = ()  # gids whose final CCT was retracted this tick
    #: resource-sharing components in this tick's pending set, and how many
    #: of them the tick actually re-scheduled (delta-scheduling telemetry;
    #: both 0 when delta-scheduling is off, reserving, or nothing pends)
    components_total: int = 0
    components_touched: int = 0

    @property
    def n_flows(self) -> int:
        return int(self.gid.numel())


class FabricState:
    """Incremental online-scheduling state carried across service ticks.

    Usage: one ``step(coflows, releases, t_now)`` call per service tick.
    Admission contract (checked): tick times are non-decreasing, and every
    release lies in ``(previous tick time, t_now]`` — i.e. arrivals are
    admitted at the first tick at or after their release. ``finalize()``
    commits everything still pending (the end-of-stream tick at t=inf).

    The committed circuits across all ticks are bit-identical — same core
    choices, same establishment times — to one ``run_fast_online`` call over
    the whole stream (coflows indexed in admission order), which
    ``cross_check_incremental`` asserts.

    ``device`` (``None`` = CUDA, through ``resolve_device``; never a silent
    fall-back to the CPU) is where batches are extracted and where each
    ``TickCommit`` and ``ccts()`` come back; coflow demands must already be
    there.
    """

    def __init__(
        self,
        *,
        rates: Annotated[F8, "K"],
        delta: float,
        N: int,
        algorithm: str = "ours",
        scheduling: str = "work-conserving",
        seed: int = 0,
        faults: FaultInjector | None = None,
        track_commits: bool | None = None,
        delta_schedule: bool = True,
        fault_lookback: float = np.inf,
        tracer: Tracer | None = None,
        locality: float = 0.0,
        device: str | torch.device | None = None,
    ) -> None:
        policy, scheduling = _resolve_algorithm(algorithm, scheduling)
        if scheduling not in INCREMENTAL_SCHEDULINGS:
            raise ValueError(
                f"scheduling {scheduling!r} (algorithm {algorithm!r}) is "
                f"benchmark-only: the sunflow pick-next-at-core-free rule "
                f"cannot commit tick-by-tick and requires a full "
                f"run_fast_online replay (serve it via run_fast / "
                f"run_fast_online / run_batch); incremental scheduling "
                f"supports {INCREMENTAL_SCHEDULINGS}")
        # the concrete device (``cuda`` -> ``cuda:0``), as tensors report it
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.rates = _host_f64(rates)
        if self.rates.ndim != 1 or (self.rates <= 0).any():
            raise ValueError("rates must be a 1-D positive vector")
        self.delta = float(delta)
        self.N = int(N)
        self.K = int(self.rates.shape[0])
        self.R = float(self.rates.sum())
        self.algorithm = algorithm
        self.scheduling = scheduling
        #: phase tracer (repro.obs): purely observational — nothing the
        #: engine computes ever reads it, so NULL_TRACER (the default) and
        #: a recording tracer yield bit-identical schedules
        self._tracer: Tracer = NULL_TRACER if tracer is None else tracer
        #: fresh-port affinity bias (tau-aware only; see FlatAssignState):
        #: keeps each port's resources on few cores so the pending set's
        #: resource-sharing graph fragments — what gives delta-scheduling
        #: untouched components to splice
        self.locality = float(locality)
        self._assign = FlatAssignState(policy, self.rates, self.delta, self.N,
                                       seed=seed, locality=self.locality)
        n_res = self.K * self.N
        #: committed circuit horizons per (core, port) resource
        self.free_in = np.zeros(n_res)
        self.free_out = np.zeros(n_res)
        self.t_now = 0.0
        self._ticks = 0
        self._pend = {name: np.zeros(0, dtype=dt) for name, dt in _PEND_FIELDS}
        # -- delta-scheduling (touched-set) cache ---------------------------
        #: re-run the event loop only over the resource-sharing components a
        #: new arrival touches, splicing cached tentative times for the rest
        #: (bit-identical to the full tentative replay; see _touched_rows and
        #: cross_check_incremental's delta-vs-full gate)
        self.delta_schedule = bool(delta_schedule)
        #: cached tentative t_establish aligned row-for-row with ``_pend``;
        #: ``None`` = no valid cache (first tick, or a fault perturbed the
        #: pending set / horizons / delays out from under it)
        self._tent: np.ndarray | None = None
        #: per-row validity of ``_tent`` (same alignment): a fault
        #: invalidates only the rows whose components it actually perturbed
        #: (see ``_apply_fault``); invalid rows seed the next tick's touched
        #: set exactly like new arrivals. ``None`` iff ``_tent`` is None.
        self._tent_valid: np.ndarray | None = None
        #: escape hatch for the fault-scoped invalidation: ``False`` drops
        #: the whole cache on any fault; both settings commit bit-identical
        #: circuits
        self._fault_scoped_tent = True
        #: incremental component index maintained across ticks/faults; None
        #: when delta-scheduling is off or reserving commits everything
        #: immediately (no tentative rows to splice)
        self._cindex: ComponentIndex | None = (
            ComponentIndex(n_res)
            if delta_schedule and scheduling != "reserving" else None)
        #: delta-scheduling effectiveness counters (rows spliced from the
        #: cache vs rows re-run through the event loop, cumulative)
        self.tent_reused = 0
        self.tent_recomputed = 0
        #: tentative rows invalidated by fault-scoped cache surgery
        #: (cumulative; rows a full drop would also have re-derived)
        self.tent_invalidated = 0
        #: resource-component telemetry (cumulative over ticks): how many
        #: components the pending sets decomposed into, and how many of
        #: them ticks actually re-scheduled (delta-scheduling leverage)
        self.components_total = 0
        self.components_touched = 0
        #: per-tick component-size histograms (cumulative over ticks):
        #: {rows-per-component: occurrences} for every component seen, and
        #: for the components whose cached rows were spliced untouched —
        #: the *where does the splice fail* diagnostic
        self.component_size_hist: dict[int, int] = {}
        self.component_reused_hist: dict[int, int] = {}
        # per-gid registry (appended at admission)
        self._cid: list[int] = []
        self._weight: list[float] = []
        self._release: list[float] = []
        self._nflows: list[int] = []
        self._ndone: list[int] = []
        self._cct: list[float] = []
        # -- fault model (core.fault) ---------------------------------------
        #: scripted fault schedule; ``step`` pops events due at each tick
        self.faults = faults
        #: retain committed circuits so faults can classify them; on by
        #: default whenever an injector is present (FabricManager always
        #: turns it on so report_fault works). With zero fault events the
        #: retention changes no computed value — the zero-event injector is
        #: bit-identical to a plain FabricState.
        if track_commits is None:
            track_commits = faults is not None
        self.track_commits = bool(track_commits)
        self._commit = (
            {name: np.zeros(0, dtype=dt) for name, dt in _COMMIT_FIELDS}
            if self.track_commits else None)
        # -- committed-circuit retention GC ---------------------------------
        #: how far back a late-discovered fault may be timestamped; commits
        #: completing at or before ``t_now - fault_lookback`` can never be
        #: classified by an admissible event and are dropped (watermark GC)
        if not fault_lookback >= 0:
            raise ValueError("fault_lookback must be >= 0 (np.inf = retain "
                             "every commit forever)")
        self.fault_lookback = float(fault_lookback)
        self._gc_floor = -np.inf  # commits with t_comp <= floor are gone
        self.commits_gced = 0     # exact count of GCed commit rows
        #: per-gid max completion among GCed commits: keeps the running-CCT
        #: rollback exact when a fault unfinalizes a coflow whose earlier
        #: circuits were already collected
        self._gc_cct: list[float] = []
        self.core_up = np.ones(self.K, dtype=bool)
        #: per-core reconfiguration delay (DeltaDrift moves entries)
        self.delta_k = np.full(self.K, self.delta)
        self._drifted = False
        #: port-flap blackout floors per (core, port) resource
        self._flap_in = np.zeros(n_res)
        self._flap_out = np.zeros(n_res)
        self.fault_log: list = []  # FaultApplication records, in order

    # -- registry views ----------------------------------------------------
    @property
    def n_coflows(self) -> int:
        """Coflows admitted so far (finalized or not)."""
        return len(self._cid)

    @property
    def commit_floor(self) -> float:
        """Latest committed decision boundary: releases at or before it can
        no longer be admitted bit-exactly (-inf before the first tick)."""
        return self.t_now if self._ticks else -np.inf

    @property
    def n_pending_flows(self) -> int:
        return int(self._pend["gid"].size)

    @property
    def delta_drifted(self) -> bool:
        """True while any core's reconfiguration delay is off-nominal."""
        return bool(self._drifted)

    @property
    def n_commits_retained(self) -> int:
        """Committed circuits currently retained for fault classification
        (0 without commit tracking)."""
        c = self._commit
        return int(c["gid"].size) if c is not None else 0

    def ccts(self) -> torch.Tensor:
        """Running per-coflow CCTs ``(G,)`` float64, indexed by gid (final
        once finalized), on the state's device."""
        return self._to_device(np.asarray(self._cct, dtype=np.float64))

    def weights(self) -> torch.Tensor:
        return self._to_device(np.asarray(self._weight, dtype=np.float64))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- fault model --------------------------------------------------------
    def aborted_keys(self) -> set:
        """Program-segment keys of every circuit aborted by a fault so far
        (see ``fault.AbortedCircuit.key``) — the stream-wide program must
        exclude these segments (``service.FabricManager.program`` does)."""
        return {a.key for app in self.fault_log for a in app.aborted}

    def _rebuild_horizons(self) -> None:
        """Recompute the committed-circuit horizons from the retained
        commits, then fold in flap floors and failed-core ``+inf``.

        ``max`` is an exact selection, so the rebuilt values equal what the
        incremental ``np.maximum.at`` updates accumulated — minus the
        contributions of circuits a fault just aborted.
        """
        n_res = self.K * self.N
        free_in = np.zeros(n_res)
        free_out = np.zeros(n_res)
        c = self._commit
        if c is not None and c["gid"].size:
            np.maximum.at(free_in, c["core"] * self.N + c["fi"], c["t_comp"])
            np.maximum.at(free_out, c["core"] * self.N + c["fj"], c["t_comp"])
        np.maximum(free_in, self._flap_in, out=free_in)
        np.maximum(free_out, self._flap_out, out=free_out)
        down = np.repeat(~self.core_up, self.N)
        free_in[down] = np.inf
        free_out[down] = np.inf
        self.free_in = free_in
        self.free_out = free_out

    @effects("commit-mutate", "watermark")
    def _gc_commits(self, t_now: float) -> None:
        """Watermark GC over the retained commits (satellite of the fault
        model): a fault discovered late may be timestamped no earlier than
        ``t_now - fault_lookback``, and classification only aborts circuits
        with ``t_comp > t_fault``, so commits completing at or before the
        watermark can never be aborted again — drop them.

        Dropping is also invisible to scheduling: a GCed ``t_comp`` is
        ``<= gc_floor <= t_now``, and every future event-loop seed /
        reservation start is ``>= t_now`` (``max`` semantics make values at
        or below ``t0`` equivalent), so horizon rebuilds after later faults
        compute the same floats with or without the dropped rows. The only
        value they still feed — a re-opened coflow's running CCT — is kept
        exact through the per-gid ``_gc_cct`` max.
        """
        if not np.isfinite(self.fault_lookback):
            return
        if np.isfinite(t_now):
            # finalize()'s t=inf tick is end-of-stream bookkeeping, not the
            # passage of time: it does not advance the watermark
            wm = t_now - self.fault_lookback
            if wm > self._gc_floor:
                self._gc_floor = wm
        c = self._commit
        if c is None or not c["gid"].size or self._gc_floor == -np.inf:  # reprolint: disable=float-eq -- -inf is an exact sentinel (never produced by arithmetic)
            return
        drop = c["t_comp"] <= self._gc_floor
        n_drop = int(drop.sum())
        if not n_drop:
            return
        for g, v in zip(c["gid"][drop].tolist(), c["t_comp"][drop].tolist()):
            if v > self._gc_cct[g]:
                self._gc_cct[g] = v
        self._commit = {name: c[name][~drop] for name, _dt in _COMMIT_FIELDS}
        self.commits_gced += n_drop

    def _requeue(self, moved: dict, t_f: float, bump_release: np.ndarray
                 ) -> None:
        """Reassign flows over the up cores and append them to the pending
        set. ``moved`` holds ``_PEND_FIELDS`` arrays; rows with
        ``bump_release`` True (aborted in-flight circuits) can restart no
        earlier than the fault time ``t_f``."""
        rel = moved["rel"].copy()
        rel[bump_release] = np.maximum(rel[bump_release], t_f)
        order = np.lexsort((moved["intra"], moved["gid"]))
        fi, fj = moved["fi"][order], moved["fj"][order]
        sizes = moved["size"][order]
        core = self._assign.assign(
            torch.from_numpy(fi), torch.from_numpy(fj),
            torch.from_numpy(sizes), up=self.core_up).numpy()
        if self._cindex is not None:
            self._cindex.add(core * self.N + fi, core * self.N + fj)
        add = {
            "gid": moved["gid"][order], "cid": moved["cid"][order],
            "fi": fi, "fj": fj, "core": core, "size": sizes,
            "srv": sizes / self.rates[core], "rel": rel[order],
            "score": moved["score"][order], "intra": moved["intra"][order],
        }
        self._pend = {
            name: np.concatenate([self._pend[name], add[name]])
            for name, _dt in _PEND_FIELDS
        }

    @effects("commit-mutate", "fingerprint-mutate", "watermark",
             "rng-consume", "trace-emit")
    def apply_fault(self, event: FaultEvent) -> FaultApplication:
        """Apply one topology-churn event (see ``core.fault``) right now.

        Committed circuits interrupted by the event are aborted (their
        demand re-queued, reassigned over the surviving cores, their ports'
        horizons rolled back), tentative flows stranded on a failed core are
        reassigned, and retracted final CCTs are reported. Returns the
        ``FaultApplication`` record; ``step`` calls this for every injector
        event due at a tick, ``service.FabricManager.report_fault`` for
        events discovered between ticks. The recovery is recorded as one
        ``fault/recover`` span carrying the abort/requeue counts.
        """
        with self._tracer.span("fault/recover") as sp:
            inv0 = self.tent_invalidated
            app = self._apply_fault(event)
            if sp.live:
                sp.set(event=type(app.event).__name__,
                       aborted=app.n_aborted, requeued=app.requeued,
                       reassigned=app.reassigned_pending,
                       unfinalized=len(app.unfinalized),
                       invalidated=self.tent_invalidated - inv0)
            return app

    @effects("commit-mutate", "fingerprint-mutate", "watermark",
             "rng-consume")
    def _apply_fault(self, event: FaultEvent) -> FaultApplication:
        if not isinstance(event, FAULT_EVENTS):
            raise TypeError(
                f"unknown fault event {event!r}; one of "
                f"{[cls.__name__ for cls in FAULT_EVENTS]}")
        t_f = float(event.t)
        k = int(event.core)
        if not 0 <= k < self.K:
            raise ValueError(f"core {k} out of range for K={self.K}")
        # Scoped tentative-cache invalidation:
        # each event type stales only the rows whose next-tick estimates can
        # actually change — components never span cores, so the blast radius
        # of a fault on core k is expressible as a row mask or a component
        # set. `_fault_scoped_tent=False` drops the whole cache instead
        # (both commit bit-identical circuits).
        if not self._fault_scoped_tent:
            if self._tent is not None and self.delta_schedule:
                self.tent_invalidated += int(self._tent.size)
            self._tent = None
            self._tent_valid = None

        def _stale(mask: np.ndarray) -> None:
            # mark cached rows stale; they seed the next tick's dirty set
            if (self._tent is None or self._tent_valid is None
                    or not self.delta_schedule):
                return
            flip = mask & self._tent_valid
            n = int(flip.sum())
            if n:
                self._tent_valid[flip] = False
                self.tent_invalidated += n

        def _done(aborted: Sequence = (), requeued: int = 0,
                  reassigned: int = 0,
                  unfinalized: Sequence = ()) -> FaultApplication:
            app = FaultApplication(
                event=event, aborted=tuple(aborted), requeued=int(requeued),
                reassigned_pending=int(reassigned),
                unfinalized=tuple(unfinalized))
            self.fault_log.append(app)
            return app

        if isinstance(event, DeltaDrift):
            self.delta_k[k] = float(event.delta)
            self._drifted = bool(np.any(self.delta_k != self.delta))
            self._assign.set_delta(k, float(event.delta))
            # the reconfiguration delay is priced per core: only core-k
            # rows (= the union of core-k components) see new estimates
            _stale(self._pend["core"] == k)
            return _done()

        if isinstance(event, CoreUp):
            if self.core_up[k]:
                raise ValueError(f"core {k} is already up")
            self.core_up[k] = True
            # The dead core delivered nothing while down and its interrupted
            # circuits were re-queued elsewhere, so its true future load is
            # zero: reset the greedy assignment state's view of it, or the
            # stale historical load would under-use the recovered core
            # indefinitely (it converges back toward the healthy mix).
            self._assign.reset_core(k)
            self._rebuild_horizons()
            # no cache invalidation: the commit set is unchanged (so the
            # rebuilt horizons hold the same floats) and a recovered core
            # has no pending rows — every cached estimate stands
            return _done()

        # CoreDown / PortFlap must classify the committed circuits.
        if self._commit is None:
            raise RuntimeError(
                "this FabricState was built without commit tracking and "
                "cannot classify committed circuits on a "
                f"{type(event).__name__}; rebuild it with "
                "track_commits=True or a FaultInjector")
        if t_f < self._gc_floor:
            raise ValueError(
                f"fault at t={t_f} predates the committed-circuit retention "
                f"watermark t={self._gc_floor} (fault_lookback="
                f"{self.fault_lookback}): the commits it would classify have "
                f"been garbage-collected; widen fault_lookback or report "
                f"faults sooner")
        c = self._commit
        strand = np.zeros(self._pend["gid"].size, dtype=bool)
        if isinstance(event, CoreDown):
            if not self.core_up[k]:
                raise ValueError(f"core {k} is already down")
            if self.core_up.sum() == 1:
                raise RuntimeError(
                    f"cannot fail core {k}: it is the last core up "
                    f"(fabric lost)")
            self.core_up[k] = False
            # in-flight (or not-yet-established but already programmed)
            # circuits on the core deliver nothing; completed ones are kept
            abort = (c["core"] == k) & (c["t_comp"] > t_f)
            strand = self._pend["core"] == k
        else:  # PortFlap
            p = int(event.port)
            if not 0 <= p < self.N:
                raise ValueError(f"port {p} out of range for N={self.N}")
            t_end = float(event.t_end)
            r = k * self.N + p
            self._flap_in[r] = max(self._flap_in[r], t_end)
            self._flap_out[r] = max(self._flap_out[r], t_end)
            touches = (c["core"] == k) & ((c["fi"] == p) | (c["fj"] == p))
            abort = touches & (c["t_est"] < t_end) & (c["t_comp"] > t_f)

        aborted_rows = {name: c[name][abort] for name, _dt in _COMMIT_FIELDS}
        self._commit = {name: c[name][~abort] for name, _dt in _COMMIT_FIELDS}
        # PortFlap: the flap floor rose on resource r and the aborted
        # circuits' horizon rollback moves their endpoint resources — stale
        # every cached row whose component reaches one of those nodes.
        # (CoreDown needs no mask: components never span cores, so the
        # blast radius is exactly the strand rows removed below, and the
        # survivors' horizons keep their untouched-core floats.)
        if (isinstance(event, PortFlap) and self._cindex is not None
                and self._tent is not None and self._pend["gid"].size):
            nr = self._cindex.n_res
            ab_core = aborted_rows["core"]
            nodes = np.unique(np.concatenate([
                np.asarray([r, r + nr], dtype=np.int64),
                (ab_core * self.N + aborted_rows["fi"]).astype(np.int64),
                (ab_core * self.N + aborted_rows["fj"]).astype(np.int64)
                + nr,
            ]))
            row_lab = self._cindex.labels(
                (self._pend["core"] * self.N
                 + self._pend["fi"]).astype(np.int64))
            _stale(np.isin(row_lab, self._cindex.labels(nodes)))
        # stranded rows leave the pending set (and so the index); their
        # re-queued successors re-enter through _requeue's add below
        if self._cindex is not None and strand.any():
            pr = self._pend["core"][strand] * self.N
            self._cindex.remove(pr + self._pend["fi"][strand],
                                pr + self._pend["fj"][strand])
        records = tuple(
            AbortedCircuit(
                gid=int(aborted_rows["gid"][x]),
                cid=int(aborted_rows["cid"][x]),
                i=int(aborted_rows["fi"][x]), j=int(aborted_rows["fj"][x]),
                core=int(aborted_rows["core"][x]),
                size=float(aborted_rows["size"][x]),
                t_establish=float(aborted_rows["t_est"][x]),
                t_abort=t_f)
            for x in range(aborted_rows["gid"].size))
        # registry rollback: a finalized coflow losing a circuit is
        # un-finalized; its running CCT is recomputed from what survives
        unfinalized = []
        gids_ab, counts_ab = np.unique(aborted_rows["gid"],
                                       return_counts=True)
        for g, n in zip(gids_ab.tolist(), counts_ab.tolist()):
            if self._ndone[g] == self._nflows[g]:
                unfinalized.append(g)
            self._ndone[g] -= n
            # recompute the running CCT from what survives; GCed circuits of
            # this coflow (inside the watermark they completed, so they can
            # no longer be aborted) contribute through the exact per-gid max
            rem = self._commit["t_comp"][self._commit["gid"] == g]
            base = self._gc_cct[g]
            self._cct[g] = float(max(float(rem.max()), base)) if rem.size \
                else base

        moved = {
            name: np.concatenate(
                [aborted_rows[name], self._pend[name][strand]])
            for name, _dt in _PEND_FIELDS
        }
        self._pend = {name: self._pend[name][~strand]
                      for name, _dt in _PEND_FIELDS}
        if moved["gid"].size:
            bump = np.zeros(moved["gid"].size, dtype=bool)
            bump[:aborted_rows["gid"].size] = True
            self._requeue(moved, t_f, bump)
        # realign the tentative cache with the post-fault pending set:
        # drop strand entries, append invalid placeholders for re-queued
        # rows (placeholders are never spliced — an invalid row always
        # seeds the dirty set, so its component re-runs the event loop)
        if self._tent is not None and self._tent_valid is not None:
            if self._tent.size != strand.size:
                self._tent = None
                self._tent_valid = None
            else:
                if strand.any():
                    if self.delta_schedule:
                        self.tent_invalidated += int(
                            self._tent_valid[strand].sum())
                    self._tent = self._tent[~strand]
                    self._tent_valid = self._tent_valid[~strand]
                n_add = int(self._pend["gid"].size) - self._tent.size
                if n_add > 0:
                    self._tent = np.concatenate(
                        [self._tent, np.zeros(n_add)])
                    self._tent_valid = np.concatenate(
                        [self._tent_valid, np.zeros(n_add, dtype=bool)])
        self._rebuild_horizons()
        return _done(aborted=records, requeued=aborted_rows["gid"].size,
                     reassigned=int(strand.sum()), unfinalized=unfinalized)

    # -- admission + scheduling -------------------------------------------
    def _admit(self, coflows: Sequence[Coflow],
               releases: np.ndarray) -> dict:
        """Register a batch and return its pending-flow arrays in
        within-batch arrival order (release, then WSPT score desc, then
        submission order) — the global arrival order's restriction to the
        batch, since every earlier admission has a strictly earlier
        release bucket.

        The batch's demand is stacked on the device (one ``(B, N, N)``
        tensor); its WSPT scores and its flows are computed there, and the
        flows come to the host once for the assignment and the loops."""
        B = len(coflows)
        gid0 = self.n_coflows
        for c in coflows:
            if c.n_ports != self.N:
                raise ValueError(
                    f"coflow {c.cid} has N={c.n_ports}, fabric has N={self.N}")
            if c.demand.device != self.device:
                raise ValueError(
                    f"coflow {c.cid}'s demand is on {c.demand.device}, but "
                    f"the fabric runs on {self.device}")
        # the batch's WSPT scores, through the one shared definition (scores
        # are per-coflow, so the batch sub-instance computes the same floats
        # the full-stream replay would). Scores price the *surviving* fabric
        # (R over up cores): with a core down from t=0 this is exactly the
        # (K-1)-core instance's score; with every core up the masked view
        # holds the same floats.
        sub = instance_from_coflows(coflows, self.rates[self.core_up],
                                    self.delta, n_ports=self.N,
                                    device=self.device)
        scores = priority_scores(sub).cpu().numpy()
        nflows = (sub.demand > 0).sum(dim=(1, 2)).tolist()
        for c, r, n in zip(coflows, releases, nflows):
            self._cid.append(int(c.cid))
            self._weight.append(float(c.weight))
            self._release.append(float(r))
            self._nflows.append(int(n))
            self._ndone.append(0)
            self._cct.append(0.0)
            self._gc_cct.append(0.0)
        order = np.lexsort((np.arange(B), -scores, releases))
        # flows in batch-arrival order: position p of `order` is coflow
        # order[p], so `pos` indexes the re-sorted batch
        flows = extract_flows(sub, torch.from_numpy(order).to(self.device))
        pos, cid, fi, fj, sizes = (t.cpu() for t in flows)
        core = self._assign.assign(
            fi, fj, sizes,
            up=None if self.core_up.all() else self.core_up).numpy()
        pos, cid, fi, fj, sizes = (t.numpy() for t in (pos, cid, fi, fj,
                                                        sizes))
        gid = gid0 + order[pos]
        srv = sizes / self.rates[core]
        counts = np.bincount(pos, minlength=B)
        starts = np.cumsum(counts) - counts
        intra = np.arange(pos.size) - starts[pos]
        return {
            "gid": gid, "cid": cid,
            "fi": fi, "fj": fj, "core": core, "size": sizes, "srv": srv,
            "rel": releases[order][pos], "score": scores[order][pos],
            "intra": intra,
        }

    @effects("commit-mutate", "fingerprint-mutate", "watermark",
             "rng-consume", "trace-emit")
    def step(self, coflows: Sequence[Coflow],
             releases: Annotated[F8, "B"], t_now: float) -> TickCommit:
        """One service tick: admit ``coflows`` (released in
        ``(previous tick, t_now]``), schedule all pending flows against the
        committed horizons, and commit every circuit establishing at or
        before ``t_now``."""
        t_now = float(t_now)
        releases = _host_f64(releases)
        if len(coflows) != releases.size:
            raise ValueError(
                f"got {len(coflows)} coflows but {releases.size} releases")
        if t_now < self.t_now:
            raise ValueError(
                f"tick times must be non-decreasing: {t_now} < {self.t_now}")
        if releases.size:
            lo = releases.min()
            if lo < 0:
                raise ValueError("release times must be >= 0")
            if self._ticks and lo <= self.t_now:
                raise ValueError(
                    f"late arrival: release {lo} is not after the previous "
                    f"tick at t={self.t_now} — its circuits may already be "
                    f"committed (clamp the release or tick more often)")
            if releases.max() > t_now:
                raise ValueError(
                    f"cannot admit a coflow released at {releases.max()} at "
                    f"tick t={t_now}; queue it until its release")
        # Topology churn due at this tick is applied after argument
        # validation (so a rejected batch consumes no injector events) and
        # BEFORE admission: the control plane learns of a fault when it
        # wakes, so this tick's arrivals are assigned over the surviving
        # cores and the tentative schedule below is re-derived for them.
        fault_apps = ()
        if self.faults is not None:
            fault_apps = tuple(
                self.apply_fault(ev) for ev in self.faults.pop_due(t_now))
        t_prev = self.t_now
        n_old = self._pend["gid"].size
        if len(coflows):
            with self._tracer.span("tick/assign") as sp_as:
                batch = self._admit(coflows, releases)
                if sp_as.live:
                    sp_as.set(coflows=len(coflows),
                              flows=int(batch["gid"].size))
            pend = {
                name: np.concatenate([self._pend[name], batch[name]])
                for name, _dt in _PEND_FIELDS
            }
        else:
            pend = self._pend
        n_res = self.K * self.N
        rin = pend["core"] * self.N + pend["fi"]
        rout = pend["core"] * self.N + pend["fj"]
        # keep the incremental component index in lock-step with the
        # pending set: the arrival batch's resource pairs enter here
        if self._cindex is not None and rin.size > n_old:
            self._cindex.add(rin[n_old:], rout[n_old:])
        # per-flow reconfiguration delay; scalar fast path unless a
        # DeltaDrift moved some core off the nominal delta
        dl_f = None if not self._drifted else self.delta_k[pend["core"]]
        comp_total = comp_touched = 0
        if self.scheduling == "reserving":
            # Reservations commit immediately in arrival order and never
            # move, so the horizon arrays ARE the reservation state.
            with self._tracer.span("tick/event_loop") as sp_ev:
                t_est = _reserving_times(
                    rin, rout, pend["srv"],
                    self.delta if dl_f is None else dl_f, n_res,
                    release=pend["rel"], avail_in=self.free_in,
                    avail_out=self.free_out)
                if sp_ev.live:
                    sp_ev.set(rows=int(t_est.size), reserving=True)
            commit = np.ones(t_est.size, dtype=bool)
        else:
            # Delta-scheduling: tentative times are stable across ticks
            # unless new competitors share a resource component (the same
            # invariant behind commit finality — an event at or before the
            # previous tick can't be changed by later arrivals; an event
            # after it can only be changed by flows in the same component).
            # So the cached tentative times of untouched components are
            # spliced, and only the touched rows re-run the event loop.
            F = rin.size
            with self._tracer.span("tick/splice") as sp_spl:
                t_est = np.empty(F)
                # ONE component query per tick: the incremental index
                # answers both the touched-row mask and the telemetry the
                # splice used to derive from two from-scratch union-finds
                # (_touched_rows + _resource_components, the oracle pair
                # the differential suites still pin this against)
                roots = (self._cindex.labels(rin)
                         if self.delta_schedule and F else None)
                n_invalid = 0
                if (self.delta_schedule and self._tent is not None
                        and self._tent.size == n_old and n_old):
                    t_est[:n_old] = self._tent
                    # seeds = new arrivals + rows a fault invalidated; the
                    # dirty set is every row sharing a component with one
                    seed = np.zeros(F, dtype=bool)
                    seed[n_old:] = True
                    if self._tent_valid is not None:
                        invalid = ~self._tent_valid
                        n_invalid = int(invalid.sum())
                        seed[:n_old] |= invalid
                    touched = (np.unique(roots[seed]) if seed.any()
                               else roots[:0])
                    dirty = (np.isin(roots, touched) if touched.size
                             else np.zeros(F, dtype=bool))
                else:
                    dirty = np.ones(F, dtype=bool)
                    touched = None
                if roots is not None:
                    uniq, cnts = np.unique(roots, return_counts=True)
                    comp_total = int(uniq.size)
                    if touched is None:
                        comp_touched = comp_total
                        reused_cnts = cnts[:0]
                    elif touched.size:
                        comp_touched = int(touched.size)
                        reused_cnts = cnts[~np.isin(uniq, touched)]
                    else:
                        comp_touched = 0
                        reused_cnts = cnts
                    hist = self.component_size_hist
                    for s_, n_ in zip(*np.unique(cnts, return_counts=True)):
                        s_ = int(s_)
                        hist[s_] = hist.get(s_, 0) + int(n_)
                    if reused_cnts.size:
                        hist = self.component_reused_hist
                        for s_, n_ in zip(*np.unique(reused_cnts,
                                                     return_counts=True)):
                            s_ = int(s_)
                            hist[s_] = hist.get(s_, 0) + int(n_)
                sub = np.nonzero(dirty)[0]
                self.tent_reused += int(F - sub.size)
                self.tent_recomputed += int(sub.size)
                if sp_spl.live:
                    sp_spl.set(reused=int(F - sub.size),
                               recomputed=int(sub.size),
                               invalidated=n_invalid,
                               components_total=comp_total,
                               components_touched=comp_touched)
            if sub.size:
                # Priority order: WSPT score desc, admission index,
                # intra-coflow extraction order — the global arrival
                # pipeline's flow order restricted to the (touched) pending
                # set; a component's restriction equals the global order's
                # restriction because components share no resources.
                with self._tracer.span("tick/event_loop") as sp_ev:
                    perm = np.lexsort((pend["intra"][sub], pend["gid"][sub],
                                       -pend["score"][sub]))
                    s = sub[perm]
                    te = _event_loop(
                        rin[s], rout[s], pend["srv"][s], pend["core"][s],
                        self.delta if dl_f is None else dl_f[s], n_res,
                        self.N, t0=t_prev,
                        guard=(self.scheduling == "priority-guard"),
                        release=pend["rel"][s],
                        free_in0=self.free_in, free_out0=self.free_out)
                    t_est[s] = te
                    if sp_ev.live:
                        sp_ev.set(rows=int(sub.size))
            commit = t_est <= t_now
        if dl_f is None:
            tc = (t_est[commit] + self.delta) + pend["srv"][commit]
        else:
            tc = (t_est[commit] + dl_f[commit]) + pend["srv"][commit]
        if self.scheduling != "reserving":
            np.maximum.at(self.free_in, rin[commit], tc)
            np.maximum.at(self.free_out, rout[commit], tc)
        if self.track_commits:
            newc = {name: pend[name][commit] for name, _dt in _PEND_FIELDS}
            newc["t_est"] = t_est[commit]
            newc["t_comp"] = tc
            self._commit = {
                name: np.concatenate([self._commit[name], newc[name]])
                for name, _dt in _COMMIT_FIELDS}
            self._gc_commits(t_now)
        finalized = []
        for g, v in zip(pend["gid"][commit].tolist(), tc.tolist()):
            self._ndone[g] += 1
            if v > self._cct[g]:
                self._cct[g] = v
            if self._ndone[g] == self._nflows[g]:
                finalized.append((g, self._cid[g], self._cct[g],
                                  self._weight[g]))
        if len(coflows):
            # zero-flow coflows finalize at admission with CCT 0.0
            for g in range(self.n_coflows - len(coflows), self.n_coflows):
                if self._nflows[g] == 0:
                    finalized.append((g, self._cid[g], 0.0, self._weight[g]))
        dev = self._to_device
        out = TickCommit(
            t_now=t_now,
            gid=dev(pend["gid"][commit]), cid=dev(pend["cid"][commit]),
            fi=dev(pend["fi"][commit]), fj=dev(pend["fj"][commit]),
            core=dev(pend["core"][commit]), size=dev(pend["size"][commit]),
            t_establish=dev(t_est[commit]), t_complete=dev(tc),
            finalized=tuple(finalized),
            n_pending=int((~commit).sum()),
            delta_f=None if dl_f is None else dev(dl_f[commit]),
            faults=fault_apps,
            unfinalized=tuple(
                g for app in fault_apps for g in app.unfinalized),
            components_total=comp_total,
            components_touched=comp_touched,
        )
        self.components_total += comp_total
        self.components_touched += comp_touched
        if self._cindex is not None and commit.any():
            self._cindex.remove(rin[commit], rout[commit])
        self._pend = {name: pend[name][~commit] for name, _dt in _PEND_FIELDS}
        if self.scheduling == "reserving":
            self._tent = None
            self._tent_valid = None
        else:
            self._tent = t_est[~commit]
            # every surviving row was either spliced from a valid cache
            # entry or just re-derived by the event loop: all valid
            self._tent_valid = np.ones(self._tent.size, dtype=bool)
        self.t_now = t_now
        self._ticks += 1
        return out

    def finalize(self) -> TickCommit:
        """End-of-stream tick: commit every still-pending circuit."""
        return self.step((), (), np.inf)


def _assert_commits_equal(a: TickCommit, b: TickCommit, t: float) -> None:
    """Bit-exact equality of two TickCommits (delta-vs-full replay gate)."""
    for field in ("gid", "cid", "fi", "fj", "core", "size",
                  "t_establish", "t_complete"):
        va, vb = getattr(a, field), getattr(b, field)
        if not torch.equal(va.cpu(), vb.cpu()):
            raise AssertionError(
                f"delta-scheduling/full-replay divergence at tick t={t}: "
                f"{field} differs ({va!r} vs {vb!r})")
    if a.finalized != b.finalized or a.n_pending != b.n_pending:
        raise AssertionError(
            f"delta-scheduling/full-replay divergence at tick t={t}: "
            f"finalized/pending bookkeeping differs")


def cross_check_incremental(
    oinst: OnlineInstance,
    algorithm: str = "ours",
    *,
    seed: int = 0,
    scheduling: str = "work-conserving",
    n_ticks: int = 8,
    tick_times: Annotated[F8, "T"] | None = None,
    compare_delta: bool = True,
) -> list[TickCommit]:
    """Differential gate for the incremental path: FabricState vs full replay.

    Streams ``oinst``'s coflows through a ``FabricState`` on the instance's
    device, tick by tick (``tick_times``, or ``n_ticks`` evenly spaced over
    the arrival span), and asserts that the union of committed circuits is
    BIT-IDENTICAL -- same flow set, same core choices, same establishment
    times, same per-coflow CCTs -- to one ``run_fast_online`` call (fp64
    backend) over the whole stream. The replay instance lists coflows in
    admission order (the service's identity order), which only re-labels
    ``oinst`` when releases are untied.

    ``compare_delta`` additionally drives a second ``FabricState`` with
    delta-scheduling disabled (full tentative replay every tick) through the
    identical tick sequence and asserts every tick's commit is bit-identical
    to the delta-scheduled state's. Returns the per-tick commits.
    """
    inst = oinst.inst
    dev = inst.device
    rel = oinst.releases.cpu().numpy()
    if tick_times is None:
        hi = float(rel.max()) if rel.size else 0.0
        tick_times = (np.linspace(hi / n_ticks, hi, n_ticks)
                      if hi > 0 else np.zeros(1))
    ticks = [float(t) for t in tick_times]
    if rel.size and (not ticks or ticks[-1] < float(rel.max())):
        ticks.append(float(rel.max()))
    batches, prev = [], -np.inf
    for T in ticks:
        batches.append(np.nonzero((rel > prev) & (rel <= T))[0])
        prev = T
    perm = np.concatenate(batches)
    if perm.size != inst.M:
        raise AssertionError("tick partition lost coflows (non-monotone ticks?)")
    perm_t = torch.from_numpy(perm).to(dev)
    replay = OnlineInstance(
        inst=dataclasses.replace(inst, demand=inst.demand[perm_t],
                                 weights=inst.weights[perm_t],
                                 cids=inst.cids[perm_t]),
        releases=rel[perm])
    fast = run_fast_online(replay, algorithm, seed=seed,
                           scheduling=scheduling, backend="numpy")

    cids, weights = inst.cids.tolist(), inst.weights.tolist()
    coflows = [Coflow(cid=cids[m], demand=inst.demand[m], weight=weights[m])
               for m in range(inst.M)]
    kw = dict(rates=inst.rates, delta=inst.delta, N=inst.N,
              algorithm=algorithm, scheduling=scheduling, seed=seed,
              device=dev)
    st = FabricState(delta_schedule=True, **kw)
    st_full = (FabricState(delta_schedule=False, **kw)
               if compare_delta else None)
    commits = []
    for T, ids in zip(ticks, batches):
        cofs = [coflows[int(m)] for m in ids]
        commits.append(st.step(cofs, rel[ids], T))
        if st_full is not None:
            _assert_commits_equal(
                commits[-1], st_full.step(cofs, rel[ids], T), T)
    commits.append(st.finalize())
    if st_full is not None:
        _assert_commits_equal(commits[-1], st_full.finalize(), np.inf)
        if not torch.equal(st.ccts(), st_full.ccts()):
            raise AssertionError(
                "delta-scheduling/full-replay CCT divergence")
    if st.n_pending_flows:
        raise AssertionError("finalize left pending flows")

    inc = {}
    for c in commits:
        rows = zip(c.gid.tolist(), c.fi.tolist(), c.fj.tolist(),
                   c.core.tolist(), c.t_establish.tolist())
        for g, i, j, k, te in rows:
            if (g, i, j) in inc:
                raise AssertionError(f"flow {(g, i, j)} committed twice")
            inc[(g, i, j)] = (k, te)
    orig = fast.pi[fast.pos]
    ref = {(g, i, j): (k, te) for g, i, j, k, te in zip(
        orig.tolist(), fast.fi.tolist(), fast.fj.tolist(), fast.core.tolist(),
        fast.t_establish.tolist())}
    if set(inc) != set(ref):
        raise AssertionError(
            f"incremental/replay flow sets differ ({algorithm}, {scheduling}): "
            f"{len(inc)} vs {len(ref)} flows")
    for key, (core, te) in inc.items():
        if ref[key] != (core, te):
            raise AssertionError(
                f"incremental/replay mismatch at {key}: core/t_establish "
                f"{(core, te)!r} vs {ref[key]!r}")
    got = st.ccts()
    if not torch.equal(got, fast.ccts):
        worst = int(torch.argmax((got != fast.ccts).to(torch.int8)))
        raise AssertionError(
            f"incremental/replay CCT mismatch at gid {worst}: "
            f"{float(got[worst])!r} vs {float(fast.ccts[worst])!r}")
    return commits
