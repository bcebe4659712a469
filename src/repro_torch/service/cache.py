"""Circuit-program cache: canonical instance hashing + LRU storage.

The port of ``repro.service.cache``. ``instance_key`` hashes the same
float64 bytes in the same order as the reference's, so one request gives
the reference's hex digest; the instance's tensors are read back to the
host once for it.

Datacenter traffic is highly repetitive — a training job replays the same
collective phases every step, so the same demand pattern reaches the fabric
manager over and over. ``instance_key`` derives a canonical content hash of
everything the scheduling pipeline reads (demand tensors, weights, rates,
delta, releases, algorithm/scheduling/seed/backend), and ``ProgramCache`` is
a bounded LRU over it: a hit returns the previously compiled
:class:`~repro_torch.service.program.CircuitProgram` and skips the engine
entirely. Correctness is cheap to state: the pipeline is a deterministic
function of exactly the hashed inputs.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from repro_torch.core.coflow import Instance
from repro_torch.core.effects import effects
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, current_tracer

__all__ = ["instance_key", "ProgramCache"]


def instance_key(
    inst: Instance,
    releases: torch.Tensor | np.ndarray | None = None,
    *,
    algorithm: str = "ours",
    scheduling: str = "work-conserving",
    seed: int = 0,
    backend: str = "numpy",
    fabric: str = "",
) -> str:
    """Canonical content hash of one scheduling request.

    Two requests share a key iff the engine would do the identical
    computation: same demand matrices in the same order, same weights,
    releases, fabric (rates, delta, N), and pipeline knobs. ``Coflow.cid``
    is deliberately EXCLUDED — it is a label, read by nothing in the
    pipeline, and including it would miss the repeated-pattern hits this
    cache exists for.

    ``fabric`` is an extra fabric-condition fingerprint (empty on a healthy
    fabric, so healthy keys are unchanged): a degraded fabric — cores down
    after a ``core.fault.CoreDown`` — schedules over the survivors only, and
    its programs must never collide with healthy-fabric (or differently
    degraded) entries.
    """
    h = hashlib.sha256()
    h.update(f"{algorithm}|{scheduling}|{seed}|{backend}|".encode())
    if fabric:
        h.update(f"fabric={fabric}|".encode())
    # the reference's N of an empty instance is 0
    N = inst.N if inst.M else 0
    h.update(f"M={inst.M},N={N},K={inst.K},delta={inst.delta!r}".encode())
    h.update(_f64_bytes(inst.rates))
    h.update(_f64_bytes(inst.weights))
    # the (M, N, N) stack's bytes are the coflows' demands back to back
    h.update(_f64_bytes(inst.demand))
    if releases is not None:
        h.update(b"releases")
        h.update(_f64_bytes(releases))
    return h.hexdigest()


def _f64_bytes(x: torch.Tensor | np.ndarray) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64)).tobytes()


class ProgramCache:
    """Bounded LRU cache: instance key -> compiled program artifact.

    Values are opaque to the cache (``FabricManager`` stores
    ``(program, submitted cid order)`` so hits can be re-labeled to the
    caller's coflow ids)."""

    def __init__(self, capacity: int = 128, *,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None) -> None:
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = int(capacity)
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self._tracer: Tracer = current_tracer() if tracer is None else tracer
        self._hits = self.metrics.counter("cache.hits")
        self._misses = self.metrics.counter("cache.misses")
        self._purged = self.metrics.counter("cache.purged")
        self._store: OrderedDict[str, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self._store)

    @effects("cache-read", "trace-emit")
    def get(self, key: str) -> object | None:
        """Program for ``key``, or None (counts a hit/miss either way)."""
        try:
            val = self._store[key]
        except KeyError:
            self._misses.inc()
            if self._tracer.enabled:
                self._tracer.event("cache/miss", key=key[:16])
            return None
        self._store.move_to_end(key)
        self._hits.inc()
        if self._tracer.enabled:
            self._tracer.event("cache/hit", key=key[:16])
        return val

    @effects("cache-write")
    def put(self, key: str, program: object) -> None:
        self._store[key] = program
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    @effects("cache-purge", "trace-emit")
    def invalidate(self, pred: Callable[[object], bool]) -> int:
        """Drop every entry whose value satisfies ``pred``; returns the
        count. The fault path uses this to purge programs that matched
        circuits through a core that just failed — they must never be
        served again, not even to a submission hashing to their key."""
        doomed = [k for k, v in self._store.items() if pred(v)]
        for k in doomed:
            del self._store[k]
        if doomed:
            self._purged.inc(len(doomed))
            if self._tracer.enabled:
                self._tracer.event("cache/purge", count=len(doomed))
        return len(doomed)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def purged(self) -> int:
        """Total entries dropped by :meth:`invalidate` over this cache's
        lifetime (the fault plane's churn, visible without a trace)."""
        return self._purged.value

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
