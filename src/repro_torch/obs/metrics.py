"""Metrics registry: counters, gauges, histograms for the fabric planes.

The port's copy of ``repro.obs.metrics``. ``FabricManager``,
``AdmissionQueue`` and ``ProgramCache`` each own (or are handed) a
:class:`MetricsRegistry` and register their counters there; their
attribute names are read-only properties over it, and
``FabricManager.summary()`` is a flat view over the registry.

Design points:

- **Get-or-create by name.** ``registry.counter("admission.shed")``
  returns the same instrument every call, so wiring several components
  onto one registry needs no coordination beyond a naming convention
  (``<component>.<metric>``, dots as separators).
- **Histograms are windowed but honest.** A :class:`Histogram` keeps at
  most ``window`` samples (a deque, like the old latency buffer) but
  counts every observation it ever saw: ``n_observed`` vs
  ``n_retained`` exposes the sample-window coverage so a p99 computed
  over a truncated window is never silently presented as exact.
- **No wall-clock reads.** Instruments store what they are given;
  timing, where needed, comes from :mod:`repro_torch.obs.clock` at the call
  site. The registry is therefore trivially determinism-safe.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically-named (not necessarily monotone) running sum.

    Negative increments are allowed: fault recovery un-finalizes
    coflows, so ``service.finalized`` must be able to roll back.
    """

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """A bounded-window sample store with exact observation accounting.

    ``observe()`` always bumps ``n_observed``; the deque retains only
    the newest ``window`` samples. ``coverage`` is the retained/observed
    fraction — 1.0 means the quantiles below are exact, anything less
    means they describe the most recent window only.
    """

    __slots__ = ("name", "window", "samples", "n_observed", "total")

    def __init__(self, name: str, window: int = 4096) -> None:
        self.name = name
        self.window = window
        self.samples: deque[float] = deque(maxlen=window)
        self.n_observed = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.samples.append(float(v))
        self.n_observed += 1
        self.total += float(v)

    @property
    def n_retained(self) -> int:
        return len(self.samples)

    @property
    def coverage(self) -> float:
        """Retained/observed fraction (1.0 until the window overflows)."""
        if self.n_observed == 0:
            return 1.0
        return self.n_retained / self.n_observed

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.quantile(np.asarray(self.samples, dtype=np.float64),
                                 q))

    def mean(self) -> float:
        if not self.samples:
            return 0.0
        return float(np.mean(np.asarray(self.samples, dtype=np.float64)))


class MetricsRegistry:
    """Name-keyed instrument store shared across fabric components.

    One registry typically serves a whole :class:`FabricManager` — the
    admission queue, program cache, and manager itself all register
    into it, so ``snapshot()`` is the single flat view ``summary()``
    builds on.
    """

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, window=window)
        return h

    def snapshot(self) -> dict[str, object]:
        """Flat name->value view; histograms expand to summary stats."""
        out: dict[str, object] = {}
        for name, c in sorted(self._counters.items()):
            out[name] = c.value
        for name, g in sorted(self._gauges.items()):
            out[name] = g.value
        for name, h in sorted(self._histograms.items()):
            out[f"{name}.p50"] = h.quantile(0.50)
            out[f"{name}.p99"] = h.quantile(0.99)
            out[f"{name}.mean"] = h.mean()
            out[f"{name}.n_observed"] = h.n_observed
            out[f"{name}.n_retained"] = h.n_retained
            out[f"{name}.coverage"] = h.coverage
        return out
