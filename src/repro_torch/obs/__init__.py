"""Observability plane of the port: phase tracing and metrics.

The port's copy of ``repro.obs``:

- :mod:`repro_torch.obs.clock` -- the one wall-clock read of the
  scheduling and service code;
- :mod:`repro_torch.obs.trace` -- span tracer (``Tracer``/``NULL_TRACER``,
  ``current_tracer``/``set_tracer``), JSONL + Chrome-trace export, in the
  reference's schema;
- :mod:`repro_torch.obs.metrics` -- ``MetricsRegistry`` with counters,
  gauges and windowed histograms;
- ``python -m repro_torch.obs`` -- summarize/validate/diff traces and
  ``BENCH_*.json`` artifacts (:mod:`repro_torch.obs.cli`), the reference's
  CLI.

Stdlib and numpy only. Tracing off leaves every schedule bit-identical.
"""
from __future__ import annotations

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import (NULL_TRACER, NullTracer, Span, Tracer, current_tracer,
                    set_tracer, to_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Span", "Tracer",
    "current_tracer", "set_tracer", "to_chrome_trace",
]
