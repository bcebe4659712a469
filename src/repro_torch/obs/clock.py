"""The telemetry clock: the one place the port's scheduling and service code
reads wall time.

The port's copy of ``repro.obs.clock``. Every schedule is a pure function of
``(instance, seed)``; telemetry (span durations, decision latency, tick
wall time) still needs a clock, so it reads this one, and nothing that a
scheduling decision depends on ever does. Tests may monkeypatch ``now``
for deterministic durations.
"""
from __future__ import annotations

import time

__all__ = ["now"]


def now() -> float:
    """Monotonic telemetry timestamp in fractional seconds.

    Suitable only for durations and ordering on one host; never feeds a
    scheduling decision.
    """
    return time.perf_counter()
