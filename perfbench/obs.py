"""What the per-layer readers read: layer times the drivers record around
the program's calls, the program's own tracer spans, and the profile.

``ctx.obs`` holds ``layers`` (layer name -> seconds of each call in the
window), ``counters`` (name -> list of numbers), ``spans`` (the program
tracer's span records in the window), ``n_units`` (schedules or ticks in
the window) and, in a traced run, ``profile`` (``profile.reduce``).
"""
from __future__ import annotations


def per_unit(obs: dict, layer: str) -> float | None:
    """Seconds of ``layer`` per schedule or tick of the window; ``None``
    where the layer was never called."""
    calls = obs["layers"].get(layer)
    if not calls or not obs.get("n_units"):
        return None
    return sum(calls) / obs["n_units"]


def self_times(spans: list[dict]) -> dict[int, float]:
    """Self time of each span record (its duration less its children's),
    by span id."""
    child: dict[int, float] = {}
    for r in spans:
        if r.get("parent") is not None:
            child[r["parent"]] = child.get(r["parent"], 0.0) + r["dur"]
    return {r["sid"]: r["dur"] - child.get(r["sid"], 0.0) for r in spans}


def span_self_per_unit(obs: dict, name: str) -> float | None:
    """Self seconds of the program's span ``name`` per tick of the window;
    ``None`` where the program recorded no such span."""
    spans = obs.get("spans") or []
    mine = [r for r in spans if r["name"] == name]
    if not mine or not obs.get("n_units"):
        return None
    st = self_times(spans)
    return sum(st[r["sid"]] for r in mine) / obs["n_units"]


def span_attr_mean(obs: dict, name: str, attr: str) -> float | None:
    vals = [r["attrs"][attr] for r in obs.get("spans") or []
            if r["name"] == name and isinstance(r.get("attrs", {}).get(attr),
                                                (int, float))]
    return sum(vals) / len(vals) if vals else None


def idle_pct(obs: dict) -> float | None:
    prof = obs.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def prof_tracer():
    """A recording tracer of the program that also opens a profiler range
    named after each span, so the profile can say what the host was doing
    while the device idled."""
    import torch
    from repro_torch.obs.trace import Tracer

    class ProfTracer(Tracer):
        def __init__(self):
            super().__init__()
            self._ranges = {}

        def span(self, name):
            sp = super().span(name)
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._ranges[sp.sid] = rf
            return sp

        def _close(self, span, error=False):
            super()._close(span, error)
            rf = self._ranges.pop(span.sid, None)
            if rf is not None:
                rf.__exit__(None, None, None)

    return ProfTracer()
