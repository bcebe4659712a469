"""Reduce a ``torch.profiler`` trace of the window to what the result
reports: the device's busy seconds, the device operations that took most
time, and the device's idle time by what the host was doing.

Device intervals are every kernel, copy and set the profiler saw on the
card. The busy time is their union inside the window (the
``perfbench.window`` range). An idle gap is a stretch of the window with
no device interval; it is named by the innermost host range
(``record_function``, which the drivers and ``obs.ProfTracer`` open around
the program's layers) open at the gap's middle, ``(harness)`` where none is.
"""
from __future__ import annotations

import bisect

WINDOW = "perfbench.window"
TOP = 10


def _events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _span(ev) -> tuple[float, float]:
    """(start, end) of a kineto event in seconds."""
    s = ev.start_ns() * 1e-9
    return s, s + ev.duration_ns() * 1e-9


def _is_device(ev) -> bool:
    return str(ev.device_type()).rsplit(".", 1)[-1] == "CUDA"


def split(prof) -> tuple[tuple[float, float], list, list]:
    """``(window, device intervals (start, end, name), host ranges (start,
    end, name))`` in seconds on the profiler's clock.

    The profiler also puts each host range on the device's timeline, over
    the kernels launched inside it (a "GPU user annotation"); those carry
    the name of an event of the host and are no device work, so they are
    left out.
    """
    window, dev, host, host_names = (0.0, 0.0), [], [], set()
    for ev in _events(prof):
        s, e = _span(ev)
        name = ev.name()
        if _is_device(ev):
            dev.append((s, e, name))
            continue
        host_names.add(name)
        if name == WINDOW:
            window = (s, e)
        elif "." in name or "/" in name or name == "tick":
            host.append((s, e, name))
    dev = [d for d in dev if d[2] not in host_names]
    return window, dev, host


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(host: list, points: list[float]) -> list[str]:
    """For each point, the name of the latest-starting host range that
    holds it (ranges on one thread nest), ``(harness)`` for none."""
    host = sorted(host)
    starts = [h[0] for h in host]
    names = []
    for p in points:
        k = bisect.bisect_right(starts, p) - 1
        name = "(harness)"
        while k >= 0:
            s, e, n = host[k]
            if e >= p:
                name = n
                break
            k -= 1
        names.append(name)
    return names


def reduce(prof, window_s: float) -> dict:
    """``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (each a
    list of ``[name, seconds]``, largest first, at most ten) of the traced
    window; ``window_s`` is the host's measure of it."""
    (w0, w1), dev, host = split(prof)
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in dev
               if e > w0 and s < w1]
    busy = union([(s, e) for s, e, _ in clipped])
    busy_s = sum(e - s for s, e in busy)
    by_op: dict[str, float] = {}
    for s, e, n in clipped:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    names = innermost(host, [(s + e) / 2 for s, e in gaps])
    by_host: dict[str, float] = {}
    for (s, e), n in zip(gaps, names):
        by_host[n] = by_host.get(n, 0.0) + (e - s)

    def top(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]

    return {"busy_s": busy_s, "window_s": float(window_s),
            "device_ops": top(by_op), "idle_gaps": top(by_host)}
