"""Phase-level span tracer for the fabric planes (engine/service/fault).

The port's copy of ``repro.obs.trace``, with the same span names and the
same record and Chrome-trace schemas, so the reference's
``python -m repro.obs validate`` accepts a port trace. One :class:`Tracer`
records nested **spans** (named intervals with typed attributes) and
instant **events** into an in-memory buffer, optionally flushed to a JSONL
sink, and exportable as a Chrome-trace / Perfetto ``traceEvents`` document.
The span taxonomy the fabric emits:

  ``tick``                 one ``FabricManager`` service tick (root)
  ``tick/admit``           admission-queue drain under the flow budget
  ``tick/assign``          batch registration, flow extraction on the
                           device and core assignment
  ``tick/splice``          delta-scheduling cache splice against the
                           incremental component index (``reused``,
                           ``recomputed``, ``invalidated`` -- rows a fault
                           staled -- plus ``components_total`` /
                           ``components_touched``)
  ``tick/event_loop``      the event loop over touched rows
  ``tick/program_emit``    circuit-program compilation (+ referee)
  ``fault/recover``        one fault application (abort/requeue counts +
                           ``invalidated``)
  ``cache/hit|miss|purge`` one-shot program-cache traffic (events)

Device work: a span that closes while CUDA work is pending would time the
launch, not the work, and one that opens on work its parent queued would
be charged that work. So a recording tracer synchronises the CUDA device
before it reads the clock at a span's open and at its end, whenever this
process has initialised CUDA. The disabled tracer never does.

One clock with the device trace: while ``torch``'s profiler records, a
recording span also opens a ``torch.profiler.record_function`` range of
its name on ``__enter__`` and closes it on ``__exit__`` (after the
synchronise, before the span is recorded), so the profiler's trace names
the device's idle time by the program's own spans. Without a profiler
nothing is opened.

Determinism contract: the tracer only *observes* -- all timestamps come
from :mod:`repro_torch.obs.clock` and no instrumented code path reads a
span back, so schedules are bit-identical with tracing on or off.

Overhead contract: the disabled path is allocation-free. The global
default is :data:`NULL_TRACER`, whose ``span()`` returns one shared no-op
span object and whose ``event()`` returns immediately; call sites compute
attributes only behind ``span.live`` / ``tracer.enabled`` guards.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import IO, Iterator

from .clock import now

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "current_tracer", "set_tracer", "to_chrome_trace",
]


def _jsonable_attr(v: object) -> object:
    """Coerce one span attribute to a JSON-safe scalar (json has no inf)."""
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    try:
        # numpy scalars and other number-likes
        return _jsonable_attr(float(v))  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return repr(v)


def _sync_device() -> None:
    """Wait for pending CUDA work, if this process has initialised CUDA
    (``torch`` is never imported here for it)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _profiler_range(name: str) -> object | None:
    """An open ``record_function`` range named ``name`` while ``torch``'s
    profiler records, else ``None`` (nothing is imported here for it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One open interval; closes (and records itself) on ``__exit__``.

    ``live`` is True on real spans and False on the shared no-op span —
    instrumented code guards attribute computation behind it so the
    disabled path stays free.
    """

    __slots__ = ("_tracer", "name", "sid", "parent", "depth", "t0", "attrs",
                 "_range")

    live: bool = True

    def __init__(self, tracer: "Tracer", name: str, sid: int,
                 parent: int | None, depth: int) -> None:
        self._tracer = tracer
        self.name = name
        self.sid = sid
        self.parent = parent
        self.depth = depth
        self.t0 = now()
        self.attrs: dict[str, object] = {}
        self._range: object | None = None

    def set(self, **attrs: object) -> "Span":
        """Attach typed attributes (recorded when the span closes)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._range = _profiler_range(self.name)
        return self

    def __exit__(self, exc_type: object, exc: object, tb: object) -> bool:
        _sync_device()
        if self._range is not None:
            self._range.__exit__(None, None, None)  # type: ignore[attr-defined]
            self._range = None
        self._tracer._close(self, error=exc_type is not None)
        return False


class _NullSpan:
    """The shared no-op span: one instance, zero per-call allocation."""

    __slots__ = ()

    live: bool = False

    def set(self, **attrs: object) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type: object, exc: object, tb: object) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Recording tracer: nested spans + events -> JSONL / Chrome trace.

    ``sink`` may be a path (JSONL written on ``flush()``/``close()``) or
    an open text file object; ``None`` keeps records in memory only
    (``records`` stays available either way).
    """

    enabled: bool = True

    def __init__(self, sink: str | Path | IO[str] | None = None) -> None:
        self.records: list[dict[str, object]] = []
        self._stack: list[Span] = []
        self._next_sid = 0
        self._flushed = 0
        self._sink_path: Path | None = None
        self._sink_file: IO[str] | None = None
        if isinstance(sink, (str, Path)):
            self._sink_path = Path(sink)
        elif sink is not None:
            self._sink_file = sink

    # -- recording ----------------------------------------------------------
    def span(self, name: str) -> Span:
        """Open a nested span; close it with ``with`` (exception-safe)."""
        sid = self._next_sid
        self._next_sid += 1
        parent = self._stack[-1].sid if self._stack else None
        _sync_device()
        sp = Span(self, name, sid, parent, depth=len(self._stack))
        self._stack.append(sp)
        return sp

    def event(self, name: str, **attrs: object) -> None:
        """Record one instant event at the current nesting depth."""
        parent = self._stack[-1].sid if self._stack else None
        sid = self._next_sid
        self._next_sid += 1
        self.records.append({
            "kind": "event", "name": name, "sid": sid, "parent": parent,
            "depth": len(self._stack), "ts": now(),
            "attrs": {k: _jsonable_attr(v) for k, v in attrs.items()},
        })

    def _close(self, span: Span, error: bool = False) -> None:
        # Pop to (and including) `span`. With-statement nesting guarantees
        # LIFO order; popping defensively keeps the stack well-formed even
        # if an unclosed inner span leaks past an exception handler.
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        rec: dict[str, object] = {
            "kind": "span", "name": span.name, "sid": span.sid,
            "parent": span.parent, "depth": span.depth,
            "ts": span.t0, "dur": now() - span.t0,
            "attrs": {k: _jsonable_attr(v) for k, v in span.attrs.items()},
        }
        if error:
            rec["error"] = True
        self.records.append(rec)

    @property
    def open_spans(self) -> int:
        """Spans currently open (0 when nesting is well-formed at rest)."""
        return len(self._stack)

    # -- sinks --------------------------------------------------------------
    def flush(self) -> None:
        """Append unflushed records to the sink (no-op without one)."""
        pending = self.records[self._flushed:]
        if not pending:
            return
        if self._sink_path is not None:
            with open(self._sink_path, "a", encoding="utf-8") as fh:
                for rec in pending:
                    fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._flushed = len(self.records)
        elif self._sink_file is not None:
            for rec in pending:
                self._sink_file.write(json.dumps(rec, sort_keys=True) + "\n")
            self._flushed = len(self.records)

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, exc_type: object, exc: object, tb: object) -> bool:
        self.close()
        return False

    def to_chrome_trace(self) -> dict[str, object]:
        """Chrome-trace / Perfetto ``traceEvents`` document."""
        return to_chrome_trace(self.records)


class NullTracer(Tracer):
    """The disabled tracer: every operation is a no-op.

    ``span()`` returns the one shared :data:`NULL_SPAN` instance, so the
    disabled hot path allocates nothing; ``records`` stays empty.
    """

    enabled = False

    def __init__(self) -> None:
        super().__init__(sink=None)

    def span(self, name: str) -> Span:
        return NULL_SPAN  # type: ignore[return-value]

    def event(self, name: str, **attrs: object) -> None:
        return None

    def flush(self) -> None:
        return None


NULL_TRACER = NullTracer()

#: process-wide default tracer; ``FabricManager`` picks it up at
#: construction when not handed one explicitly.
_CURRENT: Tracer = NULL_TRACER


def current_tracer() -> Tracer:
    """The process-wide default tracer (``NULL_TRACER`` unless set)."""
    return _CURRENT


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install the process-wide default tracer; returns the previous one.

    ``None`` restores :data:`NULL_TRACER`.
    """
    global _CURRENT
    prev = _CURRENT
    _CURRENT = NULL_TRACER if tracer is None else tracer
    return prev


def _chrome_events(records: list[dict[str, object]]
                   ) -> Iterator[dict[str, object]]:
    for rec in records:
        ts_us = float(rec.get("ts", 0.0)) * 1e6  # type: ignore[arg-type]
        base: dict[str, object] = {
            "name": rec.get("name", "?"), "pid": 0, "tid": 0,
            "ts": ts_us, "args": rec.get("attrs", {}),
        }
        if rec.get("kind") == "span":
            base["ph"] = "X"
            base["dur"] = float(rec.get("dur", 0.0)) * 1e6  # type: ignore[arg-type]
        else:
            base["ph"] = "i"
            base["s"] = "t"
        yield base


def to_chrome_trace(records: list[dict[str, object]]) -> dict[str, object]:
    """Convert JSONL records to a Chrome-trace document.

    Load the result in Perfetto (https://ui.perfetto.dev) or
    ``chrome://tracing`` to see the per-phase flame view of a run.
    """
    return {
        "traceEvents": sorted(_chrome_events(records),
                              key=lambda e: float(e["ts"])),  # type: ignore[arg-type]
        "displayTimeUnit": "ms",
    }
