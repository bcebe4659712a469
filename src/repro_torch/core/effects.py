"""Effect declarations: the vocabulary reprolint's protocol rules verify.

The port's copy of ``repro.core.effects`` (the port imports nothing of the
reference); the port's linter, ``repro_torch.analysis.lint``, reads the
declarations.

The control plane's protocol invariants — cache coherence after topology
churn, commit finality, RNG-stream discipline, watermark-relative time —
are *pairing* properties over the call graph, not per-line properties.
``reprolint``'s RL3xx checkers (``repro_torch.analysis.lint.protocol``) infer
each function's effect set from its body and transitive callees; this
module is the other half of the contract: entry points *declare* what
they intend, and the checker flags drift between the two (RL305).

The decorator is a no-op at runtime (it attaches ``__effects__`` metadata
and returns the function unchanged); the checker reads it syntactically,
so declaring costs nothing on the hot path.

Vocabulary (one effect per tracked protocol resource):

- ``commit-mutate``      — mutates committed rows (``FabricState._commit``,
  committed ``FlowTable``/``FlatAssignState`` arrays). Declaring it marks
  a *blessed* mutation entry point: callers reaching committed-row
  mutation only through declared functions are exempt from RL302.
- ``rng-consume``        — draws from the threaded PCG64 stream (the
  chunked-vs-one-shot replay identity depends on every draw).
- ``cache-read`` / ``cache-write`` / ``cache-purge`` — ``ProgramCache``
  get / put / invalidate.
- ``cache-rekey``        — derives an ``instance_key`` carrying a fabric
  fingerprint (the re-key alternative to purging on churn).
- ``watermark``          — reads or advances the committed-circuit
  retention watermark (``FabricState._gc_floor``). Declaring it also opts
  the function's time-argument call sites into RL304.
- ``fingerprint-mutate`` — perturbs a fabric-fingerprint input (core up
  masks, per-core ``delta_k``): any path doing this must reach a cache
  purge or re-key before the next program is served (RL301).
- ``trace-emit``         — emits observability spans/events through a
  ``repro_torch.obs`` tracer. Purely observational (the tracer never feeds a
  scheduling decision), but declared so RL305 keeps instrumented entry
  points honest about where telemetry is produced.
"""
from __future__ import annotations

from typing import Callable, TypeVar

__all__ = ["EFFECTS", "effects"]

#: The closed effect vocabulary. ``repro_torch.analysis.lint.effects`` mirrors
#: this set (the linter stays import-free of the package it checks); a
#: unit test asserts the two, and the reference's, stay identical.
EFFECTS: frozenset[str] = frozenset({
    "commit-mutate",
    "rng-consume",
    "cache-read",
    "cache-write",
    "cache-purge",
    "cache-rekey",
    "watermark",
    "fingerprint-mutate",
    "trace-emit",
})

_F = TypeVar("_F", bound=Callable[..., object])


def effects(*names: str) -> Callable[[_F], _F]:
    """Declare a function's intended effect set (``@effects()`` = pure).

    The declaration must cover everything the function *transitively*
    does in the vocabulary above — reprolint's RL305 compares it against
    the inferred reality. Unknown names raise here (import time) and are
    additionally flagged statically.
    """
    bad = sorted(set(names) - EFFECTS)
    if bad:
        raise ValueError(
            f"unknown effect name(s) {bad}; vocabulary: {sorted(EFFECTS)}")
    declared = frozenset(names)

    def deco(fn: _F) -> _F:
        setattr(fn, "__effects__", declared)
        return fn

    return deco
