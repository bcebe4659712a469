"""Per-function effect inference over the call graph (reprolint v2).

Mirrors the declaration vocabulary of ``repro_torch.core.effects`` (the linter
stays import-free of the package it checks; a unit test pins the two sets
equal) and infers, for every function in the call graph, which effects
its body performs directly and which it reaches transitively.

Inference is deliberately under-approximate — it only records effects it
can *prove* from local syntax plus the recorded type facts:

- ``commit-mutate``: rebinding/in-place write of a ``_commit`` attribute,
  or an RL106-style mutation of a tracked ``FlowTable``/
  ``FlatAssignState``/``ComponentIndex`` object. Skipped inside
  constructors (building an
  object is not mutating committed state) and inside the owning modules
  (``core/engine.py``, ``core/fabric.py``, ``core/assignment.py``; the
  port keeps ``FabricState`` and ``ComponentIndex`` in ``core/fabric.py``
  where the reference's are in ``core/engine.py``) where these arrays
  are legitimately written — mirroring RL106's owner exemption.
- ``fingerprint-mutate``: a store that targets a fabric-fingerprint
  input (``core_up`` / ``delta_k`` attribute rebinding, element write,
  or in-place mutator call, numpy's or torch's trailing-underscore
  family). Skipped inside constructors.
- ``watermark``: any read or write of a ``_gc_floor`` attribute.
  Skipped inside constructors.
- ``cache-read``/``cache-write``/``cache-purge``: ``.get``/``.put``/
  ``.invalidate`` called on an expression whose recorded type is
  ``ProgramCache`` — plus the ``ProgramCache`` methods themselves.
- ``cache-rekey``: a call to ``instance_key`` passing a ``fabric=``
  keyword (the re-key alternative to purging).
- ``rng-consume``: a consuming method (``choice``, ``integers``, …)
  called on an rng-ish expression (parameter named/annotated as a
  generator, local assigned from ``default_rng``/``PCG64``, or a
  ``self.rng``/``self._rng`` attribute).
- ``trace-emit``: ``.span``/``.event`` called on a tracer-ish expression
  (parameter named/annotated as a tracer, local assigned from a
  ``Tracer``/``NullTracer`` constructor or ``current_tracer()``, or a
  ``self.tracer``/``self._tracer`` attribute) — plus the ``Tracer``
  methods themselves. Mirrors the RNG heuristic exactly.

Propagation is a transitive closure over the call graph with one
exception: ``commit-mutate`` does NOT propagate out of a callee whose
``@effects`` declaration includes it — declaring the effect is what
*blesses* an entry point (RL302), so the mutation is accounted for there
and callers above it stay clean.
"""
from __future__ import annotations

import ast

from .callgraph import CallGraph, FuncNode
from .common import parse_annotation
from .determinism import _committed_vars, _mutations, is_inplace_method

__all__ = ["EFFECTS", "infer_direct", "propagate", "rng_names",
           "is_rng_expr", "consumed_rng_attrs", "tracer_names",
           "is_tracer_expr"]

#: Mirror of ``repro_torch.core.effects.EFFECTS`` (test-pinned identical
#: to it and to the reference's).
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

#: Generator methods that advance the PCG64 stream.
RNG_CONSUMERS: frozenset[str] = frozenset({
    "random", "choice", "integers", "uniform", "normal", "standard_normal",
    "shuffle", "permutation", "permuted", "exponential", "poisson", "gamma",
    "beta", "binomial", "bytes",
})
#: Constructor leaf names that mint a fresh RNG stream (RL303 reseed).
RNG_CTOR_LEAVES: frozenset[str] = frozenset({
    "default_rng", "PCG64", "SeedSequence", "Random"})
RNG_PARAM_NAMES: frozenset[str] = frozenset({"rng", "gen", "generator"})
RNG_ATTR_NAMES: frozenset[str] = frozenset({"rng", "_rng"})

#: Tracer heuristics: the trace-emit mirror of the RNG name conventions.
TRACER_PARAM_NAMES: frozenset[str] = frozenset({"tracer"})
TRACER_ATTR_NAMES: frozenset[str] = frozenset({"tracer", "_tracer"})
TRACER_CTOR_LEAVES: frozenset[str] = frozenset({
    "Tracer", "NullTracer", "current_tracer"})
TRACE_EMITTERS: frozenset[str] = frozenset({"span", "event"})

_FINGERPRINT_ATTRS = frozenset({"core_up", "delta_k"})
_WATERMARK_ATTRS = frozenset({"_gc_floor"})
_CACHE_METHODS = {"get": "cache-read", "put": "cache-write",
                  "invalidate": "cache-purge"}
#: committed-state owners where in-place writes are the implementation,
#: not a protocol violation (mirrors determinism._OWNER_FILES)
_COMMIT_OWNERS = frozenset({"engine.py", "fabric.py", "assignment.py"})


def _leaf(node: ast.expr) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def rng_names(fn: FuncNode) -> set[str]:
    """Local names provably bound to an RNG generator inside ``fn``."""
    out: set[str] = set()
    a = fn.node.args
    for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = parse_annotation(p.annotation)
        if p.arg in RNG_PARAM_NAMES or (
                ann.kind == "class" and ann.class_name == "Generator"):
            out.add(p.arg)
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
                and _leaf(node.value.func) in RNG_CTOR_LEAVES):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            out.add(target.id)
    return out


def is_rng_expr(expr: ast.expr, names: set[str]) -> bool:
    """True when ``expr`` is provably an RNG generator in this function."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        return expr.attr in RNG_ATTR_NAMES
    return False


def tracer_names(fn: FuncNode) -> set[str]:
    """Local names provably bound to a tracer inside ``fn``.

    Mirrors :func:`rng_names`: parameters named/annotated as a tracer,
    locals assigned from a tracer constructor (``Tracer``/``NullTracer``/
    ``current_tracer``), and locals assigned from a ``self.tracer`` /
    ``self._tracer`` attribute read (``tr = self._tracer`` is the hot-path
    idiom in instrumented ticks).
    """
    out: set[str] = set()
    a = fn.node.args
    for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = parse_annotation(p.annotation)
        if p.arg in TRACER_PARAM_NAMES or (
                ann.kind == "class"
                and ann.class_name in ("Tracer", "NullTracer")):
            out.add(p.arg)
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        v = node.value
        if ((isinstance(v, ast.Call) and _leaf(v.func) in TRACER_CTOR_LEAVES)
                or (isinstance(v, ast.Attribute)
                    and v.attr in TRACER_ATTR_NAMES)):
            out.add(target.id)
    return out


def is_tracer_expr(expr: ast.expr, names: set[str]) -> bool:
    """True when ``expr`` is provably a tracer in this function."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Attribute):
        return expr.attr in TRACER_ATTR_NAMES
    return False


def consumed_rng_attrs(fn: FuncNode) -> set[str]:
    """Instance RNG attributes (``self.rng``/``self._rng``) ``fn`` draws
    from directly — RL303's single-consumer check groups these per class."""
    out: set[str] = set()
    for node in ast.walk(fn.node):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in RNG_CONSUMERS):
            base = node.func.value
            if (isinstance(base, ast.Attribute)
                    and base.attr in RNG_ATTR_NAMES
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"):
                out.add(base.attr)
    return out


def _store_targets(node: ast.AST) -> list[ast.expr]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


def _fingerprint_store(node: ast.AST) -> bool:
    for t in _store_targets(node):
        if isinstance(t, ast.Attribute) and t.attr in _FINGERPRINT_ATTRS:
            return True
        if isinstance(t, ast.Subscript) and \
                _leaf(t.value) in _FINGERPRINT_ATTRS:
            return True
    if (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and is_inplace_method(node.func.attr)
            and _leaf(node.func.value) in _FINGERPRINT_ATTRS):
        return True
    return False


def _commit_store(node: ast.AST) -> bool:
    for t in _store_targets(node):
        if isinstance(t, ast.Attribute) and t.attr == "_commit":
            return True
        if isinstance(t, ast.Subscript) and _leaf(t.value) == "_commit":
            return True
    return False


def infer_direct(graph: CallGraph) -> dict[str, set[str]]:
    """Direct (intrinsic) effect set for every node in the graph."""
    return {uid: _direct(graph, fn) for uid, fn in graph.nodes.items()}


def _direct(graph: CallGraph, fn: FuncNode) -> set[str]:
    eff: set[str] = set()
    mod = fn.module
    locals_ = graph.local_types(fn)
    rngs = rng_names(fn)
    tracers = tracer_names(fn)
    if fn.cls == "ProgramCache" and fn.name in _CACHE_METHODS:
        eff.add(_CACHE_METHODS[fn.name])
    if fn.cls in ("Tracer", "NullTracer") and fn.name in TRACE_EMITTERS:
        eff.add("trace-emit")
    commit_exempt = fn.is_ctor or (
        mod.is_core and mod.basename in _COMMIT_OWNERS)
    tracked: dict[str, str] = {} if commit_exempt else _committed_vars(
        mod, fn.node, fn.node.body)
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                cache_eff = _CACHE_METHODS.get(f.attr)
                if cache_eff is not None and graph.expr_class(
                        fn, f.value, locals_) == "ProgramCache":
                    eff.add(cache_eff)
                if f.attr in RNG_CONSUMERS and is_rng_expr(f.value, rngs):
                    eff.add("rng-consume")
                if f.attr in TRACE_EMITTERS and \
                        is_tracer_expr(f.value, tracers):
                    eff.add("trace-emit")
            if _leaf(f) == "instance_key" and any(
                    kw.arg == "fabric" for kw in node.keywords):
                eff.add("cache-rekey")
        if not fn.is_ctor:
            if _fingerprint_store(node):
                eff.add("fingerprint-mutate")
            if isinstance(node, ast.Attribute) and \
                    node.attr in _WATERMARK_ATTRS:
                eff.add("watermark")
            if not commit_exempt and (
                    _commit_store(node)
                    or (tracked and any(_mutations(mod, node, tracked)))):
                eff.add("commit-mutate")
    return eff


def propagate(graph: CallGraph,
              direct: dict[str, set[str]]) -> dict[str, frozenset[str]]:
    """Transitive effect sets (fixpoint), with the RL302 blessed-stop:
    ``commit-mutate`` never escapes a callee that declares it."""
    eff: dict[str, set[str]] = {uid: set(s) for uid, s in direct.items()}
    changed = True
    while changed:
        changed = False
        for uid, callees in graph.edges.items():
            mine = eff[uid]
            for callee in callees:
                node = graph.nodes[callee]
                inherit = eff[callee]
                if (node.declared is not None
                        and "commit-mutate" in node.declared
                        and "commit-mutate" in inherit):
                    inherit = inherit - {"commit-mutate"}
                new = inherit - mine
                if new:
                    mine |= new
                    changed = True
    return {uid: frozenset(s) for uid, s in eff.items()}
