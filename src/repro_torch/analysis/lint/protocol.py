"""Protocol checkers (RL30x): pairing invariants over the call graph.

The fault-plane and overload bug classes (DeltaDrift priced without a
ProgramCache re-key, CoreUp without a load reset, retention GC missing)
were all *pairing* bugs: an effect at one call-graph node demands a matching
effect at another. These rules check the pairings statically, on top of
the effect inference in ``effects.py``:

- ``cache-coherence``  (RL301): inside a class that owns a
  ``ProgramCache``, any non-constructor method that transitively
  perturbs a fabric-fingerprint input (core masks, ``delta_k``) must
  also transitively purge or re-key the cache before the next program
  can be served stale.
- ``commit-finality``  (RL302): committed-row mutation must be
  *declared* (``@effects("commit-mutate")``) at the entry point that
  performs it — undeclared mutation, or mutation leaking past a blessed
  callee into an undeclared caller, is flagged.
- ``rng-discipline``   (RL303): the PCG64 stream is threaded as a
  parameter and consumed at a single site — re-seeding mid-path
  (constructing a fresh generator in a function that already received
  one), forking (``.spawn()``/``.jumped()``), or multiple methods
  draining one instance stream all break chunked-vs-one-shot replay.
- ``watermark-source`` (RL304): call sites of watermark-declared
  functions whose first parameter is a time (``t_now``/``t``/``t_f``)
  must pass a sanctioned tick source (a time-named variable/attribute
  or ``inf``), not an arbitrary expression — the retention watermark
  only ever moves on real tick time.
- ``effect-mismatch``  (RL305): a declared effect set must cover the
  inferred transitive reality (unknown vocabulary names are flagged
  too). The converse — declared but not inferred — is deliberately NOT
  flagged: inference is under-approximate, and declarations double as
  documentation for effects the analysis cannot see.

All RL30x rules bind only under ``src/repro_torch/`` (the corpus opts in
via ``pretend-path``); tests and benchmarks poke internals deliberately.
"""
from __future__ import annotations

import ast

from .callgraph import CallGraph, FuncNode, build_callgraph
from .common import Finding, Module, dotted_name, parse_annotation
from .effects import (EFFECTS, RNG_CTOR_LEAVES, RNG_PARAM_NAMES,
                      consumed_rng_attrs, infer_direct, is_rng_expr,
                      propagate, rng_names)

__all__ = ["check_protocol"]

_TIME_PARAMS = frozenset({"t_now", "t", "t_f", "t_fault"})
_SANCTIONED_NAMES = frozenset({"t_now", "t", "t_f", "t_fault"})
_SANCTIONED_ATTRS = frozenset({"t_now", "t"})
_INF_DOTTED = frozenset({"numpy.inf", "math.inf"})
_FORK_METHODS = frozenset({"spawn", "jumped"})


def _in_scope(mod: Module) -> bool:
    return mod.in_dir("src", "repro_torch")


def check_protocol(
        modules: list[Module]) -> tuple[list[Finding], dict[str, object]]:
    """Run RL301–RL305 over the analyzed set; returns (findings, summary)."""
    graph = build_callgraph(modules, EFFECTS)
    trans = propagate(graph, infer_direct(graph))
    findings: list[Finding] = []
    findings.extend(_check_cache_coherence(graph, trans))
    findings.extend(_check_commit_finality(graph, trans))
    findings.extend(_check_rng_discipline(graph))
    findings.extend(_check_watermark_source(graph))
    findings.extend(_check_effect_mismatch(graph, trans))
    scoped = [uid for uid, fn in graph.nodes.items() if _in_scope(fn.module)]
    hist = {name: sum(1 for uid in scoped if name in trans[uid])
            for name in sorted(EFFECTS)}
    summary: dict[str, object] = {
        "functions": len(graph.nodes),
        "edges": graph.n_edges,
        "declared": sum(1 for fn in graph.nodes.values()
                        if fn.declared is not None),
        "effects": hist,
    }
    return findings, summary


# ----------------------------------------------------------- RL301 / RL302

def _check_cache_coherence(graph: CallGraph,
                           trans: dict[str, frozenset[str]]) -> list[Finding]:
    out: list[Finding] = []
    for logical, classes in graph.classes.items():
        for info in classes.values():
            if not _in_scope(info.module) or not graph.holds_cache(info):
                continue
            for uid in info.methods.values():
                fn = graph.nodes[uid]
                if fn.is_ctor:
                    continue
                eff = trans[uid]
                if "fingerprint-mutate" in eff and not (
                        {"cache-purge", "cache-rekey"} & eff):
                    out.append(Finding(
                        "cache-coherence", str(fn.module.path), fn.line,
                        fn.node.col_offset,
                        f"`{fn.qualname}` perturbs a fabric-fingerprint "
                        f"input but never reaches a ProgramCache purge or "
                        f"re-key; the next served program would be stale"))
    return out


def _check_commit_finality(graph: CallGraph,
                           trans: dict[str, frozenset[str]]) -> list[Finding]:
    out: list[Finding] = []
    for uid, fn in graph.nodes.items():
        if not _in_scope(fn.module):
            continue
        if "commit-mutate" not in trans[uid]:
            continue
        if fn.declared is not None and "commit-mutate" in fn.declared:
            continue
        out.append(Finding(
            "commit-finality", str(fn.module.path), fn.line,
            fn.node.col_offset,
            f"`{fn.qualname}` reaches committed-row mutation without a "
            f'blessing `@effects("commit-mutate")` declaration; committed '
            f"state is final outside declared rollback entry points"))
    return out


# ------------------------------------------------------------------- RL303

def _rng_params(fn: FuncNode) -> set[str]:
    out: set[str] = set()
    a = fn.node.args
    for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = parse_annotation(p.annotation)
        if p.arg in RNG_PARAM_NAMES or (
                ann.kind == "class" and ann.class_name == "Generator"):
            out.add(p.arg)
    return out


def _check_rng_discipline(graph: CallGraph) -> list[Finding]:
    out: list[Finding] = []
    for uid, fn in graph.nodes.items():
        if not _in_scope(fn.module):
            continue
        names = rng_names(fn)
        # (a) re-seed mid-path: the function already receives a generator
        # yet mints a fresh stream of its own
        if _rng_params(fn):
            for node in ast.walk(fn.node):
                if (isinstance(node, ast.Call)
                        and _call_leaf(node) in RNG_CTOR_LEAVES):
                    out.append(Finding(
                        "rng-discipline", str(fn.module.path), node.lineno,
                        node.col_offset,
                        f"`{fn.qualname}` receives a threaded generator but "
                        f"constructs a fresh RNG mid-path; replay identity "
                        f"requires one stream per path"))
        # (b) forking the stream
        for node in ast.walk(fn.node):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _FORK_METHODS
                    and is_rng_expr(node.func.value, names)):
                out.append(Finding(
                    "rng-discipline", str(fn.module.path), node.lineno,
                    node.col_offset,
                    f"`.{node.func.attr}()` forks the threaded RNG stream "
                    f"in `{fn.qualname}`; chunked-vs-one-shot replay "
                    f"requires a single linear stream"))
    # (c) one instance stream, one consuming method per class
    for logical, classes in graph.classes.items():
        for info in classes.values():
            if not _in_scope(info.module):
                continue
            by_attr: dict[str, list[FuncNode]] = {}
            for uid in info.methods.values():
                fn = graph.nodes[uid]
                for attr in consumed_rng_attrs(fn):
                    by_attr.setdefault(attr, []).append(fn)
            for attr, fns in sorted(by_attr.items()):
                fns.sort(key=lambda f: f.line)
                for fn in fns[1:]:
                    out.append(Finding(
                        "rng-discipline", str(fn.module.path), fn.line,
                        fn.node.col_offset,
                        f"`{fn.qualname}` is a second consumer of "
                        f"`self.{attr}` (first: `{fns[0].qualname}`); the "
                        f"instance stream must have a single consuming "
                        f"method to keep draw order replayable"))
    return out


def _call_leaf(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


# ------------------------------------------------------------------- RL304

def _first_time_param(fn: FuncNode) -> str | None:
    for name in fn.params():
        if name in ("self", "cls"):
            continue
        return name if name in _TIME_PARAMS else None
    return None


def _sanctioned_time(arg: ast.expr, fn: FuncNode) -> bool:
    if isinstance(arg, ast.Name):
        return arg.id in _SANCTIONED_NAMES
    if isinstance(arg, ast.Attribute):
        if arg.attr in _SANCTIONED_ATTRS:
            return True
        dotted = dotted_name(arg, fn.module.aliases)
        return dotted in _INF_DOTTED
    return False


def _check_watermark_source(graph: CallGraph) -> list[Finding]:
    out: list[Finding] = []
    for uid, fn in graph.nodes.items():
        if not _in_scope(fn.module):
            continue
        for callee_uid, call in graph.sites[uid]:
            callee = graph.nodes[callee_uid]
            if callee.declared is None or "watermark" not in callee.declared:
                continue
            pname = _first_time_param(callee)
            if pname is None:
                continue
            arg: ast.expr | None = None
            for kw in call.keywords:
                if kw.arg == pname:
                    arg = kw.value
            if arg is None and call.args:
                arg = call.args[0]
            if arg is None or _sanctioned_time(arg, fn):
                continue
            out.append(Finding(
                "watermark-source", str(fn.module.path), call.lineno,
                call.col_offset,
                f"`{callee.qualname}` moves the retention watermark; its "
                f"`{pname}` argument must be a sanctioned tick source "
                f"(t_now/t/t_f, a `.t_now` attribute, or inf), not an "
                f"arbitrary expression"))
    return out


# ------------------------------------------------------------------- RL305

def _check_effect_mismatch(graph: CallGraph,
                           trans: dict[str, frozenset[str]]) -> list[Finding]:
    out: list[Finding] = []
    for uid, fn in graph.nodes.items():
        if not _in_scope(fn.module) or fn.declared is None:
            continue
        if fn.declared_unknown:
            shown = ", ".join(repr(u) for u in fn.declared_unknown)
            out.append(Finding(
                "effect-mismatch", str(fn.module.path), fn.line,
                fn.node.col_offset,
                f"`{fn.qualname}` declares effect(s) outside the "
                f"vocabulary: {shown}"))
        extra = sorted(trans[uid] - fn.declared)
        if extra:
            out.append(Finding(
                "effect-mismatch", str(fn.module.path), fn.line,
                fn.node.col_offset,
                f"`{fn.qualname}` declares "
                f"{sorted(fn.declared) or '[] (effect-free)'} but "
                f"transitively performs undeclared effect(s): {extra}"))
    return out
