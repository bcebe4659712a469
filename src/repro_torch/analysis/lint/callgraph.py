"""Module-level call graph over the analyzed source set (reprolint v2).

The RL3xx protocol rules (``protocol.py``) are *pairing* properties over
paths — a fingerprint mutation must reach a cache purge, committed-row
mutation must stay beneath blessed entry points — so they need edges, not
lines. This module builds them, deliberately conservatively:

- a plain ``name(...)`` resolves to a same-module function/class or, via
  the import aliases, to a function/class of another *analyzed* module;
- ``ClassName(...)`` resolves to ``ClassName.__init__`` when defined;
- ``self.method(...)`` resolves within the enclosing class (no
  inheritance: base-class methods are not searched);
- ``self.attr.method(...)`` and ``var.method(...)`` resolve through a
  recorded *type fact* — the attribute/variable was assigned
  ``ClassName(...)`` somewhere in the class/function, or annotated with a
  known class name.

Anything else (higher-order calls, dynamic dispatch, objects of unknown
type) produces NO edge: the effect analysis under-approximates; it never
guesses. The soundness caveats are documented in DESIGN.md §"Effect &
protocol analysis".
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from .common import Module, dotted_name, parse_annotation

__all__ = ["FuncNode", "ClassInfo", "CallGraph", "build_callgraph",
           "EFFECT_DECORATOR"]

#: Decorator leaf name recognized as an effect declaration
#: (``repro_torch.core.effects.effects``); matched syntactically so the corpus
#: and the real tree need no import execution.
EFFECT_DECORATOR = "effects"

_CTOR_NAMES = ("__init__", "__post_init__")


@dataclasses.dataclass
class FuncNode:
    """One function/method definition in the analyzed set."""

    uid: str                   # "<logical path>::<qualname>"
    module: Module
    qualname: str              # "Class.method" or "func"
    cls: str                   # enclosing class name, "" for module-level
    node: ast.FunctionDef | ast.AsyncFunctionDef
    declared: frozenset[str] | None    # @effects(...) set, None = undeclared
    declared_unknown: tuple[str, ...]  # decorator names outside the vocabulary

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def is_ctor(self) -> bool:
        return self.node.name in _CTOR_NAMES

    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in
                list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]


@dataclasses.dataclass
class ClassInfo:
    """One class definition: its methods and attribute type facts."""

    name: str
    module: Module
    methods: dict[str, str]        # method name -> FuncNode uid
    attr_types: dict[str, str]     # self.<attr> -> class NAME (unresolved)


def _decorator_effects(
        fn: ast.FunctionDef | ast.AsyncFunctionDef,
        known: frozenset[str]) -> tuple[frozenset[str] | None, tuple[str, ...]]:
    """Extract an ``@effects(...)`` declaration, if present."""
    for dec in fn.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        f = dec.func
        leaf = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if leaf != EFFECT_DECORATOR:
            continue
        names: list[str] = []
        unknown: list[str] = []
        for a in dec.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                (names if a.value in known else unknown).append(a.value)
            else:
                unknown.append(ast.dump(a)[:40])
        return frozenset(names), tuple(unknown)
    return None, ()


def _class_leaf(node: ast.expr) -> str:
    """Leaf name of a constructor-call func, '' when not name-shaped."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


class CallGraph:
    """Nodes, edges, and the type facts used to resolve them."""

    def __init__(self, modules: list[Module],
                 effect_vocab: frozenset[str]) -> None:
        self.modules = modules
        self.vocab = effect_vocab
        self.nodes: dict[str, FuncNode] = {}
        self.edges: dict[str, set[str]] = {}
        #: call sites per caller: (callee uid, the Call node) — RL304 reads
        #: argument expressions at resolved sites
        self.sites: dict[str, list[tuple[str, ast.Call]]] = {}
        #: per module logical path: top-level function name -> uid
        self._funcs: dict[str, dict[str, str]] = {}
        #: per module logical path: class name -> ClassInfo
        self.classes: dict[str, dict[str, ClassInfo]] = {}
        self._collect()
        self._link()

    # -- construction -------------------------------------------------------
    def _collect(self) -> None:
        for mod in self.modules:
            funcs: dict[str, str] = {}
            classes: dict[str, ClassInfo] = {}
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    uid = f"{mod.logical}::{node.name}"
                    funcs[node.name] = uid
                    self._add_node(uid, mod, node.name, "", node)
                elif isinstance(node, ast.ClassDef):
                    info = ClassInfo(name=node.name, module=mod,
                                     methods={}, attr_types={})
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            uid = f"{mod.logical}::{node.name}.{item.name}"
                            info.methods[item.name] = uid
                            self._add_node(uid, mod,
                                           f"{node.name}.{item.name}",
                                           node.name, item)
                        elif isinstance(item, ast.AnnAssign) and isinstance(
                                item.target, ast.Name):
                            # dataclass-style field annotation with a class
                            ann = parse_annotation(item.annotation)
                            if ann.kind == "class":
                                info.attr_types[item.target.id] = \
                                    ann.class_name
                    # `self.X = ClassName(...)` type facts from every method
                    for item in node.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            self._self_attr_facts(item, info)
                    classes[node.name] = info
            self._funcs[mod.logical] = funcs
            self.classes[mod.logical] = classes

    def _add_node(self, uid: str, mod: Module, qualname: str, cls: str,
                  node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        declared, unknown = _decorator_effects(node, self.vocab)
        self.nodes[uid] = FuncNode(
            uid=uid, module=mod, qualname=qualname, cls=cls, node=node,
            declared=declared, declared_unknown=unknown)
        self.edges[uid] = set()
        self.sites[uid] = []

    @staticmethod
    def _self_attr_facts(fn: ast.FunctionDef | ast.AsyncFunctionDef,
                         info: ClassInfo) -> None:
        for node in ast.walk(fn):
            target: ast.expr | None = None
            value: ast.expr | None = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.value
                ann = parse_annotation(node.annotation)
                if (ann.kind == "class"
                        and isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    info.attr_types.setdefault(target.attr, ann.class_name)
            if (target is None or value is None
                    or not isinstance(target, ast.Attribute)
                    or not isinstance(target.value, ast.Name)
                    or target.value.id != "self"):
                continue
            if isinstance(value, ast.Call):
                leaf = _class_leaf(value.func)
                if leaf[:1].isupper():
                    info.attr_types.setdefault(target.attr, leaf)

    # -- resolution helpers -------------------------------------------------
    def _resolve_module(self, dotted_mod: str,
                        importer: Module) -> Module | None:
        """Find the analyzed module a dotted import path refers to."""
        base = dotted_mod.replace(".", "/")
        cands: list[Module] = []
        for suffix in (base + ".py", base + "/__init__.py"):
            cands = [m for m in self.modules
                     if m.logical == suffix
                     or m.logical.endswith("/" + suffix)]
            if cands:
                break
        if not cands:
            return None
        if len(cands) > 1:
            here = importer.logical.rsplit("/", 1)[0]
            same = [m for m in cands
                    if m.logical.rsplit("/", 1)[0] == here]
            if same:
                cands = same
        return cands[0]

    def _resolve_symbol(self, name: str, mod: Module, depth: int = 0
                        ) -> tuple[str, str] | tuple[str, ClassInfo] | None:
        """Resolve NAME in a module to ("func", uid) or ("class", info).

        Follows import aliases across analyzed modules, including package
        ``__init__.py`` re-export chains (bounded depth — re-exports are
        shallow in practice; the bound only guards import cycles).
        """
        got = self._funcs.get(mod.logical, {}).get(name)
        if got is not None:
            return ("func", got)
        cls = self.classes.get(mod.logical, {}).get(name)
        if cls is not None:
            return ("class", cls)
        if depth >= 5:
            return None
        dotted = mod.aliases.get(name)
        if dotted and "." in dotted:
            mod_part, leaf = dotted.rsplit(".", 1)
            target = self._resolve_module(mod_part, mod)
            if target is not None and target.logical != mod.logical:
                return self._resolve_symbol(leaf, target, depth + 1)
        return None

    def _resolve_class(self, name: str, mod: Module) -> ClassInfo | None:
        """Resolve a class NAME in a module's context (local, then import)."""
        sym = self._resolve_symbol(name, mod)
        if sym is not None and sym[0] == "class" and isinstance(
                sym[1], ClassInfo):
            return sym[1]
        return None

    def class_of(self, name: str, mod: Module) -> str | None:
        """Class NAME a local/imported symbol refers to, if it is one."""
        if name in self.classes.get(mod.logical, {}):
            return name
        dotted = mod.aliases.get(name)
        if dotted:
            leaf = dotted.rsplit(".", 1)[1] if "." in dotted else dotted
            if leaf[:1].isupper():
                return leaf
        return None

    def local_types(self, fn: FuncNode) -> dict[str, str]:
        """Variable/parameter name -> class NAME facts inside one function."""
        out: dict[str, str] = {}
        a = fn.node.args
        for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            ann = parse_annotation(p.annotation)
            if ann.kind == "class":
                out[p.arg] = ann.class_name
        for node in ast.walk(fn.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)):
                continue
            target = node.targets[0]
            if isinstance(target, ast.Name):
                leaf = _class_leaf(node.value.func)
                if leaf[:1].isupper():
                    out.setdefault(target.id, leaf)
        return out

    def expr_class(self, fn: FuncNode, expr: ast.expr,
                   local_types: dict[str, str]) -> str | None:
        """Class NAME of an expression, via the recorded type facts."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fn.cls:
                return fn.cls
            return local_types.get(expr.id)
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and fn.cls):
            info = self.classes.get(fn.module.logical, {}).get(fn.cls)
            if info is not None:
                return info.attr_types.get(expr.attr)
        return None

    # -- edge construction --------------------------------------------------
    def _link(self) -> None:
        for uid, fn in self.nodes.items():
            locals_ = self.local_types(fn)
            for call in self._calls(fn.node):
                callee = self._callee(fn, call, locals_)
                if callee is not None and callee in self.nodes:
                    self.edges[uid].add(callee)
                    self.sites[uid].append((callee, call))

    @staticmethod
    def _calls(fn: ast.FunctionDef | ast.AsyncFunctionDef
               ) -> Iterator[ast.Call]:
        # nested defs/lambdas are attributed to the enclosing function:
        # they are local helpers, invoked (if ever) on its paths
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                yield node

    def _callee(self, fn: FuncNode, call: ast.Call,
                local_types: dict[str, str]) -> str | None:
        f = call.func
        mod = fn.module
        if isinstance(f, ast.Name):
            return self._resolve_plain(f.id, fn)
        if isinstance(f, ast.Attribute):
            meth = f.attr
            base_cls = self.expr_class(fn, f.value, local_types)
            if base_cls is not None:
                info = self._resolve_class(base_cls, mod)
                if info is not None:
                    return info.methods.get(meth)
                return None
            # module-dotted call: engine.run_fast(...) via import alias
            dotted = dotted_name(f, mod.aliases)
            if dotted and "." in dotted:
                mod_part, leaf = dotted.rsplit(".", 1)
                target = self._resolve_module(mod_part, mod)
                if target is not None:
                    return self._sym_to_uid(
                        self._resolve_symbol(leaf, target))
        return None

    @staticmethod
    def _sym_to_uid(
            sym: tuple[str, str] | tuple[str, ClassInfo] | None
    ) -> str | None:
        if sym is None:
            return None
        kind, val = sym
        if kind == "func" and isinstance(val, str):
            return val
        if kind == "class" and isinstance(val, ClassInfo):
            return val.methods.get("__init__")
        return None

    def _resolve_plain(self, name: str, fn: FuncNode) -> str | None:
        return self._sym_to_uid(self._resolve_symbol(name, fn.module))

    # -- queries ------------------------------------------------------------
    def holds_cache(self, info: ClassInfo) -> bool:
        """True when a class holds a ``ProgramCache``-typed attribute."""
        return any(cls == "ProgramCache"
                   for cls in info.attr_types.values())

    @property
    def n_edges(self) -> int:
        return sum(len(e) for e in self.edges.values())


def build_callgraph(modules: list[Module],
                    effect_vocab: frozenset[str]) -> CallGraph:
    return CallGraph(modules, effect_vocab)
