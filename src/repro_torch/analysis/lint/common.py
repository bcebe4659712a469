"""Shared model for reprolint: findings, suppressions, modules, annotations.

reprolint is a repo-local AST pass (no third-party deps) that statically
enforces the determinism and array-contract invariants the differential
test suites only sample at runtime. This module holds everything the
checker families share: the finding/suppression model, per-file loading
and scope classification, import-alias resolution, and the parser for
the ``Annotated[F8, "F"]`` shape-spec convention (see
``repro_torch.core.arrays``).

The port's copy of ``repro.analysis.lint.common``, with the same rule
table, suppression syntax and path directive. Its scope root is
``repro_torch/``, and it also loads the CUDA sources under
``kernels/csrc/`` (:class:`CudaSource`), whose suppressions are C++
comments of the same form (``//`` in place of ``#``).
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path, PurePosixPath

__all__ = [
    "RULES", "RULE_CODES", "Finding", "Suppression", "ArrSpec", "FuncSpec",
    "Module", "load_module", "dotted_name", "parse_annotation", "AnnInfo",
    "CudaSource", "load_cuda",
]

# Canonical rule name -> stable code. Suppressions accept either form.
RULES: dict[str, str] = {
    "bad-suppression": "RL001",
    "parse-error": "RL002",
    "global-rng": "RL101",
    "unseeded-rng": "RL102",
    "wall-clock": "RL103",
    "unordered-iteration": "RL104",
    "float-eq": "RL105",
    "commit-mutation": "RL106",
    "contract-missing": "RL201",
    "shape-mismatch": "RL202",
    "kernel-fp64": "RL203",
    "blockspec-shape": "RL204",
    "cache-coherence": "RL301",
    "commit-finality": "RL302",
    "rng-discipline": "RL303",
    "watermark-source": "RL304",
    "effect-mismatch": "RL305",
}
RULE_CODES: dict[str, str] = {code: name for name, code in RULES.items()}

_SUPPRESS_BODY = (r"reprolint:\s*disable=([A-Za-z0-9_,\- ]+?)"
                  r"(?:\s*--\s*(.*?))?\s*$")
_PRETEND_BODY = r"reprolint:\s*pretend-path=(\S+)"
_SUPPRESS_RE = re.compile(r"#\s*" + _SUPPRESS_BODY)
_PRETEND_RE = re.compile(r"#\s*" + _PRETEND_BODY)
# the same directives in a C++ comment
_CPP_SUPPRESS_RE = re.compile(r"//\s*" + _SUPPRESS_BODY)
_CPP_PRETEND_RE = re.compile(r"//\s*" + _PRETEND_BODY)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, attributed to the construct's first line."""

    rule: str          # canonical rule name ("float-eq")
    path: str          # real on-disk path (what editors open)
    line: int
    col: int
    message: str

    @property
    def code(self) -> str:
        return RULES[self.rule]

    def to_dict(self) -> dict[str, object]:
        return {"rule": self.rule, "code": self.code, "path": self.path,
                "line": self.line, "col": self.col, "message": self.message}

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} [{self.rule}] {self.message}")


@dataclasses.dataclass
class Suppression:
    """An inline ``# reprolint: disable=<rules> -- <justification>``."""

    line: int
    rules: set[str]          # canonical names (unknown names dropped)
    unknown: list[str]       # tokens that matched no rule name/code
    justification: str

    @property
    def valid(self) -> bool:
        return bool(self.justification.strip()) and not self.unknown

    def covers(self, rule: str) -> bool:
        return self.valid and rule in self.rules


@dataclasses.dataclass(frozen=True)
class ArrSpec:
    """Parsed array annotation: dtype char + named dims (rank = len(dims))."""

    dtype: str                 # "f" | "i" | "b" | "?" (Arr / unknown dtype)
    dims: tuple[str, ...]      # dim names; ints-as-str and "*" allowed

    @property
    def ndim(self) -> int:
        return len(self.dims)


@dataclasses.dataclass
class FuncSpec:
    """Registry entry for one contract-module function: per-param specs."""

    qualname: str
    line: int
    params: list[str]                  # positional-or-keyword param names
    specs: dict[str, ArrSpec]          # param name -> array spec (if any)
    returns: AnnInfo | None            # parsed return annotation


@dataclasses.dataclass
class AnnInfo:
    """A parsed annotation: what kind of thing it declares."""

    kind: str                  # "scalar" | "array" | "bare-array" | "class"
    #                            | "other" | "missing"
    scalar: str = ""           # for kind=="scalar": "float"|"int"|"bool"|...
    spec: ArrSpec | None = None        # for kind=="array"
    class_name: str = ""       # for kind=="class": e.g. "FlowTable"
    spec_error: str = ""       # malformed shape-spec string, if any


@dataclasses.dataclass
class Module:
    """One analyzed source file plus its derived lint context."""

    path: Path                 # real path on disk
    logical: str               # posix path used for scope decisions
    source: str
    lines: list[str]
    tree: ast.Module
    suppressions: dict[int, Suppression]
    aliases: dict[str, str]    # local name -> dotted import target

    def in_dir(self, *parts: str) -> bool:
        """True when the logical path contains ``/parts[0]/parts[1]/...``."""
        needle = "/".join(parts)
        return f"/{needle}/" in f"/{self.logical}"

    @property
    def basename(self) -> str:
        return PurePosixPath(self.logical).name

    @property
    def is_core(self) -> bool:
        return self.in_dir("repro_torch", "core")

    @property
    def is_service(self) -> bool:
        return self.in_dir("repro_torch", "service")

    @property
    def is_kernels(self) -> bool:
        return self.in_dir("repro_torch", "kernels")

    @property
    def is_obs(self) -> bool:
        return self.in_dir("repro_torch", "obs")

    @property
    def scheduling_scope(self) -> bool:
        """core/ + service/ + kernels/ — where determinism rules bind hard."""
        return self.is_core or self.is_service or self.is_kernels


def _parse_suppressions(lines: list[str],
                        pattern: re.Pattern[str] = _SUPPRESS_RE
                        ) -> dict[int, Suppression]:
    out: dict[int, Suppression] = {}
    for lineno, text in enumerate(lines, start=1):
        m = pattern.search(text)
        if not m:
            continue
        rules: set[str] = set()
        unknown: list[str] = []
        for tok in re.split(r"[,\s]+", m.group(1).strip()):
            if not tok:
                continue
            if tok in RULES:
                rules.add(tok)
            elif tok.upper() in RULE_CODES:
                rules.add(RULE_CODES[tok.upper()])
            else:
                unknown.append(tok)
        out[lineno] = Suppression(line=lineno, rules=rules, unknown=unknown,
                                  justification=m.group(2) or "")
    return out


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names to the dotted import they stand for.

    ``import numpy as np`` -> {"np": "numpy"};
    ``from datetime import datetime`` -> {"datetime": "datetime.datetime"};
    ``from repro_torch.core.engine import FlowTable`` ->
    {"FlowTable": "repro_torch.core.engine.FlowTable"}.
    """
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level:      # relative import: resolve package-locally
                base = node.module
            else:
                base = node.module
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{base}.{a.name}"
    return aliases


def dotted_name(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve an Attribute/Name chain to a dotted path via import aliases.

    Returns None when the chain root is not a known import (e.g. a local
    variable that merely shadows a module name).
    """
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id)
    if root is None:
        return None
    parts.append(root)
    return ".".join(reversed(parts))


_ALIAS_DTYPES = {"F8": "f", "F4": "f", "I8": "i", "I4": "i", "B1": "b",
                 "Arr": "?"}
_SPEC_TOKEN = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*|\d+|\*)$")
_SCALARS = {"float": "float", "int": "int", "bool": "bool", "str": "str",
            "bytes": "bytes", "complex": "complex", "None": "None"}


def _leaf(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def parse_spec(text: str) -> tuple[tuple[str, ...] | None, str]:
    """Parse a shape-spec string; returns (dims, error)."""
    toks = tuple(t for t in re.split(r"[,\s]+", text.strip()) if t)
    for t in toks:
        if not _SPEC_TOKEN.match(t):
            return None, f"bad shape-spec token {t!r}"
    return toks, ""


def parse_annotation(node: ast.AST | None) -> AnnInfo:
    """Classify an annotation AST into the contract taxonomy."""
    if node is None:
        return AnnInfo(kind="missing")
    # quoted annotations: "FlowTable"
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return AnnInfo(kind="other")
    # unwrap Optional-by-union: `X | None`
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        for side in (node.left, node.right):
            info = parse_annotation(side)
            if info.kind not in ("scalar", "other") or info.scalar != "None":
                if info.kind != "other":
                    return info
        return AnnInfo(kind="other")
    leaf = _leaf(node)
    if isinstance(node, ast.Name) and node.id in _SCALARS:
        return AnnInfo(kind="scalar", scalar=_SCALARS[node.id])
    if leaf in _ALIAS_DTYPES:
        return AnnInfo(kind="bare-array",
                       spec=ArrSpec(dtype=_ALIAS_DTYPES[leaf], dims=()))
    if leaf in ("ndarray", "NDArray"):
        return AnnInfo(kind="bare-array", spec=ArrSpec(dtype="?", dims=()))
    if isinstance(node, ast.Subscript):
        base = _leaf(node.value)
        if base == "Annotated":
            elts = (node.slice.elts
                    if isinstance(node.slice, ast.Tuple) else [node.slice])
            if not elts:
                return AnnInfo(kind="other")
            inner = parse_annotation(elts[0])
            specs = [e.value for e in elts[1:]
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            if inner.kind in ("bare-array", "array"):
                if not specs:
                    return AnnInfo(kind="bare-array", spec=inner.spec,
                                   spec_error="Annotated array without a "
                                              "shape-spec string")
                dims, err = parse_spec(specs[0])
                if dims is None:
                    return AnnInfo(kind="array", spec=inner.spec,
                                   spec_error=err)
                dtype = inner.spec.dtype if inner.spec else "?"
                return AnnInfo(kind="array",
                               spec=ArrSpec(dtype=dtype, dims=dims))
            return inner
        if base in ("ndarray", "NDArray"):
            return AnnInfo(kind="bare-array",
                           spec=ArrSpec(dtype="?", dims=()))
        if base in ("Optional",):
            return parse_annotation(
                node.slice if not isinstance(node.slice, ast.Tuple)
                else node.slice.elts[0])
        # list[...] / dict[...] / tuple[...] / Sequence[...]: structured,
        # not an array contract
        return AnnInfo(kind="other")
    if isinstance(node, (ast.Name, ast.Attribute)) and leaf[:1].isupper():
        return AnnInfo(kind="class", class_name=leaf)
    return AnnInfo(kind="other")


def _logical(path: Path, root: Path | None, source: str,
             pattern: re.Pattern[str]) -> str:
    logical = path.as_posix()
    if root is not None:
        try:
            logical = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            logical = path.as_posix()
    m = pattern.search(source)
    return m.group(1) if m else logical


def load_module(path: Path, root: Path | None = None) -> Module:
    """Load + parse one file; raises OSError/SyntaxError (caller reports).

    Honors a pretend-path directive (a ``reprolint:`` comment) so the
    golden corpus under ``tests/lint_corpus/`` can exercise path-scoped
    rules.
    """
    source = path.read_text(encoding="utf-8")
    lines = source.splitlines()
    logical = _logical(path, root, source, _PRETEND_RE)
    tree = ast.parse(source, filename=str(path))
    return Module(path=path, logical=logical, source=source, lines=lines,
                  tree=tree, suppressions=_parse_suppressions(lines),
                  aliases=_import_aliases(tree))


@dataclasses.dataclass
class CudaSource:
    """One CUDA C++ source under ``kernels/csrc/``, read as text.

    ``code`` holds the same lines with every comment and string or
    character literal blanked to spaces, so a token search never matches
    prose (``double`` in a comment) and columns stay those of ``lines``.
    """

    path: Path
    logical: str
    lines: list[str]
    code: list[str]
    suppressions: dict[int, Suppression]

    @property
    def basename(self) -> str:
        return PurePosixPath(self.logical).name

    @property
    def is_kernels(self) -> bool:
        return "/repro_torch/kernels/" in f"/{self.logical}"


def _blank_comments(source: str) -> str:
    """``source`` with C++ comments and literals replaced by spaces
    (newlines kept)."""
    out: list[str] = []
    i, n = 0, len(source)
    while i < n:
        two = source[i:i + 2]
        if two == "//":
            j = source.find("\n", i)
            j = n if j < 0 else j
        elif two == "/*":
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif source[i] in "\"'":
            quote, j = source[i], i + 1
            while j < n and source[j] != quote and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            j = min(j + 1, n)
        else:
            out.append(source[i])
            i += 1
            continue
        out.append("".join(c if c == "\n" else " " for c in source[i:j]))
        i = j
    return "".join(out)


def load_cuda(path: Path, root: Path | None = None) -> CudaSource:
    """Read one ``.cu`` source; raises OSError (caller reports)."""
    source = path.read_text(encoding="utf-8")
    lines = source.splitlines()
    return CudaSource(
        path=path, logical=_logical(path, root, source, _CPP_PRETEND_RE),
        lines=lines, code=_blank_comments(source).splitlines(),
        suppressions=_parse_suppressions(lines, _CPP_SUPPRESS_RE))
