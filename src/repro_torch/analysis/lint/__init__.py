"""reprolint: determinism & array-contract static analysis for the port.

The port's copy of ``repro.analysis.lint``: the same rules, codes and
suppression syntax, scoped to ``repro_torch/`` and extended to what the
port can break that the reference cannot (torch's global generator, exact
comparisons of float tensors, in-place writes to committed tensors, fp64
and FMA contraction in a CUDA kernel, tile constants that drift from the
kernel's). Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch \\
        tests/test_torch_*.py chip_smoke.py examples/torch_*.py
    PYTHONPATH=src python -m repro_torch.analysis.lint --json lint.json \\
        src/repro_torch

The differential suites (engine-vs-oracle bit-exactness, chunked
PCG64 stream identity, delta-splice identity) *sample* the determinism
invariants at runtime; reprolint checks them on every line. Rules are
documented in DESIGN.md §Determinism invariants and in each checker's
docstring; findings can be suppressed inline with a comment on the
finding's line, ``reprolint: disable=<rule>[,<rule>] -- <justification>``
after ``#`` in Python or ``//`` in a CUDA source.

The justification text is mandatory: a suppression without one (or
naming an unknown rule) is itself a finding (``bad-suppression``) and
the suppression is ignored. Walking a directory also reads the CUDA
sources under ``kernels/csrc/``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Iterator

from .common import (CudaSource, Finding, FuncSpec, Module, RULES,
                     Suppression, load_cuda, load_module)
from .contracts import (build_registry, check_contracts, check_cuda,
                        check_kernel_pairs)
from .determinism import check_determinism
from .protocol import check_protocol

__all__ = ["LintReport", "lint_paths", "lint_files", "RULES",
           "DEFAULT_EXCLUDES"]

#: directory names never descended into when walking a tree. The golden
#: corpus is excluded on purpose: it exists to *fail* the linter and is
#: linted explicitly by the tests (explicitly named files are always
#: analyzed, walk exclusions notwithstanding).
DEFAULT_EXCLUDES = {"lint_corpus", "__pycache__", ".git", "out",
                    ".pytest_cache", ".mypy_cache"}


@dataclasses.dataclass
class LintReport:
    findings: list[Finding]            # unsuppressed: these gate CI
    suppressed: list[Finding]          # matched by a justified suppression
    files: int                         # Python modules and CUDA sources
    #: call-graph/effect statistics from the RL30x protocol pass
    protocol: dict[str, object] = dataclasses.field(default_factory=dict)
    #: the CUDA sources read by the kernel rules
    cuda_files: list[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> dict[str, object]:
        return {
            "ok": self.ok,
            "files": self.files,
            "cuda_files": self.cuda_files,
            "finding_count": len(self.findings),
            "suppression_count": len(self.suppressed),
            "by_rule": self.by_rule(),
            "protocol": self.protocol,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
        }


def _is_kernel_source(f: Path) -> bool:
    return f.suffix in (".cu", ".cuh") and f.parent.name == "csrc" \
        and f.parent.parent.name == "kernels"


def _collect(paths: Iterable[str | Path]) -> list[Path]:
    out: list[Path] = []
    seen: set[Path] = set()

    def add(f: Path) -> None:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)

    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if any(part in DEFAULT_EXCLUDES for part in f.parts):
                    continue
                if f.suffix == ".py" or _is_kernel_source(f):
                    add(f)
        elif p.suffix in (".py", ".cu", ".cuh"):
            add(p)
    return out


def _lint_module(mod: Module,
                 registry: dict[str, dict[str, FuncSpec]]) -> Iterator[Finding]:
    yield from check_determinism(mod)
    yield from check_contracts(mod, registry)


def _bad_suppressions(path: Path,
                      suppressions: dict[int, Suppression]
                      ) -> Iterator[Finding]:
    for sup in suppressions.values():
        if sup.unknown:
            yield Finding(
                "bad-suppression", str(path), sup.line, 0,
                f"suppression names unknown rule(s) "
                f"{', '.join(sup.unknown)}; the disable is ignored")
        if not sup.justification.strip():
            yield Finding(
                "bad-suppression", str(path), sup.line, 0,
                "suppression without a justification (`-- <why>` is "
                "mandatory); the disable is ignored")


def lint_files(files: Iterable[Path], root: Path | None = None) -> LintReport:
    modules: list[Module] = []
    sources: list[CudaSource] = []
    findings: list[Finding] = []
    n_files = 0
    for path in files:
        n_files += 1
        try:
            if path.suffix in (".cu", ".cuh"):
                sources.append(load_cuda(path, root=root))
            else:
                modules.append(load_module(path, root=root))
        except SyntaxError as e:
            findings.append(Finding(
                "parse-error", str(path), e.lineno or 1, 0,
                f"file does not parse: {e.msg}"))
        except OSError as e:
            findings.append(Finding(
                "parse-error", str(path), 1, 0, f"unreadable: {e}"))
    registry = build_registry(modules)

    kept: list[Finding] = list(findings)
    suppressed: list[Finding] = []
    sups = {str(f.path): f.suppressions for f in [*modules, *sources]}

    def _route(f: Finding) -> None:
        sup = sups[f.path].get(f.line)
        if sup is not None and sup.covers(f.rule):
            suppressed.append(f)
        else:
            kept.append(f)

    for mod in modules:
        kept.extend(_bad_suppressions(mod.path, mod.suppressions))
        for f in _lint_module(mod, registry):
            _route(f)
    for src in sources:
        kept.extend(_bad_suppressions(src.path, src.suppressions))
        for f in check_cuda(src):
            _route(f)
    for f in check_kernel_pairs(modules, sources):
        _route(f)
    proto_findings, protocol = check_protocol(modules)
    for f in proto_findings:
        _route(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintReport(findings=kept, suppressed=suppressed, files=n_files,
                      protocol=protocol,
                      cuda_files=sorted(src.logical for src in sources))


def lint_paths(paths: Iterable[str | Path],
               root: Path | None = None) -> LintReport:
    """Lint files/trees; directories are walked minus DEFAULT_EXCLUDES."""
    if root is None:
        root = Path.cwd()
    return lint_files(_collect(paths), root=root)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="determinism & array-contract static analysis")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report to PATH "
                         "('-' for stdout)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-finding text output")
    args = ap.parse_args(argv)

    report = lint_paths(args.paths)
    if args.json == "-":
        print(json.dumps(report.to_dict(), indent=2))
    elif args.json:
        Path(args.json).write_text(
            json.dumps(report.to_dict(), indent=2) + "\n", encoding="utf-8")
    if not args.quiet:
        for f in report.findings:
            print(f.render())
        by_rule = ", ".join(f"{r}={n}" for r, n in
                            sorted(report.by_rule().items()))
        status = "clean" if report.ok else f"FAILED ({by_rule})"
        print(f"reprolint: {report.files} files "
              f"({len(report.cuda_files)} CUDA sources), "
              f"{len(report.findings)} findings, "
              f"{len(report.suppressed)} suppressed -> {status}")
    return 0 if report.ok else 1
