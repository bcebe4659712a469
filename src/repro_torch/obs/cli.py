"""``python -m repro_torch.obs`` — trace summarization and regression
diffing.

The port's copy of ``repro.obs.cli``: the same subcommands, flags, stdout
and exit codes, over the port's traces (``repro_torch.obs.trace``, the
reference's record schema) and over ``BENCH_*.json`` artifacts.

Subcommands:

- ``summarize TRACE.jsonl``   per-phase wall breakdown + top-k slow ticks
- ``validate TRACE.jsonl``    schema-check every record (exit 1 on bad)
- ``diff OLD.jsonl NEW.jsonl``  per-phase wall/count deltas, regression
  report (machine-readable with ``--json``, exit 1 on ``--fail-over``
  threshold breach)
- ``diff-bench OLD.json NEW.json``  compare two ``BENCH_*.json``
  artifacts (or directories of them) leaf-by-leaf; ``--floors FILE``
  additionally checks named candidate leaves against committed minima
  (exit 1 on any breach)
- ``export-chrome TRACE.jsonl -o OUT.json``  Perfetto/chrome://tracing

All output is plain text on stdout (or JSON with ``--json``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from .trace import to_chrome_trace

__all__ = ["main", "load_trace", "validate_records", "phase_stats",
           "diff_phases", "load_bench", "diff_bench", "check_floors"]

_SPAN_REQUIRED = {"kind", "name", "sid", "parent", "depth", "ts", "dur",
                  "attrs"}
_EVENT_REQUIRED = {"kind", "name", "sid", "parent", "depth", "ts", "attrs"}


def load_trace(path: str | Path) -> list[dict[str, Any]]:
    """Read one JSONL trace file into a list of record dicts."""
    out: list[dict[str, Any]] = []
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not JSON: {exc}") from exc
            if not isinstance(rec, dict):
                raise ValueError(f"{path}:{lineno}: record is not an object")
            out.append(rec)
    return out


def validate_records(records: list[dict[str, Any]]) -> list[str]:
    """Schema-check every record; returns human-readable problems.

    Checks field presence and types, span/event kind discipline, sid
    uniqueness, parent references, and non-negative durations.
    """
    problems: list[str] = []
    sids: set[int] = set()
    for i, rec in enumerate(records):
        where = f"record {i} ({rec.get('name', '?')!r})"
        kind = rec.get("kind")
        if kind not in ("span", "event"):
            problems.append(f"{where}: kind must be span|event, got {kind!r}")
            continue
        required = _SPAN_REQUIRED if kind == "span" else _EVENT_REQUIRED
        missing = required - rec.keys()
        if missing:
            problems.append(f"{where}: missing fields {sorted(missing)}")
            continue
        if not isinstance(rec["name"], str) or not rec["name"]:
            problems.append(f"{where}: name must be a non-empty string")
        if not isinstance(rec["sid"], int):
            problems.append(f"{where}: sid must be an int")
        elif rec["sid"] in sids:
            problems.append(f"{where}: duplicate sid {rec['sid']}")
        else:
            sids.add(rec["sid"])
        parent = rec["parent"]
        if parent is not None and not isinstance(parent, int):
            problems.append(f"{where}: parent must be int or null")
        if not isinstance(rec["depth"], int) or rec["depth"] < 0:
            problems.append(f"{where}: depth must be an int >= 0")
        if (parent is None) != (rec.get("depth") == 0):
            problems.append(f"{where}: depth/parent mismatch "
                            f"(parent={parent!r}, depth={rec['depth']!r})")
        if not isinstance(rec["ts"], (int, float)):
            problems.append(f"{where}: ts must be a number")
        if kind == "span":
            dur = rec["dur"]
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: dur must be a number >= 0")
        if not isinstance(rec["attrs"], dict):
            problems.append(f"{where}: attrs must be an object")
    # parent references must resolve to a recorded sid
    for i, rec in enumerate(records):
        parent = rec.get("parent")
        if isinstance(parent, int) and parent not in sids:
            problems.append(f"record {i} ({rec.get('name', '?')!r}): "
                            f"parent sid {parent} not in trace")
    return problems


def phase_stats(records: list[dict[str, Any]]
                ) -> dict[str, dict[str, float]]:
    """Aggregate spans by name: count, total/mean/max wall seconds."""
    out: dict[str, dict[str, float]] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        name = str(rec.get("name", "?"))
        dur = float(rec.get("dur", 0.0))
        st = out.setdefault(name, {"count": 0.0, "total_s": 0.0,
                                   "max_s": 0.0})
        st["count"] += 1
        st["total_s"] += dur
        st["max_s"] = max(st["max_s"], dur)
    for st in out.values():
        st["mean_s"] = st["total_s"] / st["count"] if st["count"] else 0.0
    return out


def _event_counts(records: list[dict[str, Any]]) -> dict[str, int]:
    out: dict[str, int] = {}
    for rec in records:
        if rec.get("kind") == "event":
            name = str(rec.get("name", "?"))
            out[name] = out.get(name, 0) + 1
    return out


def _top_slow(records: list[dict[str, Any]], name: str,
              k: int) -> list[dict[str, Any]]:
    spans = [r for r in records
             if r.get("kind") == "span" and r.get("name") == name]
    spans.sort(key=lambda r: float(r.get("dur", 0.0)), reverse=True)
    return spans[:k]


def summarize(records: list[dict[str, Any]], top_k: int = 5
              ) -> dict[str, Any]:
    """Structured summary: per-phase stats, event counts, top slow ticks."""
    stats = phase_stats(records)
    return {
        "n_records": len(records),
        "phases": stats,
        "events": _event_counts(records),
        "top_slow_ticks": [
            {"sid": r.get("sid"), "dur_s": float(r.get("dur", 0.0)),
             "attrs": r.get("attrs", {})}
            for r in _top_slow(records, "tick", top_k)
        ],
    }


def _print_summary(summ: dict[str, Any]) -> None:
    phases: dict[str, dict[str, float]] = summ["phases"]
    total = sum(st["total_s"] for name, st in phases.items()
                if "/" not in name) or 1.0
    print(f"{'phase':<22}{'count':>8}{'total_s':>12}{'mean_s':>12}"
          f"{'max_s':>12}{'share':>8}")
    for name in sorted(phases, key=lambda n: -phases[n]["total_s"]):
        st = phases[name]
        print(f"{name:<22}{int(st['count']):>8}{st['total_s']:>12.6f}"
              f"{st['mean_s']:>12.6f}{st['max_s']:>12.6f}"
              f"{st['total_s'] / total:>8.1%}")
    if summ["events"]:
        print("\nevents:")
        for name in sorted(summ["events"]):
            print(f"  {name:<20}{summ['events'][name]:>8}")
    if summ["top_slow_ticks"]:
        print("\ntop slow ticks:")
        for t in summ["top_slow_ticks"]:
            attrs = " ".join(f"{k}={v}" for k, v in t["attrs"].items())
            print(f"  sid={t['sid']:<6}{t['dur_s']:>12.6f}s  {attrs}")


def diff_phases(old: dict[str, dict[str, float]],
                new: dict[str, dict[str, float]]) -> list[dict[str, Any]]:
    """Per-phase delta rows between two ``phase_stats`` maps."""
    rows: list[dict[str, Any]] = []
    for name in sorted(old.keys() | new.keys()):
        o = old.get(name, {"count": 0.0, "total_s": 0.0, "mean_s": 0.0})
        n = new.get(name, {"count": 0.0, "total_s": 0.0, "mean_s": 0.0})
        o_mean, n_mean = o.get("mean_s", 0.0), n.get("mean_s", 0.0)
        ratio = (n_mean / o_mean) if o_mean > 0 else float("inf")
        rows.append({
            "phase": name,
            "count_old": int(o["count"]), "count_new": int(n["count"]),
            "mean_s_old": o_mean, "mean_s_new": n_mean,
            "total_s_old": o.get("total_s", 0.0),
            "total_s_new": n.get("total_s", 0.0),
            "mean_ratio": ratio,
        })
    return rows


def _print_diff(rows: list[dict[str, Any]]) -> None:
    print(f"{'phase':<22}{'count':>14}{'mean_s old':>12}{'mean_s new':>12}"
          f"{'ratio':>8}")
    for r in rows:
        ratio = r["mean_ratio"]
        rs = f"{ratio:.2f}x" if ratio != float("inf") else "new"
        print(f"{r['phase']:<22}"
              f"{str(r['count_old']) + '->' + str(r['count_new']):>14}"
              f"{r['mean_s_old']:>12.6f}{r['mean_s_new']:>12.6f}{rs:>8}")


# -- bench artifact diffing ---------------------------------------------------

def load_bench(path: str | Path) -> dict[str, Any]:
    """Load one BENCH_*.json artifact (as written by benchmarks/run.py)."""
    with open(path, encoding="utf-8") as fh:
        doc = fh.read()
    obj = json.loads(doc)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: bench artifact must be a JSON object")
    return obj


def _numeric_leaves(obj: Any, prefix: str = "") -> dict[str, float]:
    """Flatten nested dicts/lists to dotted-path -> numeric leaf."""
    out: dict[str, float] = {}
    if isinstance(obj, bool):
        return out
    if isinstance(obj, (int, float)):
        out[prefix or "."] = float(obj)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            p = f"{prefix}.{k}" if prefix else str(k)
            out.update(_numeric_leaves(obj[k], p))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(_numeric_leaves(v, f"{prefix}[{i}]"))
    return out


def diff_bench(old: dict[str, Any], new: dict[str, Any],
               threshold: float = 0.10) -> dict[str, Any]:
    """Leaf-by-leaf comparison of two bench artifacts.

    ``threshold`` flags relative changes larger than the fraction given;
    wall-time keys are always reported but never counted as regressions
    on their own below 2x (bench wall time is environment-noisy).
    """
    o, n = _numeric_leaves(old), _numeric_leaves(new)
    rows: list[dict[str, Any]] = []
    flagged = 0
    for key in sorted(o.keys() | n.keys()):
        ov, nv = o.get(key), n.get(key)
        if ov is None or nv is None:
            rows.append({"key": key, "old": ov, "new": nv,
                         "rel_change": None, "flag": "missing"})
            flagged += 1
            continue
        if ov == nv:
            continue
        rel = (nv - ov) / abs(ov) if ov != 0 else float("inf")
        noisy = key.endswith("wall_s") or ".wall_s" in key
        limit = 1.0 if noisy else threshold
        flag = "changed" if abs(rel) > limit else ""
        if flag:
            flagged += 1
        rows.append({"key": key, "old": ov, "new": nv,
                     "rel_change": rel if rel != float("inf") else None,
                     "flag": flag})
    return {"rows": rows, "n_compared": len(o.keys() | n.keys()),
            "n_flagged": flagged, "threshold": threshold}


def check_floors(new: dict[str, Any],
                 floors: dict[str, float]) -> list[str]:
    """Check a candidate artifact's leaves against committed minima.

    ``floors`` maps a dotted leaf path (as flattened by
    ``_numeric_leaves``, e.g. ``rows[2].loc_reuse_mean``) to the minimum
    value the candidate must reach. A MISSING leaf is a violation too —
    a renamed or dropped metric must not silently pass the gate. Returns
    human-readable violation messages (empty = all floors hold).
    """
    leaves = _numeric_leaves(new)
    problems: list[str] = []
    for key in sorted(floors):
        floor = float(floors[key])
        val = leaves.get(key)
        if val is None:
            problems.append(
                f"{key}: leaf missing from candidate artifact "
                f"(committed floor {floor:g})")
        elif val < floor:
            problems.append(
                f"{key}: {val:g} fell below committed floor {floor:g}")
    return problems


def _print_bench_diff(report: dict[str, Any]) -> None:
    rows = report["rows"]
    if not rows:
        print(f"no numeric differences across {report['n_compared']} leaves")
        return
    print(f"{'key':<48}{'old':>14}{'new':>14}{'rel':>10}  flag")
    for r in rows:
        rel = r["rel_change"]
        rs = f"{rel:+.1%}" if isinstance(rel, float) else "—"
        old = f"{r['old']:.6g}" if r["old"] is not None else "—"
        new = f"{r['new']:.6g}" if r["new"] is not None else "—"
        print(f"{r['key']:<48}{old:>14}{new:>14}{rs:>10}  {r['flag']}")
    print(f"\n{report['n_flagged']} leaves flagged over "
          f"threshold {report['threshold']:.0%} "
          f"({report['n_compared']} compared)")


def _bench_pairs(old: Path, new: Path) -> list[tuple[str, Path, Path]]:
    """Pair artifacts: files directly, or BENCH_*.json by name in dirs."""
    if old.is_file() and new.is_file():
        return [(old.name, old, new)]
    pairs: list[tuple[str, Path, Path]] = []
    for op in sorted(old.glob("BENCH_*.json")):
        np_ = new / op.name
        if np_.exists():
            pairs.append((op.name, op, np_))
    return pairs


# -- entry point --------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize, validate, and diff fabric traces and "
                    "bench artifacts.")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="per-phase wall breakdown")
    s.add_argument("trace", help="JSONL trace file")
    s.add_argument("--top-k", type=int, default=5)
    s.add_argument("--json", action="store_true")

    v = sub.add_parser("validate", help="schema-check every record")
    v.add_argument("trace", help="JSONL trace file")

    d = sub.add_parser("diff", help="per-phase regression report")
    d.add_argument("old", help="baseline JSONL trace")
    d.add_argument("new", help="candidate JSONL trace")
    d.add_argument("--json", action="store_true")
    d.add_argument("--fail-over", type=float, default=None, metavar="RATIO",
                   help="exit 1 when any phase mean regresses past RATIO")

    b = sub.add_parser("diff-bench", help="compare BENCH_*.json artifacts")
    b.add_argument("old", help="baseline artifact file or directory")
    b.add_argument("new", help="candidate artifact file or directory")
    b.add_argument("--threshold", type=float, default=0.10)
    b.add_argument("--json", action="store_true")
    b.add_argument("--floors", default=None, metavar="FILE",
                   help="JSON {artifact name: {leaf path: minimum}}; "
                        "exit 1 if any candidate leaf misses its floor")
    b.add_argument("--fail-on-flag", action="store_true",
                   help="exit 1 when any leaf is flagged")

    e = sub.add_parser("export-chrome", help="emit a Perfetto-loadable JSON")
    e.add_argument("trace", help="JSONL trace file")
    e.add_argument("-o", "--out", required=True)
    return p


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.cmd == "summarize":
        summ = summarize(load_trace(args.trace), top_k=args.top_k)
        if args.json:
            print(json.dumps(summ, indent=2, sort_keys=True))
        else:
            _print_summary(summ)
        return 0

    if args.cmd == "validate":
        problems = validate_records(load_trace(args.trace))
        for msg in problems:
            print(msg)
        print(f"{'INVALID' if problems else 'OK'}: {args.trace} "
              f"({len(problems)} problems)")
        return 1 if problems else 0

    if args.cmd == "diff":
        rows = diff_phases(phase_stats(load_trace(args.old)),
                           phase_stats(load_trace(args.new)))
        if args.json:
            print(json.dumps({"phases": rows}, indent=2, sort_keys=True))
        else:
            _print_diff(rows)
        if args.fail_over is not None:
            bad = [r for r in rows if r["count_old"] and r["count_new"]
                   and r["mean_ratio"] > args.fail_over]
            if bad:
                print(f"\nFAIL: {len(bad)} phase(s) regressed past "
                      f"{args.fail_over:.2f}x", file=sys.stderr)
                return 1
        return 0

    if args.cmd == "diff-bench":
        old, new = Path(args.old), Path(args.new)
        pairs = _bench_pairs(old, new)
        if not pairs:
            print(f"no artifact pairs between {old} and {new}",
                  file=sys.stderr)
            return 2
        floors: dict[str, dict[str, float]] = {}
        if args.floors is not None:
            with open(args.floors, encoding="utf-8") as fh:
                # non-dict entries (e.g. a "_comment" string) are not floors
                floors = {k: v for k, v in json.load(fh).items()
                          if isinstance(v, dict)}
        any_flag = False
        violations: list[str] = []
        reports: dict[str, Any] = {}
        for name, op, np_ in pairs:
            report = diff_bench(load_bench(op), load_bench(np_),
                                threshold=args.threshold)
            if name in floors:
                report["floor_violations"] = check_floors(
                    load_bench(np_), floors.pop(name))
                violations += [f"{name}: {m}"
                               for m in report["floor_violations"]]
            reports[name] = report
            any_flag = any_flag or report["n_flagged"] > 0
            if not args.json:
                print(f"== {name} ==")
                _print_bench_diff(report)
                print()
        # a floors entry with no candidate artifact must not silently pass
        violations += [f"{name}: artifact has no baseline/candidate pair "
                       f"(floors: {sorted(fl)})"
                       for name, fl in sorted(floors.items())]
        if args.json:
            print(json.dumps(reports, indent=2, sort_keys=True))
        for msg in violations:
            print(f"FLOOR BREACH {msg}", file=sys.stderr)
        if violations:
            return 1
        return 1 if (args.fail_on_flag and any_flag) else 0

    if args.cmd == "export-chrome":
        doc = to_chrome_trace(load_trace(args.trace))
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        print(f"wrote {args.out} "
              f"({len(doc['traceEvents'])} events)")  # type: ignore[arg-type]
        return 0

    raise AssertionError(f"unhandled subcommand {args.cmd!r}")
