"""``python -m repro_torch.obs`` vs ``python -m repro.obs``, on the CPU.

Every subcommand of the port's CLI gives the reference CLI's stdout, stderr
and exit code on the same inputs: a trace recorded by the port's fabric
manager, a corrupt trace, a regressed copy of a trace, and the committed
``benchmarks/baselines/BENCH_*.json`` artifacts with
``--floors benchmarks/baselines/FLOORS.json`` (read only; perturbed copies
go to a temporary directory). Also: every public name of ``repro.core``,
``repro.obs``, ``repro.obs.cli``, ``repro.comm``, ``repro.launch`` (mesh,
train), ``repro.analysis.hlo`` and ``repro.distributed`` (checkpoint,
compression, fault, sharding) has a port counterpart.
"""
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

import repro.analysis.hlo
import repro.comm
import repro.core
import repro.distributed.checkpoint
import repro.distributed.compression
import repro.distributed.fault
import repro.distributed.sharding
import repro.launch.mesh
import repro.launch.train
import repro.obs
import repro.obs.cli as ref_cli
import repro_torch.analysis.collectives
import repro_torch.comm
import repro_torch.core
import repro_torch.distributed.checkpoint
import repro_torch.distributed.compression
import repro_torch.distributed.fault
import repro_torch.distributed.sharding
import repro_torch.launch.mesh
import repro_torch.launch.train
import repro_torch.obs
import repro_torch.obs.cli as port_cli
from repro_torch.obs import Tracer
from test_torch_fabric import ref_stream
from test_torch_obs import _drive, _port_manager

REPO = Path(__file__).resolve().parents[1]
BASELINES = REPO / "benchmarks" / "baselines"


def run_both(capsys, argv):
    """``(exit code, stdout, stderr)`` of the reference CLI, then the
    port's."""
    out = []
    for cli in (ref_cli, port_cli):
        rc = cli.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def assert_same_run(capsys, argv, rc=None):
    want, got = run_both(capsys, argv)
    assert got == want, argv
    if rc is not None:
        assert got[0] == rc, argv
    return got


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A JSONL trace of the port's fabric manager over a small stream."""
    sink = tmp_path_factory.mktemp("trace") / "trace.jsonl"
    tr = Tracer(sink)
    _drive(_port_manager(tr), ref_stream(seed=2), n_ticks=4)
    tr.close()
    return sink


@pytest.mark.parametrize("argv", [
    ["summarize", "{t}"],
    ["summarize", "{t}", "--json"],
    ["summarize", "{t}", "--top-k", "2"],
    ["validate", "{t}"],
])
def test_summarize_and_validate_match(capsys, port_trace, argv):
    assert_same_run(capsys, [a.format(t=port_trace) for a in argv], rc=0)


def test_validate_flags_a_bad_trace_alike(capsys, tmp_path):
    bad = tmp_path / "bad.jsonl"
    recs = [{"kind": "span", "name": "tick", "sid": 0, "parent": 7,
             "depth": 1, "ts": 0.0, "dur": -1.0, "attrs": {}},
            {"kind": "blip", "name": "x"},
            {"kind": "event", "name": "", "sid": 0, "parent": None,
             "depth": 0, "ts": "t", "attrs": []}]
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs),
                   encoding="utf-8")
    _, out, _ = assert_same_run(capsys, ["validate", str(bad)], rc=1)
    assert "INVALID" in out and "parent sid 7" in out


def test_diff_matches(capsys, port_trace, tmp_path):
    slow = tmp_path / "slow.jsonl"
    with open(slow, "w", encoding="utf-8") as fh:
        for r in port_cli.load_trace(port_trace):
            if r["kind"] == "span":
                r = dict(r, dur=float(r["dur"]) * 10 + 1.0)
            fh.write(json.dumps(r) + "\n")
    t, s = str(port_trace), str(slow)
    assert_same_run(capsys, ["diff", t, s], rc=0)
    assert_same_run(capsys, ["diff", t, s, "--json"], rc=0)
    assert_same_run(capsys, ["diff", t, s, "--fail-over", "2.0"], rc=1)
    assert_same_run(capsys, ["diff", t, t, "--fail-over", "2.0"], rc=0)


def test_export_chrome_matches(capsys, port_trace, tmp_path):
    out = tmp_path / "chrome.json"
    docs = []
    for cli in (ref_cli, port_cli):
        assert cli.main(["export-chrome", str(port_trace), "-o",
                         str(out)]) == 0
        docs.append((capsys.readouterr().out, out.read_text("utf-8")))
    assert docs[0] == docs[1]
    assert json.loads(docs[1][1])["traceEvents"]


@pytest.fixture()
def perturbed(tmp_path):
    """A copy of the committed baselines with one counter leaf below its
    floor and one numeric leaf changed by half."""
    new = tmp_path / "new"
    shutil.copytree(BASELINES, new)
    doc = json.loads((new / "BENCH_overload.json").read_text("utf-8"))
    doc["data"]["rows"][2]["loc_reuse_mean"] *= 0.5
    (new / "BENCH_overload.json").write_text(json.dumps(doc), "utf-8")
    return new


@pytest.mark.parametrize("extra", [[], ["--json"], ["--threshold", "0.5"],
                                   ["--fail-on-flag"]])
def test_diff_bench_on_the_committed_baselines_matches(capsys, perturbed,
                                                       extra):
    floors = str(BASELINES / "FLOORS.json")
    base = str(BASELINES)
    assert_same_run(capsys, ["diff-bench", base, base, "--floors", floors]
                    + extra, rc=0)
    _, _, err = assert_same_run(
        capsys, ["diff-bench", base, str(perturbed), "--floors", floors]
        + extra, rc=1)
    assert "FLOOR BREACH" in err
    assert_same_run(capsys, ["diff-bench", str(BASELINES / "BENCH_fault.json"),
                             str(perturbed / "BENCH_fault.json")] + extra)


def test_diff_bench_exit_codes_match(capsys, tmp_path, perturbed):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert_same_run(capsys, ["diff-bench", str(empty), str(perturbed)], rc=2)
    orphan = tmp_path / "orphan.json"
    orphan.write_text(json.dumps({"BENCH_missing.json": {"data.x": 1.0}}))
    assert_same_run(capsys, ["diff-bench", str(BASELINES), str(perturbed),
                             "--floors", str(orphan)], rc=1)


def test_library_functions_match(port_trace, perturbed):
    records = port_cli.load_trace(port_trace)
    assert records == ref_cli.load_trace(port_trace)
    assert port_cli.validate_records(records) == \
        ref_cli.validate_records(records) == []
    stats = port_cli.phase_stats(records)
    assert stats == ref_cli.phase_stats(records)
    assert port_cli.summarize(records, 3) == ref_cli.summarize(records, 3)
    assert port_cli.diff_phases(stats, {}) == ref_cli.diff_phases(stats, {})
    old = port_cli.load_bench(BASELINES / "BENCH_overload.json")
    new = port_cli.load_bench(perturbed / "BENCH_overload.json")
    assert port_cli.diff_bench(old, new) == ref_cli.diff_bench(old, new)
    floors = {"data.rows[2].loc_reuse_mean": 0.1, "data.none": 1.0}
    assert port_cli.check_floors(new, floors) == \
        ref_cli.check_floors(new, floors)


def test_module_entry_point(port_trace):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get(
        "PATH", "/usr/bin:/bin")}
    procs = [subprocess.run(
        [sys.executable, "-m", mod, "summarize", str(port_trace)],
        capture_output=True, text=True, cwd=REPO, env=env)
        for mod in ("repro.obs", "repro_torch.obs")]
    assert procs[1].returncode == 0, procs[1].stderr
    assert procs[1].stdout == procs[0].stdout
    assert "tick/event_loop" in procs[1].stdout


# ---------------------------------------------------------------------------
# the surface: every public name of the reference has a port counterpart
# ---------------------------------------------------------------------------

def _public(mod):
    if hasattr(mod, "__all__"):
        return sorted(mod.__all__)
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


#: Reference names whose port counterpart is named otherwise: torch has no
#: HLO text to read, so the port traces the step itself
#: (``repro.analysis.hlo.analyze_hlo`` -> ``analysis.collectives.analyze_step``).
RENAMED = {"analyze_hlo": "analyze_step"}


@pytest.mark.parametrize("ref_mod, port_mod", [
    (repro.core, repro_torch.core),
    (repro.obs, repro_torch.obs),
    (ref_cli, port_cli),
    (repro.comm, repro_torch.comm),
    (repro.distributed.sharding, repro_torch.distributed.sharding),
    (repro.launch.mesh, repro_torch.launch.mesh),
    (repro.analysis.hlo, repro_torch.analysis.collectives),
    (repro.distributed.checkpoint, repro_torch.distributed.checkpoint),
    (repro.distributed.compression, repro_torch.distributed.compression),
    (repro.distributed.fault, repro_torch.distributed.fault),
    (repro.launch.train, repro_torch.launch.train),
], ids=["core", "obs", "obs.cli", "comm", "distributed.sharding",
        "launch.mesh", "analysis.hlo", "distributed.checkpoint",
        "distributed.compression", "distributed.fault", "launch.train"])
def test_every_reference_name_has_a_port_counterpart(ref_mod, port_mod):
    missing = [n for n in _public(ref_mod)
               if not hasattr(port_mod, RENAMED.get(n, n))]
    assert missing == []
    if ref_mod is ref_cli:
        assert callable(port_mod.summarize)
