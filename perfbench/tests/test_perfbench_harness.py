"""The harness finds every item by name, generates the same traffic from
the same seed, prints the contract's line, and loads nothing of JAX."""
import json
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness
from perfbench.gen import fb_trace
from perfbench.tests.conftest import ROOT, run_small, with_pending

BENCH = harness.load_benchmark()
ALL = with_pending()
#: The cells of ``BENCHMARK.json`` and those kept out of it for now.
CELLS = [w["name"] for w in ALL["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    spec = harness.resolve(ALL, workload)
    cell = spec["cell"]
    entry = {c["name"]: c for c in ALL["configs"]}[cell["config"]]
    assert (ROOT / entry["file"]).is_file()
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert spec["config"]["name"] == cell["config"]
    assert (ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json"
            ).is_file()
    assert harness.driver(spec["traffic"]["driver"]).run
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "pending"])
def test_every_metric_and_config_is_used(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 3 * 2 ** 31])
def test_generator_is_deterministic_per_seed(seed):
    trace = fb_trace.synth_fb_trace(526, 2026)
    a = fb_trace.demand_pool(trace, 16, seed)
    b = fb_trace.demand_pool(trace, 16, seed)
    assert np.array_equal(a, b)
    ids, fl = fb_trace.nonempty(a), fb_trace.flow_counts(a)
    d1 = fb_trace.RequestDeck(ids, fl, 8, seed, (1, 10))
    d2 = fb_trace.RequestDeck(ids, fl, 8, seed, (1, 10))
    for _ in range(5):
        (p1, w1), (p2, w2) = d1.next(), d2.next()
        assert np.array_equal(p1, p2) and np.array_equal(w1, w2)
        assert np.unique(p1).size == p1.size
    s1 = fb_trace.arrival_stream(trace, ids, fl, seed, 0.01726, (1, 10), 8,
                                 3)
    s2 = fb_trace.arrival_stream(trace, ids, fl, seed, 0.01726, (1, 10), 8,
                                 3)
    first = [next(s1) for _ in range(50)]
    assert first == [next(s2) for _ in range(50)]
    rel = [r for _, r, _ in first]
    assert rel == sorted(rel) and rel[0] > 0
    other = fb_trace.demand_pool(trace, 16, seed + 1)
    assert not np.array_equal(a, other)


def test_generator_is_the_programs_sampler():
    """The frozen copy draws what the program's trace sampler draws."""
    from repro_torch.core import sample_instance, synth_fb_trace
    mine = fb_trace.synth_fb_trace(526, 2026)
    theirs = synth_fb_trace(526, 2026)
    assert [(t["arrival_ms"], t["mappers"], t["reducers"], t["reducer_mb"])
            for t in mine] == [(t.arrival_ms, list(t.mappers),
                                list(t.reducers), list(t.reducer_mb))
                               for t in theirs]
    for n, seed in ((150, 11), (16, 2 ** 31 + 9)):
        pool = fb_trace.demand_pool(mine, n, seed)
        inst, pick = sample_instance(theirs, N=n, M=12, rates=[10, 20, 30],
                                     delta=8, seed=seed, return_pick=True,
                                     device="cpu")
        assert np.array_equal(inst.demand.numpy(), pool[pick])


def test_blocks_deal_every_coflow_once_a_pass():
    trace = fb_trace.synth_fb_trace(526, 2026)
    pool = fb_trace.demand_pool(trace, 150, 3)
    ids, fl = fb_trace.nonempty(pool), fb_trace.flow_counts(pool)
    blocks = fb_trace.Blocks(ids, fl, 48, np.random.default_rng(1))
    dealt = [blocks.next() for _ in range(blocks.per_pass)]
    assert all(np.unique(b).size == 48 for b in dealt)
    assert set(np.concatenate(dealt).tolist()) == set(ids.tolist())


@pytest.mark.parametrize("workload,trace", [(w, t) for w in CELLS
                                            for t in (0, 1)])
def test_result_line_has_the_contracts_keys(workload, trace):
    res = run_small(workload, trace=trace)
    keys = {"correct", "attempted", "failed", "metrics", "device",
            "setup_built", "checks"}
    if trace:
        keys.add("breakdown")
    assert set(res) == keys
    assert list(res)[-1] == "checks"
    assert res["setup_built"] is False  # nothing is built on the CPU
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    spec = harness.resolve(ALL, workload)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        dev |= {"busy_s", "window_s"}
        assert len(res["breakdown"]["device_ops"]) <= 10
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    assert set(res["device"]) == dev
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


_IMPORTS = """
import sys, json
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from perfbench.tests.conftest import run_small
from perfbench import harness
res = run_small({workload!r})
print(json.dumps({{"correct": res["correct"],
                   "bad": harness.forbidden_loaded()}}))
"""


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_no_jax(workload):
    """Nothing a run imports, for either cell, has the top-level name jax,
    jaxlib, flax or repro (``repro_torch`` is another name)."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=str(ROOT),
                                               workload=workload)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": []}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_loaded({"repro_torch": 1, "repro_torch.core": 1,
                                     "jaxtyping": 1, "numpy": 1}) == []
    assert harness.forbidden_loaded({"repro": 1, "jax.numpy": 1,
                                     "jaxlib": 1, "flax.linen": 1}) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro"]


def test_a_file_built_during_set_up_is_seen(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "BUILD_DIRS", (tmp_path,))
    (tmp_path / "__pycache__").mkdir()
    (tmp_path / "__pycache__" / "m.cpython-312.pyc").write_bytes(b"")
    before = harness.built_files()
    assert before == set()
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / "kernel.so").write_bytes(b"")
    assert harness.built_files() - before == {
        str(tmp_path / "build" / "kernel.so")}


def test_the_window_keeps_the_collector_off():
    import gc

    import torch
    win = harness.Window(torch, torch.device("cpu"), trace=False)
    with win():
        inside = gc.isenabled()
    assert inside is False and gc.isenabled()
    assert win.seconds >= 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import perfbench.reference.offline, perfbench.reference.stream; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'repro_torch', 'repro', 'jax')))").format(
                root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_chip_means_no_result(tmp_path):
    """Without the card a run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(workload, cuda_device):
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         workload, "--seed", "12345", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
