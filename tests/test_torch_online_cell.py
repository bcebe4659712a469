"""The online cell (``online_k3``: ``run_fast_online`` on the paper's
3-core fabric, releases in the trace's shape) on the CPU.

``run_fast_online`` is the benchmark's plain online reference
(``perfbench/reference/online.py``) bit for bit on the cell's fabric, on
both assignment paths that serve K=3; the harness runs the cell correct,
and its traced run reads every per-layer metric; releases dropped and a
core choice altered are judged incorrect; every request of every seed
carries one release vector; and each cell resolves to its metric lists.
Requests are cut to 4 coflows where the program is compared with the
reference, to 16 ports where the harness runs; the cores and rates are
the cell's own."""
import subprocess
import sys

import numpy as np
import pytest

from perfbench import check, control, harness
from perfbench.drivers import online as drv
from perfbench.gen import fb_trace
from perfbench.reference import online as ref_online
from perfbench.tests.conftest import ROOT, run_small, small
from perfbench.tests.test_perfbench_reference import _sorted_rows

BENCH = harness.load_benchmark()
SPEC = harness.resolve(BENCH, "online_k3")
CONFIG, TRAFFIC = SPEC["config"], SPEC["traffic"]
TRACE = fb_trace.synth_fb_trace(CONFIG["trace"]["coflows"],
                                CONFIG["trace"]["seed"])


@pytest.mark.parametrize("backend,precision", [("kernel", "float32"),
                                               ("numpy", "float64")])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3 * 2 ** 30 + 11])
def test_run_fast_online_is_the_reference_on_the_papers_fabric(
        backend, precision, seed):
    from repro_torch.core import online_instance_from_arrays, run_fast_online
    N, rates, delta = CONFIG["N"], CONFIG["rates"], CONFIG["delta"]
    pool = fb_trace.demand_pool(TRACE, N, seed)
    reqs = drv.requests(pool, TRACE, CONFIG, dict(TRAFFIC, block=4,
                                                  stride=3), seed)
    for _ in range(2):
        pick, w, rel = next(reqs)
        s = run_fast_online(online_instance_from_arrays(
            pool[pick], w, pick, rates, delta, rel, device="cpu"),
            backend=backend)
        want = ref_online.schedule(pool[pick], w, rel, rates, delta,
                                   precision)
        assert np.array_equal(s.pi.numpy(), want["order"])
        got = _sorted_rows(s.pos.numpy(), s.fi.numpy(), s.fj.numpy(), N,
                           s.size.numpy(), s.core.numpy(),
                           s.t_establish.numpy(), s.t_complete.numpy())
        ref = _sorted_rows(want["pos"], want["i"], want["j"], N,
                           want["size"], want["core"], want["t_est"],
                           want["t_comp"])
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
        assert np.array_equal(s.ccts.numpy(), want["ccts"])
        assert s.total_weighted_cct == want["wcct"]
        pi, pos = s.pi.numpy(), s.pos.numpy()
        early = check.referee(s.core.numpy(), s.fi.numpy(), s.fj.numpy(),
                              s.size.numpy(), s.t_establish.numpy(),
                              s.t_complete.numpy(), rates, delta, N,
                              rel=rel[pi[pos]])["early"]
        assert early == 0 and rel[-1] > 0


def test_the_harness_runs_the_cell_correct():
    res = run_small("online_k3", seconds=1.0)
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["metrics"]) == {"sched_flows_per_s", "setup_s"}
    assert {k for k, c in res["checks"].items() if c["value"] != 0} == set()
    assert "early" in res["checks"]


def test_a_traced_run_reads_every_per_layer_metric():
    from repro_torch import obs
    before = obs.current_tracer()
    res = run_small("online_k3", trace=1)
    assert obs.current_tracer() is before  # restored after the run
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {"online.event_loop_s", "online.to_host_s",
                        "online.unreleased_pct", "device_idle_pct.online"}
    assert 0 < got["online.unreleased_pct"] < 100
    assert got["online.event_loop_s"] > 0 and got["online.to_host_s"] > 0


def _zero_releases(monkeypatch):
    """Every coflow released at 0: the program schedules the request
    offline, while the reference keeps its releases."""
    import repro_torch.core as core
    build = core.online_instance_from_arrays

    def dropped(demand, weights, cids, rates, delta, releases, **kw):
        return build(demand, weights, cids, rates, delta,
                     np.zeros_like(releases), **kw)

    monkeypatch.setattr(core, "online_instance_from_arrays", dropped)


@pytest.mark.parametrize("kind", ["releases dropped", "altered", "lowprec"])
def test_a_break_is_judged_incorrect(kind, monkeypatch):
    """Releases dropped to 0 fail ``early`` or ``time_diff``; one core
    choice changed where the kernel call makes it fails ``choice_diff``;
    the assignment one precision below the configuration's (bfloat16 for
    the chain kernel's float32 state) fails too. The last two are
    ``control.py``'s offline breaks, which patch the assignment call that
    ``run_fast_online`` shares with ``run_fast``."""
    cfg, tr = small("online_k3")
    if kind == "releases dropped":
        _zero_releases(monkeypatch)
        res = run_small("online_k3", seconds=1.0, config=cfg, traffic=tr)
    else:
        with control.broken("offline", kind, cfg):
            res = run_small("online_k3", seconds=1.0, config=cfg,
                            traffic=tr)
    assert res["correct"] is False
    bad = {k for k, c in res["checks"].items() if c["value"] != 0}
    if kind == "releases dropped":
        assert bad & {"early", "time_diff"}
    else:
        assert "choice_diff" in bad


def test_every_request_of_every_seed_has_one_release_vector():
    """The release vector is the first block's arrivals rebased to its
    first: the trace's first 48 gaps at the traffic's rate, spanning about
    1,498 units. Later blocks' arrival times, rebased, equal it up to the
    rounding of the stream's running clock."""
    vectors = []
    for seed in (7, 2 ** 31 + 5):
        pool = fb_trace.demand_pool(TRACE, 16, seed)
        reqs = drv.requests(pool, TRACE, CONFIG, TRAFFIC, seed)
        vectors += [next(reqs)[2] for _ in range(30)]
        stream = fb_trace.arrival_stream(
            TRACE, fb_trace.nonempty(pool), fb_trace.flow_counts(pool), seed,
            TRAFFIC["rate"], tuple(CONFIG["weights"]), TRAFFIC["block"],
            TRAFFIC["stride"])
        for _ in range(30):
            t = np.array([next(stream)[1] for _ in range(TRAFFIC["block"])])
            np.testing.assert_allclose(t - t[0], vectors[0], rtol=0,
                                       atol=1e-8)
    assert all(np.array_equal(v, vectors[0]) for v in vectors)
    rel = vectors[0]
    assert rel.shape == (48,) and rel[0] == 0.0
    assert np.all(np.diff(rel) > 0) and 1_490 < rel[-1] < 1_505


def test_each_request_is_one_block_of_distinct_coflows():
    pool = fb_trace.demand_pool(TRACE, 16, 3)
    reqs = drv.requests(pool, TRACE, CONFIG, TRAFFIC, 3)
    for _ in range(12):
        pick, w, _ = next(reqs)
        assert np.unique(pick).size == pick.size == 48
        assert set(w.tolist()) <= set(range(1, 11))


END_TO_END = ["sched_flows_per_s", "setup_s"]
CELL_METRICS = {
    "offline_k16": ["offline.extract_s", "offline.assign_ms",
                    "offline.assign_roofline_pct", "offline.event_loop_s",
                    "offline.schedule_s", "device_idle_pct.offline"],
    "offline_k3": ["offline.extract_s", "offline.assign_ms",
                   "offline.assign_roofline_pct", "offline.event_loop_s",
                   "offline.schedule_s", "device_idle_pct.offline"],
    "online_k3": ["online.event_loop_s", "online.to_host_s",
                  "online.unreleased_pct", "device_idle_pct.online"],
}


@pytest.mark.parametrize("workload", list(CELL_METRICS))
def test_each_cell_resolves_to_its_metric_lists(workload):
    spec = harness.resolve(BENCH, workload)
    assert [m["name"] for m in spec["end_to_end"]] == END_TO_END
    assert [m["name"] for m in spec["per_layer"]] == CELL_METRICS[workload]
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_the_online_cell_is_the_papers_fabric_with_arrivals():
    cell = SPEC["cell"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "fb150_k3_online", "online_m48", 1)
    offline = harness.resolve(BENCH, "offline_k3")["config"]
    for key in ("N", "rates", "delta", "weights", "trace", "reduced"):
        assert CONFIG[key] == offline[key], key
    assert (TRAFFIC["driver"], TRAFFIC["block"], TRAFFIC["stride"],
            TRAFFIC["rate"]) == ("online", 48, 7, 0.03125)
    assert (TRAFFIC["backend"], TRAFFIC["precision"]) == ("kernel",
                                                          "float32")
    assert set(TRAFFIC["limits"]) >= {"early", "choice_diff", "time_diff"}
    assert set(TRAFFIC["limits"].values()) == {0}


def test_the_online_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import perfbench.reference.online; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'repro_torch', 'repro', 'jax')))").format(
                root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
