"""The paper's own fabric (``fb150_k3_offline``: 150 ports, the imbalanced
3-core rates, delta 8) is served by ``run_fast`` exactly as the plain
reference schedules it, on both assignment paths that serve K=3: the chain
kernel's fp32 state (here its plain version), which ``offline_k3`` runs,
and the default fp64 host backend, which no cell runs yet. Requests are cut
to 4 coflows; the ports, cores and rates are the cell's own."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.gen import fb_trace
from perfbench.reference import offline
from perfbench.tests.conftest import ROOT, with_pending
from perfbench.tests.test_perfbench_reference import _sorted_rows

BENCH = harness.load_benchmark()
CONFIG = harness.resolve(BENCH, "offline_k3")["config"]
TRACE = fb_trace.synth_fb_trace(CONFIG["trace"]["coflows"],
                                CONFIG["trace"]["seed"])


@pytest.mark.parametrize("backend,precision", [("kernel", "float32"),
                                               ("numpy", "float64")])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3 * 2 ** 30 + 11])
def test_run_fast_is_the_reference_on_the_papers_fabric(backend, precision,
                                                         seed):
    from repro_torch.core import instance_from_arrays, run_fast
    N, rates, delta = CONFIG["N"], CONFIG["rates"], CONFIG["delta"]
    pool = fb_trace.demand_pool(TRACE, N, seed)
    deck = fb_trace.RequestDeck(fb_trace.nonempty(pool),
                                fb_trace.flow_counts(pool), 4, seed,
                                tuple(CONFIG["weights"]))
    for _ in range(2):
        pick, w = deck.next()
        inst = instance_from_arrays(pool[pick], w, pick, rates, delta,
                                    device="cpu")
        s = run_fast(inst, backend=backend)
        want = offline.schedule(pool[pick], w, rates, delta, precision)
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


def test_the_offline_fabric_is_the_streams_fabric():
    """The offline configuration has the pending stream cell's fabric,
    trace and weights, in a file of its own."""
    stream = harness.resolve(with_pending(), "stream_k3")["config"]
    for key in ("N", "rates", "delta", "weights", "trace", "reduced"):
        assert CONFIG[key] == stream[key], key
    files = {c["name"]: c["file"] for c in BENCH["configs"]}
    assert files["fb150_k3_offline"] != "perfbench/configs/fb150_k3.json"
    assert (ROOT / files["fb150_k3_offline"]).is_file()


K16_END_TO_END = ["sched_flows_per_s", "setup_s"]
K16_PER_LAYER = ["offline.extract_s", "offline.assign_ms",
                 "offline.assign_roofline_pct", "offline.event_loop_s",
                 "offline.schedule_s", "device_idle_pct.offline"]


@pytest.mark.parametrize("workload", ["offline_k16", "offline_k3"])
def test_each_offline_cell_reads_its_metrics(workload):
    """``offline_k16`` resolves to exactly the lists it had before the
    paper's fabric was added, and ``offline_k3`` to the same lists."""
    spec = harness.resolve(BENCH, workload)
    assert spec["cell"]["traffic"] == "plan_m48"
    assert [m["name"] for m in spec["end_to_end"]] == K16_END_TO_END
    assert [m["name"] for m in spec["per_layer"]] == K16_PER_LAYER
    tr = spec["traffic"]
    assert set(tr["limits"].values()) == {0}
    assert (tr["backend"], tr["precision"]) == ("kernel", "float32")


@pytest.mark.parametrize("workload,kernel", [("offline_k16", "lanes_sm90"),
                                             ("offline_k3", "chain_sm90")])
def test_each_offline_cell_runs_its_assignment_kernel(workload, kernel):
    """The paper's 3 cores go to the chain kernel, 16 to the lanes kernel:
    each kernel has a cell."""
    from repro_torch.kernels.coflow_assign import kernel_for
    cfg = harness.resolve(BENCH, workload)["config"]
    assert kernel_for(len(cfg["rates"])) == kernel
