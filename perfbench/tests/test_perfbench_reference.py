"""The plain reference gives the program's answers, bit for bit, on the
CPU at a small size: offline (``run_fast`` with the kernel's plain version,
and with the fp64 backend) and a short stream through the fabric
manager."""
import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.gen import fb_trace
from perfbench.reference import common, offline, stream

TRACE = fb_trace.synth_fb_trace(526, 2026)


def _sorted_rows(pos, i, j, N, *cols):
    key = (pos * N + i) * N + j
    o = np.argsort(key)
    return (key[o],) + tuple(c[o] for c in cols)


@pytest.mark.parametrize("K,backend,precision", [
    (3, "kernel", "float32"), (16, "kernel", "float32"),
    (5, "numpy", "float64"), (16, "numpy", "float64")])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 77])
def test_offline_reference_is_run_fast(K, backend, precision, seed):
    from repro_torch.core import instance_from_arrays, run_fast
    N, M = 16, 8
    pool = fb_trace.demand_pool(TRACE, N, seed)
    deck = fb_trace.RequestDeck(fb_trace.nonempty(pool),
                                fb_trace.flow_counts(pool), M, seed, (1, 10))
    rates = ([10.0, 20.0, 30.0] * 6)[:K]
    for _ in range(2):
        pick, w = deck.next()
        inst = instance_from_arrays(pool[pick], w, pick, rates, 8.0,
                                    device="cpu")
        s = run_fast(inst, backend=backend)
        want = offline.schedule(pool[pick], w, rates, 8.0, precision)
        assert np.array_equal(s.pi.numpy(), want["order"])
        got = _sorted_rows(s.pos.numpy(), s.fi.numpy(), s.fj.numpy(), N,
                           s.core.numpy(), s.t_establish.numpy(),
                           s.t_complete.numpy())
        ref = _sorted_rows(want["pos"], want["i"], want["j"], N,
                           want["core"], want["t_est"], want["t_comp"])
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)
        assert np.array_equal(s.ccts.numpy(), want["ccts"])
        assert s.total_weighted_cct == want["wcct"]


def test_stream_reference_is_the_fabric_manager():
    from repro_torch.core import Coflow
    from repro_torch.service import FabricConfig, FabricManager
    N, rates, delta = 16, (10.0, 20.0, 30.0), 8.0
    pool = fb_trace.demand_pool(TRACE, N, 4)
    ids, fl = fb_trace.nonempty(pool), fb_trace.flow_counts(pool)
    arr = fb_trace.arrival_stream(TRACE, ids, fl, 4, 0.2, (1, 10), 16, 5)
    mgr = FabricManager(FabricConfig(N=N, rates=rates, delta=delta),
                        device="cpu")
    subs, nxt = [], next(arr)
    for k in range(1, 60):
        t = 64.0 * k
        while nxt[1] <= t:
            c, r, w = nxt
            mgr.submit(Coflow(cid=len(subs), demand=torch.from_numpy(
                pool[c].copy()), weight=w), r)
            subs.append(nxt)
            nxt = next(arr)
        mgr.tick(t)
    prog = mgr.program()
    ans = {"g": prog.cid, "i": prog.ingress, "j": prog.egress,
           "core": prog.core, "size": prog.size, "t_est": prog.t_establish,
           "t_comp": prog.t_complete, "ccts": mgr.ccts()}
    ans = {k: v.numpy() for k, v in ans.items()}
    cs = np.array([s[0] for s in subs])
    want = stream.replay(pool[cs], np.array([s[2] for s in subs]),
                         np.array([s[1] for s in subs]), rates, delta,
                         64.0 * 59)
    nums = check.stream(ans, want, rates, delta, N)
    assert all(v == 0 for v in nums.values()), nums
    assert (~np.isnan(want["t_est"])).sum() == ans["g"].size > 100
    assert np.isnan(want["t_est"]).any()  # a backlog was left pending


def test_list_schedule_is_a_sequential_scan():
    """The event-driven scheduler equals a plain rescan of every pending
    flow at every event."""
    rng = np.random.default_rng(5)
    F, N, K, delta = 300, 6, 2, 3.0
    core = rng.integers(0, K, F)
    fi, fj = rng.integers(0, N, F), rng.integers(0, N, F)
    srv = rng.uniform(0.5, 4.0, F).round(1)
    rel = rng.uniform(0, 40, F).round(0)
    for release in (None, rel):
        got = common.list_schedule(core, fi, fj, srv, delta, N, K,
                                   release=release)
        free, t_est, t = {}, np.full(F, np.nan), 0.0
        times = set() if release is None else set(rel.tolist())
        while np.isnan(t_est).any():
            for f in range(F):
                if not np.isnan(t_est[f]) or (release is not None
                                              and rel[f] > t):
                    continue
                a, b = ("i", core[f], fi[f]), ("o", core[f], fj[f])
                if free.get(a, 0.0) <= t and free.get(b, 0.0) <= t:
                    t_est[f] = t
                    free[a] = free[b] = (t + delta) + srv[f]
                    times.add(free[a])
            t = min(x for x in times if x > t)
        assert np.array_equal(got, t_est)


def test_referee_sees_overlaps_and_early_circuits():
    core = np.array([0, 0, 1])
    i, j = np.array([0, 0, 0]), np.array([1, 2, 1])
    size = np.array([10.0, 10.0, 10.0])
    rates = np.array([10.0, 10.0])
    t_est = np.array([0.0, 2.0, 0.0])  # flow 1 takes port 0 before 3.0
    t_comp = (t_est + 2.0) + size / rates[core]
    out = check.referee(core, i, j, size, t_est, t_comp, rates, 2.0, 3,
                        rel=np.array([0.0, 0.0, 1.0]))
    assert out == {"unfinished": 0, "infeasible": 1, "early": 1}
