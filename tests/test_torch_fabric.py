"""The port's streaming engine (``repro_torch.core.fabric``) vs the
reference's (``repro.core.engine``), on the CPU.

The same stream (the coflows of a reference ``OnlineInstance``, the same
tick times and batches) goes through the reference's ``FabricState`` and the
port's, and every ``TickCommit`` must be equal bit for bit: flow rows, core
choices, establishment and completion times, finalizations, pending counts
and component telemetry. The grids are those of ``tests/test_service.py``,
``tests/test_delta_scheduling.py`` and ``tests/test_component_index.py``,
with fixed seeds. Also: the port's own gates (``cross_check_incremental``,
delta-scheduled == full replay), the incremental component index after
every add and remove, the committed-horizon arguments of the loops, the
error messages, the ``Coflow`` record and ``arrival_stream``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.engine as ref_engine
import repro.core.fault as ref_fault
import repro_torch.core as port
import repro_torch.core.engine as port_engine
import repro_torch.core.fabric as port_fabric
import repro_torch.core.fault as port_fault
from test_torch_online import to_port_online

TRACE = ref.synth_fb_trace(200, seed=2026)
RATES = (10.0, 20.0, 30.0)
ALGS = ("ours", "rho-assign", "rand-assign")
SCHEDS = ("work-conserving", "priority-guard", "reserving")
COMMIT_ARRAYS = ("gid", "cid", "fi", "fj", "core", "size", "t_establish",
                 "t_complete")


# ---------------------------------------------------------------------------
# helpers shared by the streaming-plane test files
# ---------------------------------------------------------------------------

def ref_stream(N=10, M=16, seed=0, span=300.0, delta=8.0):
    """The streams of tests/test_delta_scheduling.py and friends."""
    return ref.sample_online_instance(TRACE, N=N, M=M, rates=RATES,
                                      delta=delta, span=span, seed=seed)


def to_port_coflow(c: "ref.Coflow") -> "port.Coflow":
    return port.Coflow(cid=c.cid, demand=torch.from_numpy(c.demand.copy()),
                       weight=c.weight)


def to_port_event(ev):
    """A reference fault event as the port's (same class name, fields)."""
    return getattr(port_fault, type(ev).__name__)(**dataclasses.asdict(ev))


def assert_same_fault_app(got, want):
    assert type(got.event).__name__ == type(want.event).__name__
    assert dataclasses.asdict(got.event) == dataclasses.asdict(want.event)
    assert [dataclasses.astuple(a) for a in got.aborted] == \
        [dataclasses.astuple(a) for a in want.aborted]
    assert (got.requeued, got.reassigned_pending, got.unfinalized) == \
        (want.requeued, want.reassigned_pending, want.unfinalized)


def assert_same_commit(got, want, msg=""):
    """Every field of a port TickCommit equals the reference's."""
    assert got.t_now == want.t_now, msg
    for name in COMMIT_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name),
                                      err_msg=f"{msg}: {name}")
    if want.delta_f is None:
        assert got.delta_f is None, msg
    else:
        np.testing.assert_array_equal(got.delta_f.cpu().numpy(),
                                      want.delta_f, err_msg=f"{msg}: delta_f")
    assert got.finalized == want.finalized, msg
    assert got.n_pending == want.n_pending, msg
    assert got.unfinalized == want.unfinalized, msg
    assert (got.components_total, got.components_touched) == \
        (want.components_total, want.components_touched), msg
    assert len(got.faults) == len(want.faults), msg
    for a, b in zip(got.faults, want.faults):
        assert_same_fault_app(a, b)


def assert_same_state(pst, rst):
    """The counters and registries a service reads off a FabricState."""
    np.testing.assert_array_equal(pst.ccts().cpu().numpy(), rst.ccts())
    np.testing.assert_array_equal(pst.weights().cpu().numpy(), rst.weights())
    for name in ("n_coflows", "n_pending_flows", "tent_reused",
                 "tent_recomputed", "tent_invalidated", "components_total",
                 "components_touched", "component_size_hist",
                 "component_reused_hist", "commits_gced",
                 "n_commits_retained", "delta_drifted"):
        assert getattr(pst, name) == getattr(rst, name), name
    np.testing.assert_array_equal(pst.core_up, rst.core_up)
    np.testing.assert_array_equal(pst.delta_k, rst.delta_k)
    assert pst.aborted_keys() == rst.aborted_keys()


def tick_batches(oinst, ticks):
    """Coflow ids each tick admits (releases in ``(previous, T]``)."""
    rel = oinst.releases
    out, prev = [], -np.inf
    for T in ticks:
        out.append(np.nonzero((rel > prev) & (rel <= T))[0])
        prev = T
    return out


def twin_drive(oinst, ticks, *, events=None, injector=(), **kw):
    """Drive the reference's and the port's FabricState through the same
    ticks, asserting every commit equal. ``events`` maps a tick index to a
    fault event applied with ``apply_fault`` before that tick; ``injector``
    events ride a ``FaultInjector`` (``None``: no injector at all). Returns
    ``(port state, reference state, port commits)``."""
    events = events or {}
    r_inj = (None if injector is None
             else ref_fault.FaultInjector(list(injector)))
    p_inj = (None if injector is None else port_fault.FaultInjector(
        [to_port_event(e) for e in injector]))
    inst = oinst.inst
    rst = ref_engine.FabricState(rates=inst.rates, delta=inst.delta,
                                 N=inst.N, faults=r_inj, **kw)
    pst = port_fabric.FabricState(rates=inst.rates, delta=inst.delta,
                                  N=inst.N, faults=p_inj, device="cpu", **kw)
    pcofs = [to_port_coflow(c) for c in inst.coflows]
    commits = []
    for x, (T, ids) in enumerate(zip(ticks, tick_batches(oinst, ticks))):
        if x in events:
            assert_same_fault_app(pst.apply_fault(to_port_event(events[x])),
                                  rst.apply_fault(events[x]))
        rel = oinst.releases[ids]
        want = rst.step([inst.coflows[int(m)] for m in ids], rel, float(T))
        got = pst.step([pcofs[int(m)] for m in ids], rel, float(T))
        assert_same_commit(got, want, f"tick {x} at t={T}")
        commits.append(got)
    got, want = pst.finalize(), rst.finalize()
    assert_same_commit(got, want, "finalize")
    commits.append(got)
    assert_same_state(pst, rst)
    return pst, rst, commits


def even_ticks(oinst, n_ticks):
    hi = float(oinst.releases.max())
    return list(np.linspace(hi / n_ticks, hi, n_ticks)) if hi > 0 else [0.0]


# ---------------------------------------------------------------------------
# the loops' committed-horizon arguments
# ---------------------------------------------------------------------------

def _loop_inputs(seed, F=300, K=3, N=8):
    rng = np.random.default_rng(seed)
    core = rng.integers(0, K, F)
    rin = core * N + rng.integers(0, N, F)
    rout = core * N + rng.integers(0, N, F)
    srv = rng.exponential(5.0, F)
    rel = np.sort(rng.uniform(10.0, 60.0, F))[rng.permutation(F)]
    horizon_in = np.where(rng.random(K * N) < 0.5,
                          rng.uniform(0.0, 80.0, K * N), 0.0)
    horizon_out = np.where(rng.random(K * N) < 0.5,
                           rng.uniform(0.0, 80.0, K * N), 0.0)
    horizon_in[:N] = np.inf  # a failed core's resources
    horizon_out[:N] = np.inf
    keep = core != 0
    return (rin[keep], rout[keep], srv[keep], core[keep], rel[keep],
            horizon_in, horizon_out, K * N, N)


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_loop_with_horizons_matches_reference(seed, guard):
    rin, rout, srv, core, rel, fin, fout, n_res, N = _loop_inputs(seed)
    kw = dict(t0=10.0, guard=guard, release=rel)
    want = ref_engine._event_loop(rin, rout, srv, core, 8.0, n_res, N,
                                  free_in0=fin, free_out0=fout, **kw)
    got = port_engine._event_loop(rin, rout, srv, core, 8.0, n_res, N,
                                  free_in0=fin, free_out0=fout, **kw)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and (got >= kw["t0"]).all()
    # with no horizons the loop is the from-scratch one, bit for bit
    np.testing.assert_array_equal(
        port_engine._event_loop(rin, rout, srv, core, 8.0, n_res, N, **kw),
        ref_engine._event_loop(rin, rout, srv, core, 8.0, n_res, N, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reserving_with_horizons_mutates_like_reference(seed):
    rin, rout, srv, _core, rel, fin, fout, n_res, _N = _loop_inputs(seed)
    fin[np.isinf(fin)] = 0.0
    fout[np.isinf(fout)] = 0.0
    a_ref, b_ref = fin.copy(), fout.copy()
    a_port, b_port = fin.copy(), fout.copy()
    want = ref_engine._reserving_times(rin, rout, srv, 8.0, n_res,
                                       release=rel, avail_in=a_ref,
                                       avail_out=b_ref)
    got = port_engine._reserving_times(rin, rout, srv, 8.0, n_res,
                                       release=rel, avail_in=a_port,
                                       avail_out=b_port)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(a_port, a_ref)
    np.testing.assert_array_equal(b_port, b_ref)


# ---------------------------------------------------------------------------
# FabricState vs the reference (tests/test_service.py's gate grid)
# ---------------------------------------------------------------------------

def _service_stream(N=12, M=25, seed=0, span_factor=1.0):
    off = ref.sample_online_instance(TRACE, N=N, M=M, rates=RATES, delta=8.0,
                                     span=0.0, seed=seed)
    mk = float(ref.run_fast_online(off, "ours").ccts.max())
    return ref.sample_online_instance(TRACE, N=N, M=M, rates=RATES,
                                      delta=8.0, span=mk * span_factor,
                                      seed=seed)


def _both_cross_checks(oinst, *args, **kw):
    """The reference's and the port's gate on one stream; their per-tick
    commits must agree too."""
    want = ref_engine.cross_check_incremental(oinst, *args, **kw)
    got = port_fabric.cross_check_incremental(to_port_online(oinst), *args,
                                              **kw)
    assert len(got) == len(want)
    for x, (g, w) in enumerate(zip(got, want)):
        assert_same_commit(g, w, f"tick {x}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("algorithm", ALGS)
def test_incremental_bit_exact_random_streams(seed, algorithm):
    oinst = _service_stream(seed=seed, span_factor=[0.5, 1.0, 2.0][seed % 3])
    _both_cross_checks(oinst, algorithm, seed=seed, n_ticks=3 + seed * 2)


@pytest.mark.parametrize("scheduling", SCHEDS)
def test_incremental_bit_exact_all_schedulings(scheduling):
    _both_cross_checks(_service_stream(seed=5), "ours",
                       scheduling=scheduling, n_ticks=6)


def test_incremental_simultaneous_release_single_tick():
    _both_cross_checks(_service_stream(seed=1, span_factor=0.0), "ours",
                       tick_times=[0.0])


def test_incremental_one_tick_per_coflow():
    oinst = _service_stream(M=15, seed=2, span_factor=1.5)
    _both_cross_checks(oinst, "ours", tick_times=np.unique(oinst.releases))


def test_incremental_irregular_ticks():
    rng = np.random.default_rng(9)
    oinst = _service_stream(seed=3)
    ticks = np.sort(rng.uniform(0, float(oinst.releases.max()), 5))
    _both_cross_checks(oinst, "ours", tick_times=ticks)


# ---------------------------------------------------------------------------
# delta-scheduling (tests/test_delta_scheduling.py's grid)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta_schedule", [True, False])
@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_and_full_replay_match_reference(seed, alg, delta_schedule):
    oinst = ref_stream(M=14, seed=seed)
    twin_drive(oinst, even_ticks(oinst, 7), algorithm=alg, seed=seed,
               delta_schedule=delta_schedule)


@pytest.mark.parametrize("delta_schedule", [True, False])
@pytest.mark.parametrize("scheduling", SCHEDS)
def test_delta_and_full_replay_match_reference_schedulings(scheduling,
                                                            delta_schedule):
    oinst = ref_stream(M=12, seed=3)
    twin_drive(oinst, even_ticks(oinst, 6), scheduling=scheduling,
               delta_schedule=delta_schedule)


def test_delta_matches_reference_under_overload():
    """A backlog far larger than one tick's arrivals: most rows splice."""
    oinst = ref_stream(M=24, seed=5, span=40.0)
    pst, rst, _ = twin_drive(oinst, even_ticks(oinst, 12))
    assert pst.tent_reused > 0 and pst.tent_reused == rst.tent_reused


def test_empty_tick_reuses_everything():
    oinst = ref_stream(M=12, seed=2, span=10.0)
    hi = float(oinst.releases.max())
    pst, _rst, commits = twin_drive(oinst, [hi, hi + 1e-6, hi + 2e-6])
    assert commits[1].components_touched == 0


def test_delta_and_full_port_states_commit_identically():
    """The port's own twin: delta-scheduled == full replay, tick by tick."""
    oinst = to_port_online(ref_stream(M=20, seed=1, span=60.0))
    for alg in ALGS:
        port_fabric.cross_check_incremental(oinst, alg, seed=4, n_ticks=9,
                                            compare_delta=True)


def test_locality_stream_matches_reference():
    oinst = ref_stream(M=24, seed=4, span=400.0)
    twin_drive(oinst, even_ticks(oinst, 8), locality=0.5)


# ---------------------------------------------------------------------------
# the component index (tests/test_component_index.py's grid)
# ---------------------------------------------------------------------------

def _fuzz_ops(rng, n_res, n_ops):
    """(kind, rows, live rows after) operations against a row multiset."""
    live = []
    for _ in range(n_ops):
        if live and rng.random() < 0.45:
            k = int(rng.integers(1, min(6, len(live)) + 1))
            take = sorted(rng.choice(len(live), size=k, replace=False).tolist())
            rows = [live[i] for i in take]
            for i in reversed(take):
                live.pop(i)
            yield "remove", rows, list(live)
        else:
            k = int(rng.integers(1, 7))
            rows = list(zip(rng.integers(0, n_res, size=k).tolist(),
                            rng.integers(0, n_res, size=k).tolist()))
            live.extend(rows)
            yield "add", rows, list(live)


@pytest.mark.parametrize("seed", range(8))
def test_component_index_labels_match_reference_after_every_op(seed):
    rng = np.random.default_rng(seed)
    n_res = 12
    ridx, pidx = ref_engine.ComponentIndex(n_res), port_fabric.ComponentIndex(
        n_res)
    for kind, rows, live in _fuzz_ops(rng, n_res, 120):
        arr = np.array(rows, dtype=np.int64).reshape(-1, 2)
        getattr(ridx, kind)(arr[:, 0], arr[:, 1])
        getattr(pidx, kind)(arr[:, 0], arr[:, 1])
        assert pidx.n_pairs == ridx.n_pairs
        nodes = np.arange(2 * n_res)
        np.testing.assert_array_equal(pidx.labels(nodes), ridx.labels(nodes))
        if live:
            rin = np.array([a for a, _ in live], dtype=np.int64)
            rout = np.array([b for _, b in live], dtype=np.int64)
            np.testing.assert_array_equal(
                port_fabric._resource_components(rin, rout, n_res),
                ref_engine._resource_components(rin, rout, n_res))
            for n_new in (0, 1, rin.size // 2, rin.size):
                np.testing.assert_array_equal(
                    port_fabric._touched_rows(rin, rout, n_res, n_new),
                    ref_engine._touched_rows(rin, rout, n_res, n_new))


@pytest.mark.parametrize("seed", (3, 7, 11))
def test_live_index_matches_reference_under_faults(seed):
    """The index inside a faulted engine, compared after the whole drive;
    the commits are compared tick by tick by ``twin_drive``."""
    from test_torch_fault import fault_plan

    oinst = ref_stream(M=18, seed=seed, span=140.0)
    hi = float(oinst.releases.max())
    ticks = list(np.linspace(hi * 0.25, hi * 1.6, 10))
    pst, rst, _ = twin_drive(oinst, ticks, events=fault_plan(ticks),
                             track_commits=True)
    assert pst._cindex.n_pairs == rst._cindex.n_pairs == 0


# ---------------------------------------------------------------------------
# error messages, zero-flow coflows, the record types
# ---------------------------------------------------------------------------

def _eye_coflow(mod, n=4, cid=0):
    d = np.eye(n)
    return mod.Coflow(cid=cid, demand=torch.from_numpy(d) if mod is port
                      else d)


def _state(mod, **kw):
    if mod is port:
        kw["device"] = "cpu"
    return mod.FabricState(rates=np.array(RATES), delta=1.0, N=4, **kw)


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_fabric_state_rejects_late_and_future_arrivals(mod):
    c = _eye_coflow(mod)
    st = _state(mod)
    st.step([c], [3.0], 5.0)
    with pytest.raises(ValueError, match="late arrival: release 4.0 is not "
                       "after the previous tick at t=5.0"):
        st.step([c], [4.0], 10.0)
    with pytest.raises(ValueError, match="cannot admit a coflow released at "
                       "20.0 at tick t=10.0; queue it"):
        st.step([c], [20.0], 10.0)
    with pytest.raises(ValueError, match="non-decreasing: 1.0 < 5.0"):
        st.step((), (), 1.0)
    with pytest.raises(ValueError, match="got 1 coflows but 2 releases"):
        st.step([c], [6.0, 7.0], 10.0)
    with pytest.raises(ValueError, match="coflow 3 has N=3, fabric has N=4"):
        st.step([_eye_coflow(mod, 3, cid=3)], [6.0], 10.0)


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_sunflow_is_benchmark_only_in_the_service(mod):
    for algorithm in ("sunflow-core", "rand-sunflow"):
        with pytest.raises(ValueError, match="benchmark-only"):
            _state(mod, algorithm=algorithm)
    with pytest.raises(ValueError, match="full run_fast_online replay"):
        _state(mod, algorithm="sunflow-core")
    with pytest.raises(ValueError, match="sunflow"):
        _state(mod, scheduling="sunflow")


def test_zero_flow_coflow_finalizes_immediately():
    out = {}
    for mod in (ref, port):
        empty = mod.Coflow(cid=0, demand=(torch.zeros((4, 4), dtype=torch.float64)
                                          if mod is port else np.zeros((4, 4))))
        st = _state(mod)
        out[mod] = st.step([empty, _eye_coflow(mod, cid=1)], [0.5, 0.7], 1.0)
        st.finalize()
        ccts = st.ccts()
        assert float(ccts[0]) == 0.0 and float(ccts[1]) > 0.0
    assert_same_commit(out[port], out[ref])


def test_fabric_state_runs_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.FabricState(rates=np.array(RATES), delta=1.0, N=4)


def test_fabric_state_rejects_demand_on_another_device():
    st = _state(port)
    st.device = torch.device("meta")
    with pytest.raises(ValueError, match="demand is on cpu, but the fabric "
                       "runs on meta"):
        st.step([_eye_coflow(port)], [1.0], 2.0)


@pytest.mark.parametrize("bad, match", [
    (dict(demand=np.ones((2, 3))), "demand must be square"),
    (dict(demand=-np.eye(2)), "non-negative"),
    (dict(weight=0.0), "weight must be positive"),
])
def test_coflow_rejects_what_the_reference_rejects(bad, match):
    args = dict(cid=0, demand=np.eye(2), weight=1.0)
    args.update(bad)
    for mod in (ref, port):
        with pytest.raises(ValueError, match=match):
            mod.Coflow(**args)


def test_coflow_counts_match_reference():
    oinst = ref_stream(M=12, seed=6)
    for c in oinst.inst.coflows:
        p = to_port_coflow(c)
        assert (p.num_flows, p.n_ports) == (c.num_flows, c.n_ports)
        assert p.demand.dtype == torch.float64


@pytest.mark.parametrize("span", [0.0, 300.0])
def test_arrival_stream_matches_reference(span):
    oinst = ref_stream(M=20, seed=2, span=span)
    want = list(ref.arrival_stream(oinst))
    got = list(port.arrival_stream(to_port_online(oinst)))
    assert len(got) == len(want)
    for (gc, gr), (wc, wr) in zip(got, want):
        assert (gc.cid, gc.weight, gr) == (wc.cid, wc.weight, wr)
        np.testing.assert_array_equal(gc.demand.numpy(), wc.demand)


def test_instance_from_coflows_matches_the_stacked_instance():
    oinst = ref_stream(M=9, seed=1)
    p = to_port_online(oinst).inst
    built = port.instance_from_coflows(
        [to_port_coflow(c) for c in oinst.inst.coflows], oinst.inst.rates,
        oinst.inst.delta, device="cpu")
    for name in ("demand", "weights", "cids", "rates"):
        assert torch.equal(getattr(built, name), getattr(p, name)), name
    empty = port.instance_from_coflows([], RATES, 8.0, n_ports=5,
                                       device="cpu")
    assert (empty.M, empty.N, empty.K) == (0, 5, 3)
