"""The port's fault plane (``repro_torch.core.fault`` and
``FabricState``'s fault methods) vs the reference's, on the CPU.

Each scenario drives the reference's and the port's ``FabricState`` through
the same stream and the same fault events (scripted through a
``FaultInjector`` or applied between ticks, including late discovery
timestamped before the current tick) and holds every ``TickCommit``, every
``FaultApplication`` (aborted circuits, requeues, retracted
finalizations), the final CCTs, the aborted keys and the telemetry counters
equal bit for bit: for all three incremental schedulings, with and without
delta-scheduling. The grids are those of ``tests/test_fault_differential.py``,
``tests/test_component_index.py`` and ``tests/test_fault_residue.py``, with
fixed seeds (no Hypothesis draws).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.engine as ref_engine
import repro.core.fault as ref_fault
import repro_torch.core as port
import repro_torch.core.fault as port_fault
from test_torch_fabric import (
    RATES,
    SCHEDS,
    assert_same_commit,
    assert_same_fault_app,
    even_ticks,
    ref_stream,
    tick_batches,
    to_port_coflow,
    to_port_event,
    twin_drive,
)

K = len(RATES)


def fault_plan(ticks):
    """tests/test_component_index.py's plan: a drift, a core failure, a port
    flap and the core's recovery, each just before its tick."""
    return {1: ref_fault.DeltaDrift(core=2, t=float(ticks[1]) - 1e-3,
                                    delta=12.0),
            3: ref_fault.CoreDown(core=1, t=float(ticks[3]) - 1e-3),
            5: ref_fault.PortFlap(core=0, port=0, t=float(ticks[5]) - 1e-3,
                                  t_end=float(ticks[5])),
            7: ref_fault.CoreUp(core=1, t=float(ticks[7]) - 1e-3)}


def _plans(hi):
    """Injector schedules by fault type over a stream of span ``hi``."""
    return {
        "core_down": [ref_fault.CoreDown(t=0.3 * hi, core=2)],
        "core_up": [ref_fault.CoreDown(t=0.2 * hi, core=1),
                    ref_fault.CoreUp(t=0.5 * hi, core=1)],
        "port_flap": [ref_fault.PortFlap(t=0.3 * hi, t_end=0.45 * hi,
                                         core=0, port=1)],
        "delta_drift": [ref_fault.DeltaDrift(t=0.25 * hi, core=1,
                                             delta=15.0)],
        "mixed": [ref_fault.CoreDown(t=0.25 * hi, core=2),
                  ref_fault.CoreUp(t=0.5 * hi, core=2),
                  ref_fault.PortFlap(t=0.6 * hi, t_end=0.62 * hi, core=1,
                                     port=0),
                  ref_fault.DeltaDrift(t=0.7 * hi, core=0, delta=12.0)],
    }


# ---------------------------------------------------------------------------
# every fault type, every incremental scheduling, delta-scheduling on/off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta_schedule", [True, False])
@pytest.mark.parametrize("scheduling", SCHEDS)
@pytest.mark.parametrize("plan", ["core_down", "core_up", "port_flap",
                                  "delta_drift", "mixed"])
def test_injected_faults_match_reference(plan, scheduling, delta_schedule):
    oinst = ref_stream(M=16, seed=4, span=300.0)
    hi = float(oinst.releases.max())
    twin_drive(oinst, even_ticks(oinst, 8), injector=_plans(hi)[plan],
               scheduling=scheduling, delta_schedule=delta_schedule)


@pytest.mark.parametrize("algorithm", ["ours", "rho-assign", "rand-assign"])
def test_injected_faults_match_reference_algorithms(algorithm):
    oinst = ref_stream(M=16, seed=6, span=250.0)
    hi = float(oinst.releases.max())
    twin_drive(oinst, even_ticks(oinst, 7), injector=_plans(hi)["mixed"],
               algorithm=algorithm, seed=3)


@pytest.mark.parametrize("scheduling", SCHEDS)
def test_late_discovered_faults_match_reference(scheduling):
    """Faults applied between ticks and timestamped before the last tick:
    circuits believed delivered are retro-aborted."""
    oinst = ref_stream(M=18, seed=9, span=300.0)
    ticks = even_ticks(oinst, 8)
    late = {3: ref_fault.CoreDown(t=float(ticks[1]) + 0.5, core=0),
            5: ref_fault.PortFlap(t=float(ticks[3]) - 2.0,
                                  t_end=float(ticks[4]), core=1, port=2),
            6: ref_fault.CoreUp(t=float(ticks[5]), core=0)}
    pst, _rst, _ = twin_drive(oinst, ticks, events=late,
                              scheduling=scheduling, track_commits=True)
    assert sum(app.n_aborted for app in pst.fault_log) > 0


@pytest.mark.parametrize("seed", range(8))
def test_zero_event_injector_bit_identical(seed):
    """A zero-event injector == no injector, in the port and against the
    reference."""
    scheduling = SCHEDS[seed % 3]
    algorithm = ["ours", "rho-assign", "rand-assign"][seed % 3]
    oinst = ref_stream(seed=seed, span=[0.0, 200.0, 500.0][seed % 3])
    ticks = even_ticks(oinst, 3 + seed % 4)
    kw = dict(algorithm=algorithm, scheduling=scheduling, seed=seed)
    p0, _, plain = twin_drive(oinst, ticks, injector=None, **kw)
    p1, _, faulty = twin_drive(oinst, ticks, injector=[], **kw)
    for a, b in zip(faulty, plain):
        for name in ("gid", "cid", "fi", "fj", "core", "size",
                     "t_establish", "t_complete"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert (a.finalized, a.n_pending) == (b.finalized, b.n_pending)
    assert torch.equal(p1.ccts(), p0.ccts())
    assert p1.track_commits and not p0.track_commits


@pytest.mark.parametrize("algorithm", ["ours", "rand-assign"])
@pytest.mark.parametrize("seed,k_fail", [(s, s % K) for s in range(6)])
def test_core_down_at_zero_matches_reference(seed, k_fail, algorithm):
    oinst = ref_stream(seed=seed, span=250.0)
    twin_drive(oinst, even_ticks(oinst, 5),
               injector=[ref_fault.CoreDown(t=0.0, core=k_fail)],
               algorithm=algorithm, seed=seed)


@pytest.mark.parametrize("seed", (3, 7, 11, 19))
def test_scoped_invalidation_matches_full_drop_and_reference(seed):
    """Fault-scoped cache invalidation == dropping the whole tentative
    cache, in the port; and both equal the reference."""
    oinst = ref_stream(M=18, seed=seed, span=140.0)
    hi = float(oinst.releases.max())
    ticks = list(np.linspace(hi * 0.25, hi * 1.6, 10))
    pst, _rst, scoped = twin_drive(oinst, ticks, events=fault_plan(ticks),
                                   track_commits=True)
    # the full-drop escape hatch, port only
    inst = oinst.inst
    st = port.FabricState(rates=inst.rates, delta=inst.delta, N=inst.N,
                          track_commits=True, device="cpu")
    st._fault_scoped_tent = False
    plan = fault_plan(ticks)
    pcofs = [to_port_coflow(c) for c in inst.coflows]
    for x, (T, ids) in enumerate(zip(ticks, tick_batches(oinst, ticks))):
        if x in plan:
            st.apply_fault(to_port_event(plan[x]))
        got = st.step([pcofs[int(m)] for m in ids], oinst.releases[ids], T)
        for name in ("gid", "core", "t_establish", "t_complete"):
            assert torch.equal(getattr(got, name), getattr(scoped[x], name))
    st.finalize()
    assert torch.equal(st.ccts(), pst.ccts())


# ---------------------------------------------------------------------------
# small hand-built scenarios (tests/test_fault_differential.py)
# ---------------------------------------------------------------------------

def _big_coflow(mod, n=4, size=100.0):
    D = np.zeros((n, n))
    for p in range(n - 1):
        D[p, p + 1] = size
    return mod.Coflow(cid=0, demand=torch.from_numpy(D) if mod is port else D)


def _pair(rates, **kw):
    r = ref_engine.FabricState(rates=np.array(rates), delta=1.0, N=4, **kw)
    pkw = dict(kw)
    if "faults" in pkw:
        pkw["faults"] = port_fault.FaultInjector(
            [to_port_event(e) for e in kw["faults"].pending])
    p = port.FabricState(rates=np.array(rates), delta=1.0, N=4,
                         device="cpu", **pkw)
    return r, p


def _step_both(r, p, size, rel, t):
    want = r.step([_big_coflow(ref, size=size)], [rel], t)
    got = p.step([_big_coflow(port, size=size)], [rel], t)
    assert_same_commit(got, want)
    return got


def test_core_down_aborts_in_flight_and_requeues():
    r, p = _pair([10.0, 10.0, 10.0], track_commits=True)
    out = _step_both(r, p, 100.0, 0.5, 1.0)
    failed = int(out.core[0])
    ev = ref_fault.CoreDown(t=2.0, core=failed)
    app = p.apply_fault(to_port_event(ev))
    assert_same_fault_app(app, r.apply_fault(ev))
    assert app.unfinalized == (0,) and app.n_aborted == app.requeued > 0
    out2 = p.finalize()
    assert_same_commit(out2, r.finalize())
    assert not bool((out2.core == failed).any())
    assert float(out2.size.sum()) == app.n_aborted * 100.0  # re-served once


def test_completed_circuits_survive_core_down():
    r, p = _pair([10.0, 10.0], track_commits=True)
    out = _step_both(r, p, 10.0, 0.0, 50.0)
    ev = ref_fault.CoreDown(t=40.0, core=int(out.core[0]))
    app = p.apply_fault(to_port_event(ev))
    assert_same_fault_app(app, r.apply_fault(ev))
    assert app.n_aborted == 0
    assert float(p.ccts()[0]) == float(out.t_complete.max())


def test_port_flap_aborts_overlaps_and_delays_rematch():
    r, p = _pair([10.0, 10.0], track_commits=True)
    out = _step_both(r, p, 100.0, 0.5, 1.0)
    ev = ref_fault.PortFlap(t=2.0, t_end=60.0, core=int(out.core[0]), port=0)
    assert_same_fault_app(p.apply_fault(to_port_event(ev)),
                          r.apply_fault(ev))
    assert_same_commit(p.finalize(), r.finalize())


def test_core_up_and_delta_drift_through_an_injector():
    r, p = _pair([10.0, 10.0], faults=ref_fault.FaultInjector(
        [ref_fault.CoreDown(t=0.0, core=1), ref_fault.CoreUp(t=100.0, core=1),
         ref_fault.DeltaDrift(t=130.0, core=0, delta=5.0)]))
    _step_both(r, p, 10.0, 0.0, 50.0)
    assert not p.core_up[1]
    out = _step_both(r, p, 10.0, 120.0, 150.0)
    assert p.core_up[1] and bool((out.core == 1).any())
    out = _step_both(r, p, 10.0, 160.0, 400.0)
    assert out.delta_f is not None and p.delta_drifted


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_fault_error_cases(mod):
    fault = ref_fault if mod is ref else port_fault
    kw = dict(device="cpu") if mod is port else {}
    st = mod.FabricState(rates=np.array(RATES), delta=1.0, N=4,
                         track_commits=True, **kw)
    with pytest.raises(ValueError, match="core 7 out of range for K=3"):
        st.apply_fault(fault.CoreDown(t=0.0, core=7))
    with pytest.raises(ValueError, match="core 1 is already up"):
        st.apply_fault(fault.CoreUp(t=0.0, core=1))
    st.apply_fault(fault.CoreDown(t=0.0, core=0))
    with pytest.raises(ValueError, match="core 0 is already down"):
        st.apply_fault(fault.CoreDown(t=0.0, core=0))
    st.apply_fault(fault.CoreDown(t=0.0, core=1))
    with pytest.raises(RuntimeError, match="last core up \\(fabric lost\\)"):
        st.apply_fault(fault.CoreDown(t=0.0, core=2))
    assert st.core_up[2]
    with pytest.raises(ValueError, match="port 9 out of range for N=4"):
        st.apply_fault(fault.PortFlap(t=0.0, t_end=1.0, core=2, port=9))
    with pytest.raises(TypeError, match="unknown fault event"):
        st.apply_fault("core-down")
    with pytest.raises(ValueError, match="non-empty"):
        fault.PortFlap(t=5.0, t_end=5.0, core=0, port=0)
    with pytest.raises(ValueError, match="drifted delta must be >= 0"):
        fault.DeltaDrift(t=0.0, core=0, delta=-1.0)
    with pytest.raises(ValueError, match="fault times must be >= 0"):
        fault.FaultInjector([fault.CoreDown(t=-1.0, core=0)])
    untracked = mod.FabricState(rates=np.array(RATES), delta=1.0, N=4, **kw)
    with pytest.raises(RuntimeError, match="track_commits"):
        untracked.apply_fault(fault.CoreDown(t=0.0, core=0))


def test_injector_pops_in_time_order_like_reference():
    evs = [ref_fault.CoreUp(t=5.0, core=1), ref_fault.CoreDown(t=1.0, core=1),
           ref_fault.DeltaDrift(t=5.0, core=0, delta=2.0)]
    r = ref_fault.FaultInjector(evs)
    p = port_fault.FaultInjector([to_port_event(e) for e in evs])
    assert len(p) == len(r) == 3
    for t in (0.5, 1.0, 4.0, 5.0, 9.0):
        got, want = p.pop_due(t), r.pop_due(t)
        assert [dataclasses.asdict(e) for e in got] == \
            [dataclasses.asdict(e) for e in want]
    assert p.pending == ()
    key = port_fault.AbortedCircuit(gid=1, cid=2, i=3, j=4, core=0,
                                    size=5.0, t_establish=6.0,
                                    t_abort=7.0).key
    assert key == ref_fault.AbortedCircuit(gid=1, cid=2, i=3, j=4, core=0,
                                           size=5.0, t_establish=6.0,
                                           t_abort=7.0).key


# ---------------------------------------------------------------------------
# CoreUp's reset and the watermark GC (tests/test_fault_residue.py)
# ---------------------------------------------------------------------------

def _rebalance_choices(mod, seed, K=3, n_ports=12, n_warm=120, n_probe=240):
    """tests/test_fault_residue.py's rebalance scenario: warm a state with
    core 0 masked out, then assign a probe window with and without
    ``reset_core(0)``. Returns (reset choices, stale choices)."""
    rng = np.random.default_rng(seed)
    rates = np.full(K, 20.0)

    def chunk(n):
        arrs = (rng.integers(0, n_ports, n).astype(np.int64),
                rng.integers(0, n_ports, n).astype(np.int64),
                rng.uniform(1.0, 50.0, n))
        return tuple(torch.from_numpy(a) for a in arrs) if mod is port \
            else arrs

    st = mod.FlatAssignState("tau-aware", rates, 4.0, n_ports, seed=seed)
    up = np.ones(K, dtype=bool)
    up[0] = False
    st.assign(*chunk(n_warm), up=up)
    stale = copy.deepcopy(st)
    st.reset_core(0)
    fi, fj, sz = chunk(n_probe)
    reset = st.assign(fi, fj, sz)
    old = stale.assign(fi, fj, sz)
    if mod is port:
        reset, old = reset.numpy(), old.numpy()
    return reset, old


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2302, 3484, 27448])
def test_core_up_reset_choices_equal_reference(seed):
    """Seeds 2302, 3484 and 27448 are the reference's known breaks of its
    rebalance property; the port must reproduce them choice for choice."""
    want = _rebalance_choices(ref, seed)
    got = _rebalance_choices(port, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _gc_drive(lookback, fault_at=None, seed=6):
    oinst = ref_stream(M=14, seed=seed, span=300.0)
    hi = float(oinst.releases.max())
    ticks = list(np.linspace(hi * 0.2, hi * 1.8, 10))
    events = ({} if fault_at is None else
              {fault_at: ref_fault.CoreDown(core=1,
                                            t=float(ticks[fault_at]) - 1e-3)})
    return twin_drive(oinst, ticks, events=events, track_commits=True,
                      fault_lookback=lookback), hi


@pytest.mark.parametrize("frac,fault_at", [(None, None), (0.3, None),
                                           (0.4, None), (0.4, 7)])
def test_watermark_gc_matches_reference(frac, fault_at):
    hi = float(ref_stream(M=14, seed=6, span=300.0).releases.max())
    lookback = np.inf if frac is None else frac * hi
    (pst, rst, commits), _ = _gc_drive(lookback, fault_at)
    committed = sum(c.n_flows for c in commits)
    aborted = sum(app.n_aborted for app in pst.fault_log)
    assert pst.commits_gced + pst.n_commits_retained + aborted == committed
    assert (pst.commits_gced > 0) == (frac is not None)


@pytest.mark.parametrize("mod", [ref, port], ids=["reference", "port"])
def test_fault_before_watermark_rejected(mod):
    oinst = ref_stream(M=14, seed=6, span=300.0)
    hi = float(oinst.releases.max())
    kw = dict(device="cpu") if mod is port else {}
    inst = oinst.inst
    st = mod.FabricState(rates=inst.rates, delta=inst.delta, N=inst.N,
                         track_commits=True, fault_lookback=0.2 * hi, **kw)
    cofs = (inst.coflows if mod is ref
            else [to_port_coflow(c) for c in inst.coflows])
    st.step(list(cofs), oinst.releases, hi)
    fault = ref_fault if mod is ref else port_fault
    with pytest.raises(ValueError, match="predates the committed-circuit "
                       "retention watermark"):
        st.apply_fault(fault.CoreDown(core=0, t=0.0))
    with pytest.raises(ValueError, match="fault_lookback must be >= 0"):
        mod.FabricState(rates=inst.rates, delta=inst.delta, N=inst.N,
                        fault_lookback=-1.0, **kw)
