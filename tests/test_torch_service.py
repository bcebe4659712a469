"""The port's fabric-manager service (``repro_torch.service``) vs the
reference's (``repro.service``), on the CPU.

The same arrivals, ticks and fault reports go to the reference's
``FabricManager`` and the port's, and everything but wall-clock time must
agree: every ``TickReport`` and its circuit program, ``summary()``'s
counters, the merged program of record (arrays and ``events()``), the CCTs,
the fault reports with their corrective teardowns, and the admission
counters (rejected, late, deferred, shed, backfilled, dropped). The grids
are those of ``tests/test_service.py``, ``tests/test_overload.py`` and
``tests/test_fault_differential.py``. Also: ``instance_key`` gives the
reference's digests, and the one-shot plane's programs (healthy, degraded,
drifted; ``backend="numpy"`` and ``"kernel"``) equal the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.fault as ref_fault
import repro.service as ref_service
import repro_torch.core as port
import repro_torch.core.fault as port_fault
import repro_torch.service as port_service
from test_torch_coflow import to_port
from test_torch_fabric import (
    RATES,
    even_ticks,
    ref_stream,
    to_port_coflow,
    to_port_event,
)
from test_torch_online import to_port_online

TRACE = ref.synth_fb_trace(200, seed=2026)
#: summary() keys read off the wall clock
NOISY = {"total_tick_wall_s", "coflows_per_s", "decision_latency_p50_s",
         "decision_latency_p99_s"}
PROGRAM_ARRAYS = ("core", "ingress", "egress", "cid", "size", "t_establish",
                  "t_complete")


def _service_stream(N=12, M=25, seed=0, span_factor=1.0):
    off = ref.sample_online_instance(TRACE, N=N, M=M, rates=RATES, delta=8.0,
                                     span=0.0, seed=seed)
    mk = float(ref.run_fast_online(off, "ours").ccts.max())
    return ref.sample_online_instance(TRACE, N=N, M=M, rates=RATES,
                                      delta=8.0, span=mk * span_factor,
                                      seed=seed)


def assert_same_program(got, want, msg=""):
    np.testing.assert_array_equal(got.rates.cpu().numpy(), want.rates)
    assert (got.delta, got.N, got.n_segments) == \
        (want.delta, want.N, want.n_segments), msg
    for name in PROGRAM_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name),
                                      err_msg=f"{msg}: {name}")
    if want.delta_seg is None:
        assert got.delta_seg is None, msg
    else:
        np.testing.assert_array_equal(got.delta_seg.cpu().numpy(),
                                      want.delta_seg)


def assert_same_events(got, want):
    assert [dataclasses.astuple(e) for e in got.events()] == \
        [dataclasses.astuple(e) for e in want.events()]


def assert_same_report(got, want, msg=""):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for key in g:
        if key not in ("wall_s", "program"):
            assert g[key] == w[key], (msg, key)
    assert got.wall_s >= 0.0
    assert_same_program(got.program, want.program, msg)


def assert_same_fault_report(got, want):
    assert dataclasses.asdict(got.event) == dataclasses.asdict(want.event)
    assert [dataclasses.astuple(e) for e in got.teardowns] == \
        [dataclasses.astuple(e) for e in want.teardowns]
    for key in ("aborted", "requeued", "reassigned_pending", "unfinalized",
                "cache_purged"):
        assert getattr(got, key) == getattr(want, key), key


def assert_same_summary(pm, rm):
    got, want = pm.summary(), rm.summary()
    assert set(got) == set(want)
    for key in set(want) - NOISY:
        assert got[key] == want[key], key
    for key in NOISY:
        assert got[key] >= 0.0


def manager_pair(injector=(), **cfg):
    """A reference and a port FabricManager over one configuration."""
    rkw, pkw = dict(cfg), dict(cfg)
    if injector is not None and len(injector):
        rkw["faults"] = ref_fault.FaultInjector(list(injector))
        pkw["faults"] = port_fault.FaultInjector(
            [to_port_event(e) for e in injector])
    if "admission" in cfg and cfg["admission"] is not None:
        pkw["admission"] = port_service.AdmissionPolicy(
            **dataclasses.asdict(cfg["admission"]))
    return (ref_service.FabricManager(ref_service.FabricConfig(**rkw)),
            port_service.FabricManager(port_service.FabricConfig(**pkw),
                                       device="cpu"))


def twin_manage(oinst, ticks, *, reports=None, flush=True, **cfg):
    """Submit ``oinst``'s arrivals to both managers tick by tick (release
    order), tick both, apply ``reports`` ({tick index: fault event}) after
    that tick through ``report_fault``, flush; every report, fault report,
    summary, program and CCT must agree. Returns the two managers."""
    rm, pm = manager_pair(**cfg)
    reports = reports or {}
    rel = oinst.releases
    order = np.argsort(rel, kind="stable")
    pcofs = [to_port_coflow(c) for c in oinst.inst.coflows]
    nxt = 0
    for x, T in enumerate(ticks):
        while nxt < order.size and rel[order[nxt]] <= T:
            m = int(order[nxt])
            outcome = []
            for mgr, cof in ((rm, oinst.inst.coflows[m]), (pm, pcofs[m])):
                try:
                    mgr.submit(cof, float(rel[m]))
                    outcome.append("ok")
                except (ref_service.BackpressureError,
                        port_service.BackpressureError):
                    outcome.append("backpressure")
            assert outcome[0] == outcome[1]
            nxt += 1
        assert_same_report(pm.tick(float(T)), rm.tick(float(T)), f"tick {x}")
        if x in reports:
            assert_same_fault_report(
                pm.report_fault(to_port_event(reports[x])),
                rm.report_fault(reports[x]))
        assert_same_summary(pm, rm)
    if flush:
        assert_same_report(pm.flush(), rm.flush(), "flush")
    assert len(pm.fault_reports) == len(rm.fault_reports)
    for a, b in zip(pm.fault_reports, rm.fault_reports):
        assert_same_fault_report(a, b)
    assert_same_summary(pm, rm)
    np.testing.assert_array_equal(pm.ccts().cpu().numpy(), rm.ccts())
    assert_same_program(pm.program(), rm.program(), "program of record")
    assert pm.state.aborted_keys() == rm.state.aborted_keys()
    return pm, rm


# ---------------------------------------------------------------------------
# the streaming plane (tests/test_service.py)
# ---------------------------------------------------------------------------

CONFIGS = {
    "plain": dict(),
    "validate_every_tick": dict(validate_every_tick=True),
    "priority-guard": dict(scheduling="priority-guard"),
    "reserving": dict(scheduling="reserving"),
    "no-delta-schedule": dict(delta_schedule=False),
    "history-3": dict(max_history_ticks=3),
    "latency-window-8": dict(max_latency_samples=8),
    "rho-assign": dict(algorithm="rho-assign"),
    "rand-assign": dict(algorithm="rand-assign", seed=5),
    "locality": dict(locality=0.5),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_manager_stream_matches_reference(name):
    oinst = _service_stream(seed=7)
    pm, rm = twin_manage(oinst, even_ticks(oinst, 6), rates=RATES, delta=8.0,
                         N=12, **CONFIGS[name])
    pm.program().validate()
    assert pm.summary()["coflows_finalized"] == oinst.inst.M


def test_manager_stream_equals_the_full_replay():
    """The port's stream, by admission id, is one ``run_fast_online`` of
    the whole stream (fp64 backend), bit for bit."""
    oinst = _service_stream(seed=8, span_factor=0.5)
    pm, _ = twin_manage(oinst, even_ticks(oinst, 6), rates=RATES, delta=8.0,
                        N=12)
    order = np.argsort(oinst.releases, kind="stable")
    replay = to_port_online(ref.OnlineInstance(
        inst=ref.Instance(coflows=tuple(oinst.inst.coflows[int(m)]
                                        for m in order),
                          rates=oinst.inst.rates, delta=oinst.inst.delta),
        releases=oinst.releases[order]))
    fast = port.run_fast_online(replay)
    assert torch.equal(pm.ccts(), fast.ccts)


def test_manager_backpressure_matches_reference():
    oinst = _service_stream(M=12, seed=6, span_factor=2.0)
    pm, rm = twin_manage(oinst, [float(oinst.releases.max())], rates=RATES,
                         delta=8.0, N=12, max_queue_depth=3)
    assert pm.summary()["rejected"] == oinst.inst.M - 3


def test_repeated_tick_time_holds_late_requests():
    for mod in (ref, port):
        svc = ref_service if mod is ref else port_service
        kw = {} if mod is ref else dict(device="cpu")
        mgr = svc.FabricManager(svc.FabricConfig(rates=RATES, delta=1.0, N=4),
                                **kw)
        eye = np.eye(4) if mod is ref else torch.eye(4, dtype=torch.float64)
        mgr.tick(10.0)
        mgr.submit(mod.Coflow(cid=0, demand=eye), 5.0)
        rep = mgr.tick(10.0)
        assert rep.admitted == 0 and mgr.queue.depth == 1
        rep = mgr.tick(11.0)
        assert rep.admitted == 1 and mgr.queue.late == 1
        mgr.flush()
        assert mgr.summary()["coflows_finalized"] == 1


def test_bad_submission_rejected_without_losing_the_batch():
    mgr = port_service.FabricManager(
        port_service.FabricConfig(rates=RATES, delta=1.0, N=4), device="cpu")
    good = port.Coflow(cid=0, demand=torch.eye(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="fabric has N=4"):
        mgr.submit(port.Coflow(cid=1, demand=np.eye(3)), 1.0)
    mgr.submit(good, 1.0)
    real_step = mgr.state.step
    mgr.state.step = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        mgr.tick(2.0)
    assert mgr.queue.depth == 1
    mgr.state.step = real_step
    mgr.tick(2.0)
    mgr.flush()
    assert mgr.summary()["coflows_finalized"] == 1


def test_manager_rejects_demand_off_its_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_service.FabricManager(port_service.FabricConfig(N=4))
    mgr = port_service.FabricManager(port_service.FabricConfig(N=4),
                                     device="cpu")
    mgr.device = torch.device("meta")
    with pytest.raises(ValueError, match="demand is on cpu, but the fabric "
                       "runs on meta"):
        mgr.submit(port.Coflow(cid=0, demand=np.eye(4)), 1.0)


# ---------------------------------------------------------------------------
# overload (tests/test_overload.py)
# ---------------------------------------------------------------------------

OVERLOAD = [
    (dict(M=30, seed=1, span_factor=0.5), 12,
     ref_service.AdmissionPolicy(max_pending_flows=120)),
    (dict(M=30, seed=2, span_factor=0.4), 10,
     ref_service.AdmissionPolicy(max_pending_flows=80, shed_depth=2,
                                 resume_depth=1)),
    (dict(M=30, seed=3, span_factor=0.3), 10,
     ref_service.AdmissionPolicy(max_pending_flows=40, shed_depth=1,
                                 resume_depth=0, max_standby=2)),
    (dict(M=20, seed=4, span_factor=0.5), 8, ref_service.AdmissionPolicy()),
    (dict(M=30, seed=1, span_factor=0.4), 10,
     ref_service.AdmissionPolicy(max_pending_flows=60, shed_depth=2,
                                 resume_depth=1)),
]


@pytest.mark.parametrize("case", range(len(OVERLOAD)))
def test_overload_counters_match_reference(case):
    stream_kw, n_ticks, policy = OVERLOAD[case]
    oinst = _service_stream(**stream_kw)
    pm, _rm = twin_manage(oinst, even_ticks(oinst, n_ticks), rates=RATES,
                          delta=8.0, N=12, max_queue_depth=256,
                          admission=policy)
    s = pm.summary()
    assert s["coflows_admitted"] + s["rejected"] + s["dropped"] == \
        oinst.inst.M
    assert s["coflows_finalized"] == s["coflows_admitted"]


def _req(mod, release, score=0.0, n_flows=1, deferred=False):
    demand = np.zeros((n_flows + 1, n_flows + 1))
    demand[0, 1:] = 5.0
    cf = mod.Coflow(cid=0, demand=demand, weight=1.0)
    svc = ref_service if mod is ref else port_service
    return svc.ArrivalRequest(coflow=cf, release=float(release),
                              submitted_s=0.0, score=float(score),
                              n_flows=n_flows, deferred=deferred)


QUEUE_OPS = [
    # (policy kwargs, [("push", release, score, n_flows) | ("drain", t_now,
    #  t_floor, budget) | ("recall",)])
    (dict(max_pending_flows=10),
     [("push", 1.0, 0.0, 8), ("push", 1.0, 0.0, 5), ("push", 1.0, 0.0, 2),
      ("drain", 2.0, 0.0, 10), ("drain", 3.0, 2.0, 10)]),
    (dict(shed_depth=2, resume_depth=1),
     [("push", 1.0, 3.0, 1), ("push", 1.0, 1.0, 1), ("push", 1.0, 2.0, 1),
      ("push", 1.0, 0.5, 1), ("push", 10.0, 0.0, 1), ("drain", 2.0, 0.0, 0),
      ("drain", 3.0, 2.0, 1), ("drain", 4.0, 3.0, None), ("recall",),
      ("drain", 11.0, 4.0, None)]),
    (dict(max_pending_flows=4, shed_depth=1, resume_depth=0, max_standby=1),
     [("push", 1.0, 1.0, 3), ("push", 1.0, 2.0, 3), ("push", 1.0, 0.0, 3),
      ("push", 2.0, 5.0, 1), ("drain", 2.0, 0.0, 4), ("drain", 3.0, 2.0, 4),
      ("drain", 3.0, 3.0, 4), ("recall",), ("drain", 5.0, 3.0, None)]),
]


@pytest.mark.parametrize("case", range(len(QUEUE_OPS)))
def test_admission_queue_matches_reference(case):
    pol_kw, ops = QUEUE_OPS[case]
    queues = {mod: (ref_service if mod is ref else port_service).AdmissionQueue(
        max_depth=4, policy=(ref_service if mod is ref else port_service)
        .AdmissionPolicy(**pol_kw)) for mod in (ref, port)}
    for op in ops:
        out = {}
        for mod, q in queues.items():
            if op[0] == "push":
                try:
                    q.push(_req(mod, op[1], op[2], op[3]))
                    out[mod] = "ok"
                except (ref_service.BackpressureError,
                        port_service.BackpressureError):
                    out[mod] = "backpressure"
            elif op[0] == "drain":
                out[mod] = [(r.release, r.score, r.n_flows, r.deferred)
                            for r in q.drain(op[1], op[2],
                                             flow_budget=op[3])]
            else:
                out[mod] = q.recall_standby()
        assert out[port] == out[ref], op
        for name in ("rejected", "late", "deferred", "deferred_flows", "shed",
                     "backfilled", "dropped", "depth", "standby_depth",
                     "total_depth", "max_release"):
            assert getattr(queues[port], name) == getattr(queues[ref], name)


@pytest.mark.parametrize("kw, match", [
    (dict(max_pending_flows=-1), "max_pending_flows"),
    (dict(resume_depth=4), "resume_depth without"),
    (dict(shed_depth=4, resume_depth=8), "oscillate"),
    (dict(max_standby=16), "max_standby without"),
])
def test_admission_policy_rejects_what_the_reference_rejects(kw, match):
    for svc in (ref_service, port_service):
        with pytest.raises(ValueError, match=match):
            svc.AdmissionPolicy(**kw)


# ---------------------------------------------------------------------------
# the fault plane through the manager (tests/test_fault_differential.py)
# ---------------------------------------------------------------------------

def test_report_fault_end_to_end_matches_reference():
    oinst = ref_stream(M=24, seed=4, span=400.0)
    ticks = even_ticks(oinst, 6)
    fault = ref_fault.CoreDown(t=float(ticks[2]) + 0.5, core=2)
    pm, rm = twin_manage(oinst, ticks, reports={2: fault}, rates=RATES,
                         delta=8.0, N=10, validate_every_tick=True)
    rep = pm.fault_reports[0]
    assert rep.aborted == rep.requeued == len(rep.teardowns)
    program = pm.program()
    program.validate()
    # conservation: every coflow's delivered bytes equal its demand
    order = np.argsort(oinst.releases, kind="stable")
    sent = torch.zeros((oinst.inst.M, 10, 10), dtype=torch.float64)
    sent.index_put_((program.cid, program.ingress, program.egress),
                    program.size, accumulate=True)
    want = np.stack([oinst.inst.coflows[int(m)].demand for m in order])
    np.testing.assert_allclose(sent.numpy(), want, rtol=0, atol=1e-9)


def test_injected_and_late_faults_through_the_manager_match_reference():
    oinst = ref_stream(M=18, seed=9, span=300.0)
    ticks = even_ticks(oinst, 6)
    hi = float(oinst.releases.max())
    inj = [ref_fault.CoreDown(t=0.25 * hi, core=2),
           ref_fault.CoreUp(t=0.5 * hi, core=2),
           ref_fault.PortFlap(t=0.6 * hi, t_end=0.62 * hi, core=1, port=0),
           ref_fault.DeltaDrift(t=0.7 * hi, core=0, delta=12.0)]
    late = {4: ref_fault.CoreDown(t=float(ticks[3]) - 1.0, core=1)}
    pm, _ = twin_manage(oinst, ticks, injector=inj, reports=late,
                        rates=RATES, delta=8.0, N=10,
                        validate_every_tick=True)
    pm.program().validate()
    assert pm.summary()["faults_applied"] == 5


def test_fault_lookback_gc_through_the_manager_matches_reference():
    oinst = ref_stream(M=14, seed=9, span=200.0)
    hi = float(oinst.releases.max())
    ticks = list(np.linspace(hi * 0.2, hi * 1.6, 8))
    pm, _ = twin_manage(oinst, ticks, rates=RATES, delta=8.0, N=10,
                        max_queue_depth=256, fault_lookback=hi * 0.3)
    s = pm.summary()
    assert s["commits_gced"] > 0
    assert s["commits_gced"] + s["commits_retained"] == s["flows_committed"]


# ---------------------------------------------------------------------------
# the one-shot plane and the cache
# ---------------------------------------------------------------------------

def _key_cases():
    inst = ref.sample_instance(TRACE, N=8, M=6, rates=RATES, delta=8.0,
                               seed=1)
    rel = np.linspace(0.0, 50.0, inst.M)
    empty = ref.Instance(coflows=(), rates=np.array(RATES), delta=2.0)
    return [
        (inst, None, {}),
        (inst, None, dict(algorithm="rho-assign", seed=3)),
        (inst, None, dict(scheduling="reserving", backend="numpy")),
        (inst, rel, {}),
        (inst, None, dict(fabric="up=101")),
        (inst, None, dict(fabric="up=011;delta_k=8.0,12.0,8.0")),
        (empty, None, {}),
    ]


@pytest.mark.parametrize("case", range(7))
def test_instance_key_digest_equals_the_reference(case):
    inst, rel, kw = _key_cases()[case]
    p = (to_port(inst) if inst.M else port.instance_from_arrays(
        np.zeros((0, 4, 4)), np.zeros(0), np.zeros(0, np.int64), RATES, 2.0,
        device="cpu"))
    assert port_service.instance_key(p, rel, **kw) == \
        ref_service.instance_key(inst, rel, **kw)
    if rel is not None:
        assert port_service.instance_key(p, torch.from_numpy(rel), **kw) == \
            ref_service.instance_key(inst, rel, **kw)


def _one_shot_pair(inst):
    return manager_pair(rates=RATES, delta=8.0, N=inst.N)


@pytest.mark.parametrize("online", [False, True])
def test_one_shot_programs_and_cache_match_reference(online):
    oinst = ref_stream(N=10, M=15, seed=3, span=200.0)
    rinst = oinst if online else oinst.inst
    pinst = to_port_online(oinst) if online else to_port(oinst.inst)
    rm, pm = _one_shot_pair(oinst.inst)
    for kw in (dict(), dict(), dict(algorithm="rho-assign"),
               dict(scheduling="priority-guard"), dict()):
        (gp, ghit), (wp, whit) = (pm.schedule_instance(pinst, **kw),
                                  rm.schedule_instance(rinst, **kw))
        assert ghit == whit
        assert_same_program(gp, wp)
    assert_same_events(gp, wp)
    gp.validate()
    assert (pm.cache.hits, pm.cache.misses) == (rm.cache.hits,
                                                rm.cache.misses) == (2, 3)


def test_one_shot_kernel_backend_matches_reference_pallas():
    """``backend="kernel"``: the kernel's plain version here, the
    reference's Pallas kernel in interpret mode there; a hit runs
    neither."""
    inst = ref.sample_instance(TRACE, N=8, M=10, rates=RATES, delta=8.0,
                               seed=3)
    rm, pm = _one_shot_pair(inst)
    want, _ = rm.schedule_instance(inst, backend="pallas")
    got, hit = pm.schedule_instance(to_port(inst), backend="kernel")
    assert not hit
    assert_same_program(got, want)
    again, hit = pm.schedule_instance(to_port(inst), backend="kernel")
    assert hit
    assert_same_program(again, want)


def test_cache_hit_relabels_cids():
    inst = ref.sample_instance(TRACE, N=8, M=6, rates=RATES, delta=8.0,
                               seed=2)
    twin = ref.Instance(coflows=tuple(
        ref.Coflow(cid=c.cid + 100, demand=c.demand, weight=c.weight)
        for c in inst.coflows), rates=inst.rates, delta=inst.delta)
    dup = ref.Instance(coflows=tuple(
        ref.Coflow(cid=7, demand=c.demand, weight=c.weight)
        for c in inst.coflows), rates=inst.rates, delta=inst.delta)
    rm, pm = _one_shot_pair(inst)
    for i in (dup, inst, twin):
        (gp, ghit), (wp, whit) = (pm.schedule_instance(to_port(i)),
                                  rm.schedule_instance(i))
        assert ghit == whit
        assert_same_program(gp, wp)


def test_degraded_and_drifted_one_shot_match_reference():
    inst = ref.sample_instance(TRACE, N=8, M=10, rates=RATES, delta=8.0,
                               seed=3)
    p = to_port(inst)
    rm, pm = _one_shot_pair(inst)

    def both():
        (gp, ghit), (wp, whit) = (pm.schedule_instance(p),
                                  rm.schedule_instance(inst))
        assert ghit == whit
        assert_same_program(gp, wp)
        gp.validate()
        return ghit

    assert not both()
    for ev in (ref_fault.CoreDown(t=0.0, core=2),
               ref_fault.DeltaDrift(t=0.0, core=1, delta=40.0),
               ref_fault.CoreUp(t=0.0, core=2),
               ref_fault.DeltaDrift(t=0.0, core=1, delta=8.0)):
        assert_same_fault_report(pm.report_fault(to_port_event(ev)),
                                 rm.report_fault(ev))
        both()
        both()
    assert (pm.cache.hits, pm.cache.misses, pm.cache.purged) == \
        (rm.cache.hits, rm.cache.misses, rm.cache.purged)


def test_program_round_trip_and_tamper():
    oinst = ref_stream(N=10, M=12, seed=8, span=150.0)
    want = ref_service.compile_schedule(ref.run_fast_online(oinst))
    s = port.run_fast_online(to_port_online(oinst))
    program = port_service.compile_schedule(s)
    assert_same_program(program, want)
    assert_same_events(program, want)
    program.validate()
    sched = program.as_schedule()
    assert sorted(sched.ccts.tolist()) == sorted(s.ccts.tolist())
    bad = port_service.merge_programs([program, program], program.rates,
                                      program.delta, program.N)
    with pytest.raises(AssertionError, match="port exclusivity"):
        bad.validate()
    with pytest.raises(ValueError, match="different fabrics"):
        port_service.merge_programs([program], program.rates, 9.0, program.N)
    empty = port_service.merge_programs(
        [], torch.tensor(RATES, dtype=torch.float64), 8.0, 10)
    assert empty.device.type == "cpu"
    assert_same_program(empty, ref_service.merge_programs([], RATES, 8.0, 10))
    assert empty.n_segments == 0 and empty.makespan == 0.0
    assert list(empty.events()) == []


def test_empty_program_lies_with_its_rates_and_merges():
    oinst = ref_stream(N=10, M=12, seed=8, span=150.0)
    want = ref_service.compile_schedule(ref.run_fast_online(oinst))
    program = port_service.compile_schedule(
        port.run_fast_online(to_port_online(oinst)))
    empty = port_service.CircuitProgram.empty(program.rates, program.delta,
                                              program.N)
    assert empty.device == program.device
    merged = empty.merge(program)
    assert_same_program(merged, want)
    assert_same_program(
        merged, ref_service.CircuitProgram.empty(want.rates, want.delta,
                                                 want.N).merge(want))
    mgr = port_service.FabricManager(port_service.FabricConfig(
        rates=RATES, delta=8.0, N=10), device="cpu")
    assert mgr.program().device.type == "cpu"
    assert mgr.program().merge(program).n_segments == program.n_segments


def test_empty_program_without_device_tensors_is_cuda(monkeypatch):
    """Rates given as numbers put an empty program on CUDA, the port's
    default device, and raise where there is none: never a CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_service.CircuitProgram.empty(RATES, 8.0, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_service.merge_programs([], np.asarray(RATES), 8.0, 10)


def test_sweep_instances_is_the_ports_run_batch():
    insts = [to_port(ref.sample_instance(TRACE, N=8, M=8, rates=RATES,
                                         delta=8.0, seed=s)) for s in (1, 2)]
    pm = port_service.FabricManager(
        port_service.FabricConfig(rates=RATES, delta=8.0, N=8), device="cpu")
    got = pm.sweep_instances(insts, ("ours", "rho-assign"))
    want = port.run_batch(insts, ("ours", "rho-assign"))
    assert [dataclasses.replace(r, wall_s=0.0) for r in got] == \
        [dataclasses.replace(r, wall_s=0.0) for r in want]


def test_summary_of_an_idle_manager_matches_reference():
    rm, pm = manager_pair(rates=RATES, delta=8.0, N=12)
    assert_same_summary(pm, rm)
    assert pm.summary()["tent_reuse_fraction"] == 0.0
