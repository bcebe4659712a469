"""The offline engine's spans and the event loop's work counts, on the CPU.

``run_fast``, ``run_fast_online`` and ``run_fast_metrics`` open one
``fast/run`` span a call on the process-wide tracer, with a child span a
stage; ``fast/event_loop`` carries the loop's ``events``, ``tested`` and
``flows``, the compiled loop's ``visited``, ``unread`` and
``unreleased``, and which loop ran (``impl``). Tracing observes only: every schedule is bit for bit the
one the tracer-off run gives. While ``torch``'s profiler records, each
span is also a profiler range of its name, so the spans sit on the
profiler's clock.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as port
import repro_torch.core.engine as port_engine
from repro.obs.cli import validate_records
from repro_torch import obs
from repro_torch.kernels import _build

SCHEDULINGS = ("work-conserving", "priority-guard", "reserving", "sunflow")
ENTRIES = ("run_fast", "run_fast_online", "run_fast_metrics")
STAGES = {"fast/order", "fast/extract", "fast/assign", "fast/to_host",
          "fast/event_loop", "fast/to_device", "fast/schedule"}


def _instance(N=8, M=10, K=3, seed=5):
    trace = port.synth_fb_trace(120, seed=11)
    rates = [10.0, 20.0, 30.0] * ((K + 2) // 3)
    return port.sample_instance(trace, N=N, M=M, rates=rates[:K], delta=8.0,
                                seed=seed, device="cpu")


INST = _instance()
RELEASES = torch.arange(INST.M, dtype=torch.float64) * 40.0


def _compiled_impl():
    """``fast/event_loop``'s ``impl`` of the circuit event loop: compiled
    where a host compiler builds it."""
    try:
        _build.host_compiler()
    except RuntimeError:
        return "numpy"
    return "compiled"


def _call(entry, scheduling, backend):
    """The entry point's result as host arrays (what is compared bit for
    bit) and its flow count."""
    kw = dict(scheduling=scheduling, backend=backend)
    if entry == "run_fast_metrics":
        ccts, n = port.run_fast_metrics(INST, releases=RELEASES, **kw)
        return {"ccts": ccts.numpy()}, n
    if entry == "run_fast":
        s = port.run_fast(INST, **kw)
    else:
        s = port.run_fast_online(port.OnlineInstance(INST, RELEASES), **kw)
    return ({k: getattr(s, k).numpy() for k in ("t_establish", "core",
                                                 "ccts")}, s.n_flows)


def _traced(fn):
    tr = obs.Tracer()
    prev = obs.set_tracer(tr)
    try:
        out = fn()
    finally:
        obs.set_tracer(prev)
    return out, tr


def _spans(tr):
    return [r for r in tr.records if r["kind"] == "span"]


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("scheduling", SCHEDULINGS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_nest_under_one_run_and_schedules_stay_bitwise(entry,
                                                             scheduling,
                                                             backend):
    off, n_flows = _call(entry, scheduling, backend)
    (on, _), tr = _traced(lambda: _call(entry, scheduling, backend))
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)
    spans = _spans(tr)
    assert tr.open_spans == 0
    assert validate_records(tr.records) == []
    roots = [r for r in spans if r["parent"] is None]
    assert [r["name"] for r in roots] == ["fast/run"]
    root = roots[0]
    assert {r["name"] for r in spans} == STAGES | {"fast/run"}
    assert all(r["parent"] == root["sid"] and r["depth"] == 1
               for r in spans if r is not root)
    assert len(spans) == len(STAGES) + 1
    assert root["attrs"] == {
        "flows": n_flows, "coflows": INST.M, "K": INST.K, "backend": backend,
        "scheduling": scheduling, "online": entry != "run_fast",
        "metrics_only": entry == "run_fast_metrics"}
    by = {r["name"]: r for r in spans}
    assert by["fast/extract"]["attrs"] == {"flows": n_flows}
    assert by["fast/assign"]["attrs"] == {
        "path": "kernel" if backend == "kernel" else "host", "flows": n_flows}
    loop = by["fast/event_loop"]["attrs"]
    assert set(loop) == {"events", "tested", "flows", "impl"} | (
        {"visited", "unread", "unreleased"} if loop["impl"] == "compiled"
        else set())
    assert loop["impl"] == ("numpy" if scheduling == "reserving"
                            else _compiled_impl())
    assert loop["flows"] == n_flows
    assert loop["tested"] >= loop["flows"] and loop["events"] >= 1
    assert loop.get("visited", loop["tested"]) >= loop["tested"]
    assert loop.get("unread", 0) >= 0
    if entry == "run_fast" or scheduling == "sunflow":
        assert loop.get("unreleased", 0) == 0  # no row gated by a release
    elif scheduling != "reserving":  # at 0 only the first coflow is out
        assert loop["unreleased"] > 0
    assert (loop.get("visited", loop["tested"])
            >= loop["tested"] + loop.get("unreleased", 0))
    order = [r["name"] for r in sorted(spans, key=lambda r: r["ts"])]
    assert order == ["fast/run", "fast/order", "fast/extract", "fast/assign",
                     "fast/to_host", "fast/event_loop", "fast/to_device",
                     "fast/schedule"]


def test_a_drifted_run_names_its_assignment_path():
    delta_k = np.array([8.0, 3.0, 8.0])
    off = port.run_fast(INST, delta_k=delta_k)
    on, tr = _traced(lambda: port.run_fast(INST, delta_k=delta_k))
    assert torch.equal(on.t_establish, off.t_establish)
    assign = [r for r in _spans(tr) if r["name"] == "fast/assign"]
    assert assign[0]["attrs"]["path"] == "drifted"


def test_no_span_left_open_after_an_error_in_the_event_loop(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("loop failed")

    monkeypatch.setattr(port_engine, "_event_loop", broken)
    tr = obs.Tracer()
    prev = obs.set_tracer(tr)
    try:
        with pytest.raises(RuntimeError, match="loop failed"):
            port.run_fast(INST)
    finally:
        obs.set_tracer(prev)
    assert tr.open_spans == 0
    assert validate_records(tr.records) == []
    failed = {r["name"] for r in _spans(tr) if r.get("error")}
    assert failed == {"fast/event_loop", "fast/run"}


# -- the event loop's work counts -------------------------------------------

def _loop_case(flows, srv, n_ports, K, guard):
    """``_event_loop`` over hand-made flows ``(core, i, j)`` in priority
    order, delta 1; ``(t_est, stats)``."""
    core = np.array([f[0] for f in flows], dtype=np.int64)
    rin = core * n_ports + np.array([f[1] for f in flows], dtype=np.int64)
    rout = core * n_ports + np.array([f[2] for f in flows], dtype=np.int64)
    stats = {}
    t_est = port_engine._event_loop(rin, rout, np.asarray(srv, float), core,
                                    1.0, K * n_ports, n_ports, guard=guard,
                                    stats=stats)
    return t_est, stats


@pytest.mark.parametrize("guard", [False, True])
def test_counts_of_three_flows_on_one_ingress_port(guard):
    """Core 0 has three flows on ingress port 0 (egress 0, 1, 2), core 1
    one. At 0 the first of core 0 and core 1's flow start (4 tested); core
    0's port frees at 2 (one flow starts), core 1's at 3 (no pending flow
    uses it), core 0's again at 5 (the last). The guard tests and reads
    its pending rows, 4 + 2 + 0 + 1. Work-conserving stops reading a list
    at the row that takes its port: at 2 ingress 0's list is read up to
    0->1 (2 rows, 1 tested), leaving 0->2 unread, and egress 0's 1 row;
    then 1 + 1 rows at 3 and 1 + 1 at 5 (1 tested), so 4 + 1 + 0 + 1
    tested and 4 + 3 + 2 + 2 read."""
    t_est, stats = _loop_case([(0, 0, 0), (0, 0, 1), (0, 0, 2), (1, 0, 0)],
                              [1.0, 2.0, 3.0, 2.0], n_ports=3, K=2,
                              guard=guard)
    np.testing.assert_array_equal(t_est, [0.0, 2.0, 5.0, 0.0])
    assert stats == ({"events": 4, "tested": 7, "flows": 4, "visited": 7,
                      "unread": 0, "unreleased": 0} if guard else
                     {"events": 4, "tested": 6, "flows": 4, "visited": 11,
                      "unread": 1, "unreleased": 0})


@pytest.mark.parametrize("guard,t_want,counts", [
    (False, [0.0, 2.0, 0.0],
     {"events": 2, "tested": 4, "flows": 3, "visited": 9, "unread": 0,
      "unreleased": 0}),
    (True, [0.0, 2.0, 4.0],
     {"events": 3, "tested": 6, "flows": 3, "visited": 6, "unread": 0,
      "unreleased": 0})])
def test_counts_where_the_guard_holds_a_port(guard, t_want, counts):
    """Flows 0->0, 0->1, 1->1 on one core, each 1 long. Work-conserving
    backfills 1->1 at 0 (3 tested), then at 2 tests the one left on
    ingress 0's list, reading all four lists the two completions free
    (2 + 1 + 1 + 2 rows: egress 1's passes 0->1 untested, as ingress 0's
    tests it); the guard keeps 1->1 off egress 1, which 0->1 holds, so it
    tests both at 2 and the last again at 4, reading only its pending
    rows."""
    t_est, stats = _loop_case([(0, 0, 0), (0, 0, 1), (0, 1, 1)],
                              [1.0, 1.0, 1.0], n_ports=2, K=1, guard=guard)
    np.testing.assert_array_equal(t_est, t_want)
    assert stats == counts


@pytest.mark.parametrize("scheduling", ["work-conserving", "priority-guard"])
def test_counts_bound_the_work_of_a_plan_m48_shaped_instance(scheduling):
    """48 trace coflows on 16 cores at N=16: every flow is started once,
    the loop wakes at least at every distinct establishment time, and at
    least every started flow was tested."""
    inst = port.sample_instance(port.synth_fb_trace(526, seed=2026), N=16,
                                M=48, rates=[10.0, 20.0, 30.0] * 5 + [10.0],
                                delta=8.0, seed=2 ** 31 + 7, device="cpu")
    s, tr = _traced(lambda: port.run_fast(inst, scheduling=scheduling))
    loop = next(r for r in _spans(tr) if r["name"] == "fast/event_loop")
    n = loop["attrs"]
    assert n["flows"] == s.n_flows > 0
    assert n["events"] >= np.unique(s.t_establish.numpy()).size
    assert n["tested"] >= n["flows"]
    assert n["visited"] >= n["tested"]
    assert n["unreleased"] == 0


def test_a_started_row_is_read_once_more_on_its_list():
    """One core of 3 ports, work-conserving. 1->1 starts at 0 (until 11)
    and holds egress 1, so 0->1 waits and 0->0, behind it on ingress 0,
    starts at 0 (until 2). At 2 ingress 0's list [0->1, 0->0, 0->2] is
    read whole and 0->2 starts (until 4); the event drops 0->0 and 0->2
    from the part it read, so at 4 the list is [0->1], and neither is read
    on it again (0->2 is read once more, on egress 2's list). Rows read: 4
    at 0; 3 + 1 at 2; 1 + 1 at 4; 1 + 2 at 11, where 0->1 starts."""
    t_est, stats = _loop_case([(0, 1, 1), (0, 0, 1), (0, 0, 0), (0, 0, 2)],
                              [10.0, 1.0, 1.0, 1.0], n_ports=3, K=1,
                              guard=False)
    np.testing.assert_array_equal(t_est, [0.0, 11.0, 0.0, 2.0])
    assert stats == {"events": 4, "tested": 8, "flows": 4, "visited": 13,
                     "unread": 0, "unreleased": 0}


def test_sunflow_adds_its_groups_counts(monkeypatch):
    """``_sunflow_times`` hands one dict to every group's loop, so the
    counts are the sums of the groups' own."""
    own = []
    loop = port_engine._event_loop

    def counted(*a, stats=None, **k):
        mine = {}
        out = loop(*a, stats=mine, **k)
        own.append(mine)
        port_engine._add_counts(stats, mine["events"], mine["tested"],
                                mine["flows"], mine["visited"],
                                mine["unread"], mine["unreleased"])
        return out

    monkeypatch.setattr(port_engine, "_event_loop", counted)
    s, tr = _traced(lambda: port.run_fast(INST, scheduling="sunflow"))
    loop_attrs = next(r for r in _spans(tr)
                      if r["name"] == "fast/event_loop")["attrs"]
    assert len(own) > 1
    assert loop_attrs == {**{k: sum(c[k] for c in own)
                             for k in ("events", "tested", "flows",
                                       "visited", "unread", "unreleased")},
                          "impl": _compiled_impl()}
    assert loop_attrs["flows"] == s.n_flows


def test_reserving_counts_one_reservation_a_flow():
    s, tr = _traced(lambda: port.run_fast(INST, scheduling="reserving"))
    loop = next(r for r in _spans(tr) if r["name"] == "fast/event_loop")
    assert loop["attrs"] == {"events": s.n_flows, "tested": s.n_flows,
                             "flows": s.n_flows, "impl": "numpy"}


# -- one clock with the profiler ---------------------------------------------

def _host_ranges(prof):
    """(name, start ns, end ns) of every host range of the profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("fast/"):
            out.append((ev.name(), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    return out


def test_every_span_is_a_profiler_range_nested_as_the_records():
    tr = obs.Tracer()
    prev = obs.set_tracer(tr)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            port.run_fast(INST)
    finally:
        obs.set_tracer(prev)
    spans = sorted(_spans(tr), key=lambda r: r["ts"])
    ranges = sorted(_host_ranges(prof), key=lambda r: r[1])
    assert [r[0] for r in ranges] == [r["name"] for r in spans]
    rng = {r["sid"]: g for r, g in zip(spans, ranges)}
    for r in spans:
        if r["parent"] is None:
            continue
        _, s, e = rng[r["sid"]]
        _, ps, pe = rng[r["parent"]]
        assert ps <= s and e <= pe, r["name"]


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    _traced(lambda: port.run_fast(INST))
    assert opened == []


def test_ranges_still_close_in_order_under_the_benchmarks_prof_tracer():
    """``perfbench/obs.py::prof_tracer`` opens a range of its own after each
    span opens and closes it after the span's record: the span's own range
    nests inside it, so no two host ranges of the profile cross."""
    from perfbench.obs import prof_tracer

    tr = prof_tracer()
    prev = obs.set_tracer(tr)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            port.run_fast(INST)
    finally:
        obs.set_tracer(prev)
    assert tr.open_spans == 0
    ranges = _host_ranges(prof)
    assert sorted(r[0] for r in ranges) == sorted(
        [r["name"] for r in _spans(tr)] * 2)
    for _, s0, e0 in ranges:
        for _, s1, e1 in ranges:
            assert not (s0 < s1 < e0 < e1)
