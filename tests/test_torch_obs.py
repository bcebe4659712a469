"""The port's observability plane (``repro_torch.obs``) vs the reference's,
on the CPU.

The tracer records the same spans, with the same names, nesting and
attributes, for the same drive of the fabric manager as the reference's;
the reference's own schema check (``repro.obs.cli.validate_records``, what
``python -m repro.obs validate`` runs) accepts a port trace; the metrics
instruments give the reference's snapshots; and the schedule is identical
with tracing on and off, with faults too.
"""
import json

import numpy as np
import pytest
import torch

import repro.core.fault as ref_fault
import repro.obs as ref_obs
import repro.service as ref_service
import repro_torch.obs as obs
import repro_torch.obs.trace as port_trace
import repro_torch.service as port_service
from repro.obs.cli import load_trace, main as obs_cli, phase_stats, \
    validate_records
from test_torch_fabric import RATES, ref_stream, to_port_coflow, to_port_event

FABRIC_PHASES = {"tick", "tick/admit", "tick/assign", "tick/splice",
                 "tick/event_loop", "tick/program_emit"}


def _drive(mgr, oinst, n_ticks=6, fault_after=None, fault=None, port=True):
    """tests/test_obs.py's drive: submit in release order, tick, flush."""
    order = np.argsort(oinst.releases, kind="stable")
    rel = oinst.releases
    hi = float(rel.max())
    ticks = np.linspace(hi / n_ticks, hi, n_ticks) if hi > 0 else [0.0]
    nxt = 0
    for i, T in enumerate(ticks):
        while nxt < order.size and rel[order[nxt]] <= T:
            m = int(order[nxt])
            c = oinst.inst.coflows[m]
            mgr.submit(to_port_coflow(c) if port else c, float(rel[m]))
            nxt += 1
        mgr.tick(float(T))
        if fault_after == i:
            mgr.report_fault(to_port_event(fault) if port else fault)
    mgr.flush()


def _port_manager(tracer=None, **cfg):
    return port_service.FabricManager(
        port_service.FabricConfig(rates=RATES, delta=8.0, N=10, **cfg),
        tracer=tracer, device="cpu")


def _program_tuple(mgr):
    p = mgr.program()
    return tuple(getattr(p, a).tolist() for a in (
        "cid", "ingress", "egress", "core", "t_establish", "t_complete"))


def _shape(records):
    """Everything of a trace but its clock readings."""
    return [(r["kind"], r["name"], r["sid"], r["parent"], r["depth"],
             r["attrs"], r.get("error")) for r in records]


# ---------------------------------------------------------------------------
# tracer semantics
# ---------------------------------------------------------------------------

def test_tracer_nesting_and_record_shape():
    tr = obs.Tracer()
    with tr.span("tick") as outer:
        outer.set(tick=1)
        with tr.span("tick/admit") as inner:
            assert inner.depth == 1 and inner.parent == outer.sid
        tr.event("cache/miss", key="abc")
    assert tr.open_spans == 0
    assert [(r["kind"], r["name"], r["depth"]) for r in tr.records] == [
        ("span", "tick/admit", 1), ("event", "cache/miss", 1),
        ("span", "tick", 0)]
    root = tr.records[-1]
    assert root["parent"] is None and root["attrs"] == {"tick": 1}
    assert root["dur"] >= 0
    assert validate_records(tr.records) == []


def test_span_closes_and_flags_error_on_exception():
    for mod in (ref_obs, obs):
        tr = mod.Tracer()
        with pytest.raises(RuntimeError):
            with tr.span("tick"):
                with tr.span("tick/assign"):
                    raise RuntimeError("boom")
        assert tr.open_spans == 0
        assert [r["name"] for r in tr.records] == ["tick/assign", "tick"]
        assert all(r.get("error") is True for r in tr.records)
        assert validate_records(tr.records) == []


def test_null_tracer_is_the_shared_noop_singleton():
    assert isinstance(obs.NULL_TRACER, obs.NullTracer)
    sp = obs.NULL_TRACER.span("tick")
    assert sp is port_trace.NULL_SPAN and sp is obs.NULL_TRACER.span("other")
    assert sp.live is False and sp.set(x=1) is sp
    with sp:
        pass
    obs.NULL_TRACER.event("cache/hit", key="k")
    obs.NULL_TRACER.flush()
    assert obs.NULL_TRACER.records == [] and obs.NULL_TRACER.open_spans == 0


def test_set_tracer_round_trip():
    tr = obs.Tracer()
    assert obs.current_tracer() is obs.NULL_TRACER
    prev = obs.set_tracer(tr)
    try:
        assert prev is obs.NULL_TRACER and obs.current_tracer() is tr
        mgr = port_service.FabricManager(
            port_service.FabricConfig(rates=RATES, delta=8.0, N=4),
            device="cpu")
        mgr.tick(1.0)
        assert any(r["name"] == "tick" for r in tr.records)
    finally:
        assert obs.set_tracer(None) is tr
    assert obs.current_tracer() is obs.NULL_TRACER


def test_a_recording_span_ends_in_a_device_synchronise(monkeypatch):
    """A span closing on pending CUDA work waits for it; the disabled
    tracer never synchronises."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    with obs.NULL_TRACER.span("tick"):
        pass
    assert calls == []
    tr = obs.Tracer()
    with tr.span("tick"):
        with tr.span("tick/assign"):
            pass
    assert len(calls) == 4  # one at each span's open, one at each end


def test_a_recording_span_opens_on_a_device_synchronise(monkeypatch):
    """Device work queued before a span opens (by its parent's own code)
    is waited for before the span reads the clock, so it is not charged
    to the span."""
    log = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: log.append("sync"))
    monkeypatch.setattr(port_trace, "now", lambda: log.append("clock") or 0.0)
    tr = obs.Tracer()
    with tr.span("tick"):
        log.append("work")
    assert log == ["sync", "clock", "work", "sync", "clock"]


def test_jsonl_sink_chrome_export_and_the_reference_validator(tmp_path):
    sink = tmp_path / "trace.jsonl"
    with obs.Tracer(sink) as tr:
        with tr.span("tick") as sp:
            sp.set(bad=float("inf"), arr=np.float64(2.5), obj=object())
            tr.event("cache/purge", count=3)
    records = load_trace(sink)
    assert validate_records(records) == []
    span = next(r for r in records if r["kind"] == "span")
    assert span["attrs"]["bad"] == "inf" and span["attrs"]["arr"] == 2.5
    assert isinstance(span["attrs"]["obj"], str)
    doc = tr.to_chrome_trace()
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i"}
    assert doc["displayTimeUnit"] == "ms"
    assert doc == ref_obs.to_chrome_trace(tr.records)
    assert obs_cli(["validate", str(sink)]) == 0


# ---------------------------------------------------------------------------
# metrics semantics
# ---------------------------------------------------------------------------

def _exercise(mod):
    reg = mod.MetricsRegistry()
    assert reg.counter("a.b") is reg.counter("a.b")
    reg.counter("a.b").inc(5)
    reg.counter("a.b").inc(-2)
    reg.gauge("g").set(1.5)
    h = reg.histogram("lat", window=4)
    for v in [1.0, 2.0, 3.0, 4.0, 5.0, 6.5]:
        h.observe(v)
    reg.histogram("empty")
    return reg.snapshot(), (h.coverage, h.total, h.quantile(0.0),
                            h.quantile(1.0), h.mean())


def test_metrics_snapshots_equal_the_references():
    assert _exercise(obs) == _exercise(ref_obs)
    snap, (coverage, total, lo, hi, _mean) = _exercise(obs)
    assert snap["a.b"] == 3 and snap["lat.n_observed"] == 6
    assert coverage == pytest.approx(4 / 6) and (lo, hi) == (3.0, 6.5)


# ---------------------------------------------------------------------------
# the differential gates: tracing on == off, and the reference's spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_stream_bit_identical_with_tracing(seed):
    oinst = ref_stream(seed=seed)
    off = _port_manager()
    tr = obs.Tracer()
    on = _port_manager(tracer=tr)
    _drive(off, oinst)
    _drive(on, oinst)
    assert torch.equal(off.ccts(), on.ccts())
    assert _program_tuple(off) == _program_tuple(on)
    assert validate_records(tr.records) == []
    assert tr.open_spans == 0
    assert FABRIC_PHASES <= set(phase_stats(tr.records))


@pytest.mark.parametrize("with_fault", [False, True])
def test_spans_and_attributes_equal_the_references(with_fault):
    """Same drive, same trace: names, nesting and every attribute (the
    attributes are counts, never clock readings)."""
    oinst = ref_stream(M=24, seed=4, span=400.0)
    fault = ref_fault.CoreDown(t=float(oinst.releases.max()) / 2 + 0.5,
                               core=2) if with_fault else None
    kw = dict(fault_after=2 if with_fault else None, fault=fault)
    rtr, ptr = ref_obs.Tracer(), obs.Tracer()
    rm = ref_service.FabricManager(
        ref_service.FabricConfig(rates=RATES, delta=8.0, N=10), tracer=rtr)
    pm = _port_manager(tracer=ptr)
    _drive(rm, oinst, port=False, **kw)
    _drive(pm, oinst, **kw)
    assert _shape(ptr.records) == _shape(rtr.records)
    assert validate_records(ptr.records) == []
    recov = [r for r in ptr.records if r["name"] == "fault/recover"]
    assert len(recov) == int(with_fault)


def test_fault_injected_stream_bit_identical_with_tracing():
    oinst = ref_stream(M=24, seed=4, span=400.0)
    fault = ref_fault.CoreDown(t=float(oinst.releases.max()) / 2 + 0.5,
                               core=2)
    off = _port_manager()
    tr = obs.Tracer()
    on = _port_manager(tracer=tr)
    _drive(off, oinst, fault_after=2, fault=fault)
    _drive(on, oinst, fault_after=2, fault=fault)
    assert torch.equal(off.ccts(), on.ccts())
    assert _program_tuple(off) == _program_tuple(on)
    noisy = {k for k in off.summary()
             if "wall" in k or "latency" in k or "per_s" in k}
    assert {k: v for k, v in off.summary().items() if k not in noisy} == \
        {k: v for k, v in on.summary().items() if k not in noisy}


def test_cache_traffic_emits_events_and_counters():
    from test_torch_online import to_port_online

    oinst = to_port_online(ref_stream(M=8, seed=5))
    tr = obs.Tracer()
    mgr = _port_manager(tracer=tr)
    _, hit0 = mgr.schedule_instance(oinst)
    _, hit1 = mgr.schedule_instance(oinst)
    assert (hit0, hit1) == (False, True)
    events = [r["name"] for r in tr.records if r["kind"] == "event"]
    assert events.count("cache/miss") == 1 and events.count("cache/hit") == 1
    assert mgr.metrics.snapshot()["cache.hits"] == 1


def test_trace_well_formed_under_backpressure_and_bad_fault(tmp_path):
    tr = obs.Tracer(tmp_path / "t.jsonl")
    mgr = port_service.FabricManager(
        port_service.FabricConfig(rates=RATES, delta=8.0, N=4,
                                  max_queue_depth=2), tracer=tr, device="cpu")
    from repro_torch.core import Coflow, CoreDown

    c = Coflow(cid=0, demand=torch.eye(4, dtype=torch.float64))
    mgr.submit(c, 0.5)
    mgr.submit(c, 0.6)
    with pytest.raises(port_service.BackpressureError):
        mgr.submit(c, 0.7)
    mgr.tick(1.0)
    with pytest.raises(ValueError):
        mgr.report_fault(CoreDown(t=0.0, core=99))
    assert tr.open_spans == 0 and validate_records(tr.records) == []
    recov = [r for r in tr.records if r["name"] == "fault/recover"]
    assert len(recov) == 1 and recov[0].get("error") is True
    mgr.flush()
    tr.close()
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == \
        [r["name"] for r in tr.records]
