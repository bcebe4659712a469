"""The port's offline engine and referee vs the reference, on the CPU.

``repro_torch.core.run_fast`` is the port of ``repro.core.run_fast``: under
``backend="numpy"`` (the default, as in the reference) the fp64 host
backend, as the reference's ``"numpy"``; under ``backend="kernel"`` the fp32
tau-aware choices of the kernel's plain version, as the reference's
``"pallas"``. The event loops are the reference's, so choices, establishment
times and CCTs must be bit-identical for all five algorithms and all four
scheduling policies; the weighted sum and the tail quantiles are reduced by
numpy on the host, as the reference reduces them, so they are equal too.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.engine as ref_engine
import repro_torch.core as port
import repro_torch.core.engine as port_engine
from repro.core.circuit_scheduler import ScheduledFlow
from test_engine_differential import _random_instance
from test_torch_coflow import to_port

POLICIES = ("work-conserving", "priority-guard", "reserving")
#: (algorithm, scheduling) of the whole grid: the sunflow baselines once.
POINTS = [(a, s) for a in ref.ALGORITHMS
          for s in (("sunflow",) if "sunflow" in a else POLICIES)]
TRIALS = (1, 4, 9, 13, 22, 37)


def _trace_instance():
    trace = ref.synth_fb_trace(200, seed=7)
    return ref.sample_instance(trace, N=16, M=60, rates=[10, 20, 30],
                               delta=8.0, seed=3)


INSTANCES = [_random_instance(t) for t in TRIALS] + [_trace_instance()]
IDS = [f"trial{t}" for t in TRIALS] + ["trace"]


def _flat(s):
    """Reference Schedule rows as arrays, in their own (core-major) order."""
    cols = ("coflow", "cid", "i", "j", "core", "size", "t_establish",
            "t_start", "t_complete")
    return {c: np.array([getattr(f, c) for f in s.flows]) for c in cols}


def assert_same_schedule(got: "port.Schedule", want: "ref.Schedule",
                         msg: str = "") -> None:
    """Every row and CCT of a port schedule equals the reference's."""
    w = _flat(want)
    for col, t in (("coflow", got.pos), ("cid", got.cid), ("i", got.fi),
                   ("j", got.fj), ("core", got.core), ("size", got.size),
                   ("t_establish", got.t_establish), ("t_start", got.t_start),
                   ("t_complete", got.t_complete)):
        np.testing.assert_array_equal(t.numpy(), w[col],
                                      err_msg=f"{msg}: {col}")
    np.testing.assert_array_equal(got.pi.numpy(), want.pi, err_msg=msg)
    np.testing.assert_array_equal(got.ccts.numpy(), want.ccts, err_msg=msg)


def to_reference(s: "port.Schedule", inst: "ref.Instance") -> "ref.Schedule":
    """A port schedule as a reference ``Schedule`` over ``inst``."""
    rows = zip(*(t.tolist() for t in (
        s.pos, s.cid, s.fi, s.fj, s.core, s.size, s.t_establish, s.t_start,
        s.t_complete)))
    flows = [ScheduledFlow(coflow=p, cid=c, i=i, j=j, core=k, size=z,
                           t_establish=te, t_start=ts, t_complete=tc)
             for p, c, i, j, k, z, te, ts, tc in rows]
    return ref.Schedule(inst=inst, pi=s.pi.numpy(), assignment=None,
                        flows=flows, ccts=s.ccts.numpy())


@pytest.mark.parametrize("idx", range(len(INSTANCES)), ids=IDS)
def test_event_loops_match_reference_on_its_flow_table(idx):
    """Fed the reference's own FlowTable, the port's host loops give
    bit-identical establishment times under all three policies."""
    inst = INSTANCES[idx]
    table = ref_engine.build_flow_table(inst, ref.order_coflows(inst), "ours")
    K, N = inst.K, inst.N
    rin = table.core * N + table.fi
    rout = table.core * N + table.fj
    srv = table.size / inst.rates[table.core]
    for guard in (False, True):
        want = ref_engine._event_loop(rin, rout, srv, table.core, inst.delta,
                                      K * N, N, guard=guard)
        got = port_engine._event_loop(rin, rout, srv, table.core, inst.delta,
                                      K * N, N, guard=guard)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        port_engine._reserving_times(rin, rout, srv, inst.delta, K * N),
        ref_engine._reserving_times(rin, rout, srv, inst.delta, K * N))


@pytest.mark.parametrize("idx", range(len(INSTANCES)), ids=IDS)
def test_run_fast_and_metrics_match_reference_pallas_backend(idx):
    inst = INSTANCES[idx]
    p = to_port(inst)
    for scheduling in POLICIES:
        want = ref.run_fast(inst, "ours", scheduling=scheduling,
                            backend="pallas")
        got = port.run_fast(p, scheduling=scheduling, backend="kernel")
        assert_same_schedule(got, want, scheduling)
        ccts, n_flows = port.run_fast_metrics(p, scheduling=scheduling,
                                              backend="kernel")
        assert n_flows == len(want.flows)
        np.testing.assert_array_equal(ccts.numpy(), want.ccts)
        assert port.weighted_cct(got) == ref.weighted_cct(want)
        for q in (0.5, 0.95, 0.99):
            assert port.tail_cct(got, q) == ref.tail_cct(want, q)
        port.validate(got)
        ref.validate(to_reference(got, inst))


def _moved(s, f, dt):
    """Schedule ``s`` with flow ``f``'s circuit shifted by ``dt``."""
    def shift(t):
        t = t.clone()
        t[f] += dt
        return t
    return dataclasses.replace(s, t_establish=shift(s.t_establish),
                               t_start=shift(s.t_start),
                               t_complete=shift(s.t_complete))


def test_validate_raises_on_overlap_and_wrong_duration():
    inst = INSTANCES[-1]
    s = port.run_fast(to_port(inst), backend="kernel")
    port.validate(s)
    # two flows on one core's ingress port: move the later one onto the
    # earlier one's start, keeping its own timing consistent
    rid = (s.core * inst.N + s.fi).tolist()
    seen = {}
    for f, r in enumerate(rid):
        if r in seen:
            a, b = seen[r], f
            break
        seen[r] = f
    overlap = _moved(s, b, float(s.t_establish[a] - s.t_establish[b]))
    with pytest.raises(AssertionError, match="port exclusivity"):
        port.validate(overlap)
    with pytest.raises(AssertionError, match="port exclusivity"):
        ref.validate(to_reference(overlap, inst))

    t_complete = s.t_complete.clone()
    t_complete[7] += 1.0
    late = dataclasses.replace(s, t_complete=t_complete)
    with pytest.raises(AssertionError, match="non-preemptive duration"):
        port.validate(late)
    with pytest.raises(AssertionError, match="non-preemptive duration"):
        ref.validate(to_reference(late, inst))


def test_validate_raises_on_lost_demand_and_wrong_cct():
    inst = INSTANCES[0]
    s = port.run_fast(to_port(inst), backend="kernel")
    # drop a flow that does not finish its coflow: only conservation breaks
    last = s.ccts[s.pi[s.pos]]
    f = int(torch.nonzero(s.t_complete < last)[0, 0])
    keep = torch.arange(s.n_flows) != f
    fields = ("pos", "cid", "fi", "fj", "core", "size", "t_establish",
              "t_start", "t_complete")
    lost = dataclasses.replace(s, **{k: getattr(s, k)[keep] for k in fields})
    with pytest.raises(AssertionError, match="demand conservation"):
        port.validate(lost)
    with pytest.raises(AssertionError, match="demand conservation"):
        ref.validate(to_reference(lost, inst))
    ccts = s.ccts.clone()
    ccts[0] += 1.0
    with pytest.raises(AssertionError, match="CCTs inconsistent"):
        port.validate(dataclasses.replace(s, ccts=ccts))


def test_unported_options_raise_and_unknown_inputs_are_rejected():
    """Bad inputs raise ``ValueError`` as in the reference. The options
    once unported run: ``check="oracle"`` (item 8) gives the rows of
    ``check="validate"``, and ``workers=2`` (item 4, a spawn pool) the
    serial rows but for ``wall_s``."""
    p = to_port(INSTANCES[0])
    oracle = port.run_batch([p], check="oracle")
    plain = port.run_batch([p], check="validate")
    assert [r.weighted_cct for r in oracle] == [r.weighted_cct for r in plain]
    pooled = port.run_batch([p], workers=2, check="oracle")
    assert [dataclasses.replace(r, wall_s=0.0) for r in pooled] == \
        [dataclasses.replace(r, wall_s=0.0) for r in oracle]
    with pytest.raises(ValueError, match="unknown algorithm"):
        port.run_fast(p, "nope")
    with pytest.raises(ValueError, match="unknown scheduling"):
        port.run_fast(p, scheduling="nope")
    with pytest.raises(ValueError, match="unknown backend"):
        port.run_fast(p, backend="pallas")
    with pytest.raises(ValueError, match="delta_k must have shape"):
        port.run_fast(p, delta_k=np.ones(p.K + 1))
    with pytest.raises(ValueError, match="drifted delta must be >= 0"):
        port.run_fast(p, delta_k=np.full(p.K, -1.0))
    with pytest.raises(ValueError, match="locality"):
        port.run_fast(p, locality=-1.0, backend="numpy")


@pytest.mark.parametrize("idx", range(len(INSTANCES)), ids=IDS)
def test_run_fast_numpy_backend_matches_reference(idx):
    """All five algorithms x their policies on the fp64 host backend."""
    inst = INSTANCES[idx]
    p = to_port(inst)
    for alg, sched in POINTS:
        kw = dict(seed=idx, scheduling=sched, backend="numpy")
        want = ref.run_fast(inst, alg, **kw)
        got = port.run_fast(p, alg, **kw)
        assert_same_schedule(got, want, f"{alg} {sched}")
        ccts, n_flows = port.run_fast_metrics(p, alg, **kw)
        np.testing.assert_array_equal(ccts.numpy(), want.ccts)
        assert n_flows == len(want.flows)
        assert port.weighted_cct(got) == ref.weighted_cct(want)
        for q in (0.95, 0.99):
            assert port.tail_cct(got, q) == ref.tail_cct(want, q)
        port.validate(got)


@pytest.mark.parametrize("idx", [0, 3, len(INSTANCES) - 1])
def test_run_fast_kernel_backend_matches_reference_pallas(idx):
    """Every algorithm under ``backend="kernel"``: the tau-aware ones through
    the kernel's plain version (the reference's Pallas kernel in interpret
    mode), the others on the host backend, as in the reference."""
    inst = INSTANCES[idx]
    p = to_port(inst)
    for alg, sched in POINTS:
        want = ref.run_fast(inst, alg, seed=idx, scheduling=sched,
                            backend="pallas")
        got = port.run_fast(p, alg, seed=idx, scheduling=sched,
                            backend="kernel")
        assert_same_schedule(got, want, f"{alg} {sched}")


def test_run_fast_kernel_backend_matches_reference_pallas_at_16_cores():
    """K = 16 (the lanes kernel's K on the card): the trace's rates repeated,
    so equal-rate cores tie exactly and the ties go to the lowest core, as
    in the reference's Pallas kernel in interpret mode."""
    trace = ref.synth_fb_trace(200, seed=7)
    inst = ref.sample_instance(trace, N=16, M=30,
                               rates=np.resize([10.0, 20.0, 30.0], 16),
                               delta=8.0, seed=3)
    assert inst.K == 16
    p = to_port(inst)
    for alg, sched in POINTS:
        want = ref.run_fast(inst, alg, seed=5, scheduling=sched,
                            backend="pallas")
        got = port.run_fast(p, alg, seed=5, scheduling=sched,
                            backend="kernel")
        assert_same_schedule(got, want, f"{alg} {sched}")
        port.validate(got)


@pytest.mark.parametrize("idx", range(len(INSTANCES)), ids=IDS)
def test_drift_and_locality_match_reference(idx):
    """``delta_k`` (drifted, and all-nominal, which must normalize to the
    undrifted floats) and ``locality > 0`` on every point of the grid."""
    inst = INSTANCES[idx]
    p = to_port(inst)
    drifted = np.full(inst.K, inst.delta)
    drifted[0] = inst.delta * 2 + 1.5
    for alg, sched in POINTS:
        for kw in (dict(delta_k=drifted), dict(delta_k=np.full(inst.K,
                                                               inst.delta)),
                   dict(locality=0.75)):
            want = ref.run_fast(inst, alg, seed=idx, scheduling=sched, **kw)
            got = port.run_fast(p, alg, seed=idx, scheduling=sched, **kw)
            assert_same_schedule(got, want, f"{alg} {sched} {kw}")
            dk = kw.get("delta_k")
            port.validate(got, flow_delta=None if dk is None
                          else dk[got.core.numpy()])
    assert port_engine._normalize_delta_k(p, np.full(p.K, p.delta)) is None
    plain = port.run_fast(p, backend="numpy")
    nominal = port.run_fast(p, backend="numpy",
                            delta_k=torch.full((inst.K,), inst.delta,
                                               dtype=torch.float64))
    assert torch.equal(plain.t_complete, nominal.t_complete)


@pytest.mark.parametrize("idx", range(len(INSTANCES)), ids=IDS)
def test_release_drift_and_sunflow_loops_match_reference(idx):
    """The host loops' online and drifted arguments, fed the reference's
    own flow table: ``t0``, ``release``, per-flow delays, and
    ``_sunflow_times`` offline and online."""
    inst = INSTANCES[idx]
    table = ref_engine.build_flow_table(inst, ref.order_coflows(inst), "ours")
    K, N = inst.K, inst.N
    rin = table.core * N + table.fi
    rout = table.core * N + table.fj
    srv = table.size / inst.rates[table.core]
    rng = np.random.default_rng(idx)
    rel = rng.uniform(0, 50, table.n_flows).round(1)
    d_f = rng.uniform(0, 10, table.n_flows)
    for guard in (False, True):
        for kw in (dict(t0=7.5), dict(release=rel), dict(release=rel, t0=3.0)):
            for dl in (inst.delta, d_f):
                np.testing.assert_array_equal(
                    port_engine._event_loop(rin, rout, srv, table.core, dl,
                                            K * N, N, guard=guard, **kw),
                    ref_engine._event_loop(rin, rout, srv, table.core, dl,
                                           K * N, N, guard=guard, **kw))
    for dl in (inst.delta, d_f):
        np.testing.assert_array_equal(
            port_engine._reserving_times(rin, rout, srv, dl, K * N,
                                         release=rel),
            ref_engine._reserving_times(rin, rout, srv, dl, K * N,
                                        release=rel))
    prio = rng.permutation(inst.M)[table.pos]
    rel_c = rng.uniform(0, 50, inst.M)[table.pos]
    dk = rng.uniform(0, 10, K)
    for kw in (dict(), dict(delta_k=dk), dict(release=rel_c, prio=prio),
               dict(release=rel_c, prio=prio, delta_k=dk)):
        np.testing.assert_array_equal(
            port_engine._sunflow_times(table.pos, table.core, table.fi,
                                       table.fj, table.size, rin, rout, srv,
                                       inst.delta, N, K, **kw),
            ref_engine._sunflow_times(table, rin, rout, srv, inst.delta, N, K,
                                      **kw))


def test_backend_choice_is_the_references_three_way_choice(monkeypatch):
    """The kernel serves tau-aware runs under ``backend="kernel"`` without
    drift or locality, and nothing else; no fallback in either direction.
    The default backend is the reference's, ``"numpy"``: no kernel."""
    p = to_port(INSTANCES[-1])
    calls = []
    real = port_engine.coflow_assign
    monkeypatch.setattr(port_engine, "coflow_assign",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    drifted = np.full(p.K, p.delta)
    drifted[1] += 4.0
    kernel = dict(backend="kernel")
    for alg, kw, n in (
            ("ours", kernel, 1), ("sunflow-core", kernel, 1),
            ("ours", dict(delta_k=np.full(p.K, p.delta), **kernel), 1),
            ("ours", dict(backend="numpy"), 0), ("ours", {}, 0),
            ("sunflow-core", {}, 0),
            ("ours", dict(locality=0.5, **kernel), 0),
            ("ours", dict(delta_k=drifted, **kernel), 0),
            ("sunflow-core", dict(delta_k=drifted, **kernel), 0),
            ("rho-assign", kernel, 0), ("rand-assign", kernel, 0),
            ("rand-sunflow", kernel, 0)):
        calls.clear()
        port.run_fast(p, alg, **kw)
        assert len(calls) == n, (alg, kw)
    online = port.OnlineInstance(inst=p, releases=np.zeros(p.M))
    calls.clear()
    port.run_fast_online(online, backend="kernel")
    assert len(calls) == 1
    calls.clear()
    port.run_fast_online(online)
    port.run_fast_metrics(p)
    port.build_flow_table(p, port.order_coflows(p))
    port.run_batch([p], ("ours",))
    assert calls == []


def test_flow_table_core_choices_are_kernel_choices():
    """build_flow_table's cores are the plain kernel's choices on the
    extracted flows, widened to int64."""
    inst = INSTANCES[-1]
    p = to_port(inst)
    pi = port.order_coflows(p)
    table = port.build_flow_table(p, pi, backend="kernel")
    want = ref_engine.build_flow_table(inst, pi.numpy(), "ours",
                                       backend="pallas")
    assert table.core.dtype == torch.int64
    np.testing.assert_array_equal(table.core.numpy(), want.core)
    np.testing.assert_array_equal(table.size.numpy(), want.size)


def test_default_backend_is_the_references():
    """The port defaults to the reference's ``backend="numpy"``. On phase
    10's M=48, N=150 trace instance (25,217 flows) the default gives the
    reference's weighted CCT; the kernel, opt-in, its fp32 choices' own."""
    inst = ref.sample_instance(ref.synth_fb_trace(526, seed=2026), N=150,
                               M=48, rates=(10, 20, 30), delta=8, seed=0)
    want = ref.run_fast(inst)
    p = to_port(inst)
    got = port.run_fast(p)
    assert_same_schedule(got, want)
    assert port.weighted_cct(got) == ref.weighted_cct(want) \
        == 90920.77317031805
    for q in (0.95, 0.99):
        assert port.tail_cct(got, q) == ref.tail_cct(want, q)
    assert port.weighted_cct(port.run_fast(p, backend="kernel")) \
        == 84243.46481403771
    small = INSTANCES[2]
    oinst = ref.OnlineInstance(inst=small, releases=np.linspace(
        0.0, 40.0, small.M))
    ccts, _ = port.run_fast_metrics(to_port(small),
                                    releases=oinst.releases)
    np.testing.assert_array_equal(ccts.numpy(),
                                  ref.run_fast_online(oinst).ccts)
