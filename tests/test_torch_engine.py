"""The port's offline engine and referee vs the reference, on the CPU.

``repro_torch.core.run_fast`` is the port of ``repro.core.run_fast(...,
backend="pallas")``: the same fp32 tau-aware choices (the kernel's plain
version on the CPU), then the same event loop, so choices, establishment
times and CCTs must be bit-identical. Only the weighted sum and the tail
quantile are reduced in another order (torch vs numpy), hence rtol 1e-12
there.
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
        got = port.run_fast(p, scheduling=scheduling)
        w = _flat(want)
        for col, t in (("coflow", got.pos), ("cid", got.cid), ("i", got.fi),
                       ("j", got.fj), ("core", got.core), ("size", got.size),
                       ("t_establish", got.t_establish),
                       ("t_start", got.t_start),
                       ("t_complete", got.t_complete)):
            np.testing.assert_array_equal(t.numpy(), w[col],
                                          err_msg=f"{scheduling}: {col}")
        np.testing.assert_array_equal(got.pi.numpy(), want.pi)
        np.testing.assert_array_equal(got.ccts.numpy(), want.ccts)
        ccts, n_flows = port.run_fast_metrics(p, scheduling=scheduling)
        assert n_flows == len(want.flows)
        np.testing.assert_array_equal(ccts.numpy(), want.ccts)
        np.testing.assert_allclose(port.weighted_cct(got),
                                   ref.weighted_cct(want), rtol=1e-12)
        for q in (0.5, 0.95, 0.99):
            np.testing.assert_allclose(port.tail_cct(got, q),
                                       ref.tail_cct(want, q), rtol=1e-12)
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
    s = port.run_fast(to_port(inst))
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
    s = port.run_fast(to_port(inst))
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


@pytest.mark.parametrize("algorithm", ["rho-assign", "rand-assign",
                                       "sunflow-core", "rand-sunflow"])
def test_unported_algorithms_name_their_roadmap_entry(algorithm):
    p = to_port(INSTANCES[0])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        port.run_fast(p, algorithm)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        port.run_fast_metrics(p, algorithm)


def test_unported_options_raise_and_unknown_inputs_are_rejected():
    p = to_port(INSTANCES[0])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 3"):
        port.run_fast(p, scheduling="sunflow")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 2"):
        port.run_fast(p, delta_k=np.full(p.K, 2.0))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 2"):
        port.run_fast(p, locality=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 4"):
        port.run_fast_metrics(p, releases=np.zeros(p.M))
    with pytest.raises(ValueError, match="unknown algorithm"):
        port.run_fast(p, "nope")
    with pytest.raises(ValueError, match="unknown scheduling"):
        port.run_fast(p, scheduling="nope")


def test_flow_table_core_choices_are_kernel_choices():
    """build_flow_table's cores are the plain kernel's choices on the
    extracted flows, widened to int64."""
    inst = INSTANCES[-1]
    p = to_port(inst)
    pi = port.order_coflows(p)
    table = port.build_flow_table(p, pi)
    want = ref_engine.build_flow_table(inst, pi.numpy(), "ours",
                                       backend="pallas")
    assert table.core.dtype == torch.int64
    np.testing.assert_array_equal(table.core.numpy(), want.core)
    np.testing.assert_array_equal(table.size.numpy(), want.size)
