"""The port's online path vs the reference, on the CPU.

On the grid of ``tests/test_online_differential.py`` (random instances under
uniform and bursty arrivals) ``repro_torch.core.run_fast_online`` must give
the reference's core choices, establishment times and CCTs bit for bit, for
all five algorithms and all four scheduling policies: under
``backend="numpy"`` against the reference's ``"numpy"`` (fp64 oracles),
under ``backend="kernel"`` (the kernel's plain version here) against its
``"pallas"`` in interpret mode. Also: the arrival orders, the sampler of
online instances per seed, the trace parser, the zero-release reduction to
the offline path, drifted delays, and the referee's release check.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.online import online_orders as ref_online_orders
from test_online_differential import (
    ARRIVAL_PATTERNS,
    LIST_SCHEDULINGS,
    N_RANDOM_INSTANCES,
    _random_instance,
    _releases,
)
from test_torch_coflow import dataclass_tuple, to_port
from test_torch_engine import assert_same_schedule, to_reference

#: (algorithm, scheduling) of the whole grid: the sunflow baselines once.
POINTS = [(a, s) for a in ref.ALGORITHMS
          for s in (("sunflow",) if "sunflow" in a else LIST_SCHEDULINGS)]


def to_port_online(oinst: "ref.OnlineInstance") -> "port.OnlineInstance":
    """The same online instance in the port, on the CPU."""
    return port.OnlineInstance(inst=to_port(oinst.inst),
                               releases=oinst.releases)


def _oinst(trial, pattern):
    inst = _random_instance(trial)
    return ref.OnlineInstance(inst=inst,
                              releases=_releases(inst, pattern, trial))


@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
@pytest.mark.parametrize("trial", range(N_RANDOM_INSTANCES))
def test_online_orders_match_reference(trial, pattern):
    oinst = _oinst(trial, pattern)
    arrival, rank = ref_online_orders(oinst.inst, oinst.releases)
    p = to_port_online(oinst)
    got_arrival, got_rank = port.online_orders(p.inst, p.releases)
    np.testing.assert_array_equal(got_arrival.numpy(), arrival)
    np.testing.assert_array_equal(got_rank.numpy(), rank)


@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
@pytest.mark.parametrize("trial", range(N_RANDOM_INSTANCES))
def test_run_fast_online_numpy_backend_matches_reference(trial, pattern):
    """Every algorithm x policy of one grid point, schedule and metrics."""
    oinst = _oinst(trial, pattern)
    p = to_port_online(oinst)
    for alg, sched in POINTS:
        kw = dict(seed=trial, scheduling=sched, backend="numpy")
        want = ref.run_fast_online(oinst, alg, **kw)
        got = port.run_fast_online(p, alg, **kw)
        assert_same_schedule(got, want, f"{alg} {sched}")
        ccts, n_flows = port.run_fast_metrics(p.inst, alg, releases=p.releases,
                                              **kw)
        np.testing.assert_array_equal(ccts.numpy(), want.ccts)
        assert n_flows == len(want.flows)
        port.validate(got, releases=p.releases)


@pytest.mark.parametrize("trial", [0, 3, 6, 13, 21, 30])
def test_run_fast_online_kernel_backend_matches_reference_pallas(trial):
    """Arrival-ordered flows through the kernel's plain version: the
    reference's interpret-mode Pallas kernel makes the same choices."""
    oinst = _oinst(trial, ARRIVAL_PATTERNS[trial % 2])
    p = to_port_online(oinst)
    for alg, sched in POINTS:
        if alg not in ("ours", "sunflow-core"):
            continue  # no kernel: the same host backend as test above
        want = ref.run_fast_online(oinst, alg, seed=trial, scheduling=sched,
                                   backend="pallas")
        got = port.run_fast_online(p, alg, seed=trial, scheduling=sched,
                                   backend="kernel")
        assert_same_schedule(got, want, f"{alg} {sched}")


@pytest.mark.parametrize("trial", range(0, N_RANDOM_INSTANCES, 7))
def test_zero_releases_equal_offline(trial):
    inst = _random_instance(trial)
    p = to_port(inst)
    zero = port.OnlineInstance(inst=p, releases=torch.zeros(p.M))
    for alg, sched in POINTS:
        for backend in ("numpy", "kernel"):
            on = port.run_fast_online(zero, alg, seed=trial, scheduling=sched,
                                      backend=backend)
            off = port.run_fast(p, alg, seed=trial, scheduling=sched,
                                backend=backend)
            for name in ("pi", "core", "t_establish", "t_complete", "ccts"):
                assert torch.equal(getattr(on, name), getattr(off, name)), \
                    (alg, sched, backend, name)


@pytest.mark.parametrize("trial", [1, 4, 10, 19])
def test_drifted_delays_online(trial):
    """``delta_k`` prices assignment and scheduling with each core's delay:
    the reference's result, and the referee passes with those delays."""
    oinst = _oinst(trial, "bursty")
    p = to_port_online(oinst)
    K = p.inst.K
    drifted = np.full(K, p.inst.delta)
    drifted[K - 1] = p.inst.delta * 3 + 2.0
    for alg, sched in POINTS:
        for dk in (drifted, np.full(K, p.inst.delta)):
            for backend, rbackend in (("numpy", "numpy"), ("kernel", "pallas")):
                want = ref.run_fast_online(oinst, alg, seed=trial,
                                           scheduling=sched, delta_k=dk,
                                           backend=rbackend)
                got = port.run_fast_online(p, alg, seed=trial,
                                           scheduling=sched,
                                           delta_k=torch.from_numpy(dk),
                                           backend=backend)
                assert_same_schedule(got, want, f"{alg} {sched} {dk}")
                port.validate(got, releases=p.releases,
                              flow_delta=dk[got.core.numpy()])
    nominal = port.run_fast_online(p, delta_k=np.full(K, p.inst.delta),
                                   backend="kernel")
    plain = port.run_fast_online(p, backend="kernel")
    assert torch.equal(nominal.t_complete, plain.t_complete)


def test_validate_checks_releases_and_flow_delta_as_the_reference_does():
    oinst = _oinst(8, "uniform")
    p = to_port_online(oinst)
    s = port.run_fast_online(p, backend="kernel")
    port.validate(s, releases=p.releases)
    # one coflow released just after its first establishment: both raise
    bad = oinst.releases.copy()
    bad[int(s.pi[s.pos[0]])] = float(s.t_establish[0]) + 1.0
    with pytest.raises(AssertionError, match="release"):
        port.validate(s, releases=torch.from_numpy(bad))
    with pytest.raises(AssertionError, match="release"):
        ref.validate(to_reference(s, oinst.inst), releases=bad)
    # a per-flow delay that is not the one the schedule used: both raise
    wrong = np.full(s.n_flows, p.inst.delta + 1.0)
    with pytest.raises(AssertionError, match="establish \\+ delta"):
        port.validate(s, flow_delta=wrong)
    with pytest.raises(AssertionError, match="establish \\+ delta"):
        ref.validate(to_reference(s, oinst.inst), flow_delta=wrong)
    right = np.full(s.n_flows, p.inst.delta)
    port.validate(s, releases=p.releases, flow_delta=torch.from_numpy(right))


def test_online_instance_validation():
    p = to_port(_random_instance(0))
    with pytest.raises(ValueError, match="shape"):
        port.OnlineInstance(inst=p, releases=np.zeros(p.M + 1))
    with pytest.raises(ValueError, match=">= 0"):
        port.OnlineInstance(inst=p, releases=np.full(p.M, -1.0))
    o = port.OnlineInstance(inst=p, releases=[0.5] * p.M)
    assert o.releases.dtype == torch.float64 and o.releases.device == p.device


def test_online_instance_from_arrays():
    oinst = _oinst(5, "bursty")
    inst = oinst.inst
    o = port.online_instance_from_arrays(
        np.stack([c.demand for c in inst.coflows]), inst.weights,
        np.array([c.cid for c in inst.coflows]), inst.rates, inst.delta,
        oinst.releases, device="cpu")
    assert torch.equal(o.inst.demand, to_port(inst).demand)
    np.testing.assert_array_equal(o.releases.numpy(), oinst.releases)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(N=16, M=40, span=500.0),
    dict(N=8, M=30, span=0.0),
    dict(N=12, M=1, span=100.0),
    dict(N=12, M=20, span=800.0, machine_map="fold", weight_mode="normal",
         weight_params=(5.0, 2.0)),
])
def test_sample_online_instance_matches_reference(seed, kw):
    trace = ref.synth_fb_trace(120, seed=seed + 5)
    want = ref.sample_online_instance(trace, rates=[10, 20, 30], delta=8.0,
                                      seed=seed, **kw)
    got = port.sample_online_instance(port.synth_fb_trace(120, seed=seed + 5),
                                      rates=[10, 20, 30], delta=8.0,
                                      seed=seed, device="cpu", **kw)
    np.testing.assert_array_equal(got.releases.numpy(), want.releases)
    np.testing.assert_array_equal(
        got.inst.demand.numpy(), np.stack([c.demand for c in want.inst.coflows]))
    np.testing.assert_array_equal(got.inst.weights.numpy(), want.inst.weights)
    inst, pick = port.sample_instance(port.synth_fb_trace(120, seed=seed + 5),
                                      rates=[10, 20, 30], delta=8.0,
                                      seed=seed, device="cpu",
                                      return_pick=True,
                                      **{k: v for k, v in kw.items()
                                         if k != "span"})
    _, want_pick = ref.sample_instance(trace, rates=[10, 20, 30], delta=8.0,
                                       seed=seed, return_pick=True,
                                       **{k: v for k, v in kw.items()
                                          if k != "span"})
    np.testing.assert_array_equal(pick, want_pick)
    with pytest.raises(ValueError, match="span"):
        port.sample_online_instance(port.synth_fb_trace(10, seed=0), N=4, M=2,
                                    rates=[10.0], delta=1.0, span=-1.0,
                                    device="cpu")


def test_load_fb_trace_matches_reference(tmp_path):
    path = tmp_path / "fb.txt"
    path.write_text("150 3\n"
                    "0 0 2 5 17 1 3:12.5\n"
                    "1 1500 1 9 2 4:0.25 88:1024\n"
                    "\n"
                    "2 3600000 3 1 2 3 1 7:3\n")
    want = [dataclass_tuple(t) for t in ref.load_fb_trace(str(path))]
    assert [dataclass_tuple(t) for t in port.load_fb_trace(str(path))] == want
    path.write_text("0 0 1 5 1 3:12.5\n")  # no header line
    assert [dataclass_tuple(t) for t in port.load_fb_trace(str(path))] == \
        [dataclass_tuple(t) for t in ref.load_fb_trace(str(path))]
