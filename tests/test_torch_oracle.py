"""The port's oracles vs the reference's, on the CPU.

``repro_torch.core`` keeps the reference's deliberately simple second
implementation of Algorithm 1: ``CoreState``, the dataclass assignments
(``assign_tau_aware``, ``assign_rho_only``, ``assign_random`` on numpy's
PCG64), the per-core circuit schedulers, ``run`` and ``run_online``. Each is
host numpy fp64, op for op the reference's, so every choice, state array,
establishment time and CCT here is compared with ``==``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="property tests need the hypothesis dev extra")
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.core.circuit_scheduler as ref_cs
from repro.core.coflow import nonzero_flows as ref_nonzero_flows
import repro_torch.core as port
import repro_torch.core.circuit_scheduler as port_cs
from repro_torch.core.coflow import nonzero_flows as port_nonzero_flows
from test_engine_differential import _random_instance
from test_online_differential import ARRIVAL_PATTERNS, _releases
from test_online_differential import _random_instance as _online_instance
from test_torch_coflow import mk_inst, to_port
from test_torch_engine import assert_same_schedule
from test_torch_online import to_port_online

POLICIES = ("work-conserving", "priority-guard", "reserving")
POINTS = [(a, s) for a in ref.ALGORITHMS
          for s in (("sunflow",) if "sunflow" in a else POLICIES)]
TRIALS = (0, 3, 7, 12, 20, 33)
ASSIGNERS = ("assign_tau_aware", "assign_rho_only", "assign_random")


def _flow_rows(flows):
    """Flow-like records as tuples (a reference and a port class differ)."""
    return [dataclasses.astuple(f) for f in flows]


def assert_same_state(got, want):
    for name in ("rates", "row_load", "col_load", "row_tau", "col_tau", "nz",
                 "bound"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert (got.K, got.N, got.delta) == (want.K, want.N, want.delta)
    assert got.max_bound() == want.max_bound()


def assert_same_assignment(got, want):
    np.testing.assert_array_equal(got.pi.numpy(), want.pi)
    assert len(got.flows) == len(want.flows)
    for g, w in zip(got.flows, want.flows):
        assert [(dataclasses.astuple(af.flow), af.core) for af in g] == \
            [(dataclasses.astuple(af.flow), af.core) for af in w]
    assert_same_state(got.state, want.state)


# ---------------------------------------------------------------------------
# data model: Flow, nonzero_flows, tau and psi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", TRIALS)
def test_flows_tau_and_psi_match_reference(trial):
    inst = _random_instance(trial)
    p = to_port(inst)
    assert (p.r_max, p.tau_max, p.psi) == (inst.r_max, inst.tau_max, inst.psi)
    for m, c in enumerate(inst.coflows):
        np.testing.assert_array_equal(p.host_demand(m), c.demand)
        pc = port.Coflow(cid=c.cid, demand=torch.from_numpy(c.demand.copy()),
                         weight=c.weight)
        assert pc.tau == c.tau
        for largest in (True, False):
            assert _flow_rows(port_nonzero_flows(
                pc, m, largest_first=largest)) == _flow_rows(
                ref_nonzero_flows(c, m, largest_first=largest))
    with pytest.raises(ValueError):
        p.host_demand(0)[0, 0] = 1.0  # the host copy is read-only


def test_empty_instance_has_tau_max_zero():
    e = port.instance_from_arrays(np.zeros((0, 3, 3)), np.zeros(0),
                                  np.zeros(0, np.int64), [10.0, 20.0], 2.0,
                                  device="cpu")
    assert (e.tau_max, e.psi) == (0, 2)


# ---------------------------------------------------------------------------
# CoreState and the dataclass assignments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_core_state_matches_reference(seed):
    rng = np.random.default_rng(seed)
    K, N = int(rng.integers(1, 6)), int(rng.integers(2, 9))
    rates = rng.uniform(1, 30, K)
    delta = float(rng.uniform(0, 10))
    want = ref.CoreState(K=K, N=N, rates=rates, delta=delta)
    got = port.CoreState(K=K, N=N, rates=torch.from_numpy(rates), delta=delta)
    for _ in range(200):
        i, j = int(rng.integers(N)), int(rng.integers(N))
        d = float(rng.exponential(10))
        np.testing.assert_array_equal(got.candidate_bounds(i, j, d),
                                      want.candidate_bounds(i, j, d))
        np.testing.assert_array_equal(got.candidate_rho_bounds(i, j, d),
                                      want.candidate_rho_bounds(i, j, d))
        k = int(rng.integers(K))
        got.assign(i, j, d, k)
        want.assign(i, j, d, k)
    assert_same_state(got, want)


@pytest.mark.parametrize("name", ASSIGNERS)
@pytest.mark.parametrize("trial", TRIALS)
def test_dataclass_assignments_match_reference(trial, name):
    inst = _random_instance(trial)
    p = to_port(inst)
    pi = ref.order_coflows(inst)
    seeds = (0, 1, trial, 2**31 - 1) if name == "assign_random" else (None,)
    for seed in seeds:
        kw = {} if seed is None else {"seed": seed}
        want = getattr(ref, name)(inst, pi, **kw)
        got = getattr(port, name)(p, torch.as_tensor(pi), **kw)
        assert_same_assignment(got, want)
        assert _flow_rows([af.flow for af in got.all_flows()]) == \
            _flow_rows([af.flow for af in want.all_flows()])


@pytest.mark.parametrize("trial", TRIALS)
def test_per_core_demand_and_prefixes_match_reference(trial):
    inst = _random_instance(trial)
    pi = ref.order_coflows(inst)
    want = ref.assign_tau_aware(inst, pi)
    got = port.assign_tau_aware(to_port(inst), torch.as_tensor(pi))
    # forward, then backward (a rebuild), then forward again
    for m in list(range(inst.M)) + [0, inst.M - 1]:
        np.testing.assert_array_equal(got.per_core_demand(m).numpy(),
                                      want.per_core_demand(m))
        np.testing.assert_array_equal(got.prefix_per_core(m).numpy(),
                                      want.prefix_per_core(m))


@pytest.mark.parametrize("policy", ("tau-aware", "rho-only", "random"))
@pytest.mark.parametrize("trial", TRIALS)
def test_assignment_from_choices_matches_reference(trial, policy):
    inst = _random_instance(trial)
    p = to_port(inst)
    pi = ref.order_coflows(inst)
    flows = ref.extract_flows(inst, pi)
    choices = ref.assign_fast(inst, pi, policy, seed=trial, flows=flows)
    want = ref.assignment_from_choices(inst, pi, flows, choices)
    pflows = port.extract_flows(p, torch.as_tensor(pi))
    got = port.assignment_from_choices(p, torch.as_tensor(pi), pflows,
                                       torch.from_numpy(choices))
    assert_same_assignment(got, want)


# ---------------------------------------------------------------------------
# the per-core circuit schedulers
# ---------------------------------------------------------------------------

def _per_core(a, k):
    return [af for per in a.flows for af in per if af.core == k]


@pytest.mark.parametrize("with_releases", [False, True])
@pytest.mark.parametrize("trial", TRIALS)
def test_per_core_schedulers_match_reference(trial, with_releases):
    inst = _random_instance(trial)
    pi = ref.order_coflows(inst)
    want_a = ref.assign_tau_aware(inst, pi)
    got_a = port.assign_tau_aware(to_port(inst), torch.as_tensor(pi))
    rng = np.random.default_rng(trial)
    for k in range(inst.K):
        w_fl, g_fl = _per_core(want_a, k), _per_core(got_a, k)
        rel = (rng.uniform(0, 20, len(w_fl)).round(1) if with_releases
               else None)
        args = (k, float(inst.rates[k]), inst.delta, inst.N)
        for guard in (False, True):
            assert _flow_rows(port.schedule_core_list(
                g_fl, *args, guard=guard, releases=rel)) == _flow_rows(
                ref.schedule_core_list(w_fl, *args, guard=guard, releases=rel))
        assert _flow_rows(port_cs.schedule_core_reserving(
            g_fl, *args, releases=rel)) == _flow_rows(
            ref_cs.schedule_core_reserving(w_fl, *args, releases=rel))
        assert _flow_rows(port.schedule_core_sunflow(g_fl, *args)) == \
            _flow_rows(ref.schedule_core_sunflow(w_fl, *args))


def test_list_scheduler_t0_and_guard_match_reference():
    rng = np.random.default_rng(5)
    fi, fj = rng.integers(0, 4, 40), rng.integers(0, 4, 40)
    sizes = rng.exponential(5, 40)
    for guard in (False, True):
        for t0 in (0.0, 17.5):
            np.testing.assert_array_equal(
                port_cs._run_list_scheduler(fi, fj, sizes, 3.0, 2.0, 4,
                                            t0=t0, guard=guard),
                ref_cs._run_list_scheduler(fi, fj, sizes, 3.0, 2.0, 4,
                                           t0=t0, guard=guard))


def test_list_scheduler_deadlock_raises_as_the_reference():
    """A NaN size never frees its ports: both loops run out of events."""
    args = (np.array([0, 0]), np.array([0, 0]), np.array([np.nan, 1.0]),
            1.0, 0.0, 1)
    for mod in (ref_cs, port_cs):
        with pytest.raises(RuntimeError, match="scheduler deadlock"):
            mod._run_list_scheduler(*args)


# ---------------------------------------------------------------------------
# run and run_online
# ---------------------------------------------------------------------------

def assert_same_oracle_schedule(got, want, msg=""):
    assert_same_schedule(got, want, msg)
    assert_same_assignment(got.assignment, want.assignment)
    assert _flow_rows(port.scheduled_flows(got)) == _flow_rows(want.flows)


@pytest.mark.parametrize("trial", TRIALS)
def test_run_matches_reference_for_every_point(trial):
    inst = _random_instance(trial)
    p = to_port(inst)
    for alg, sched in POINTS:
        kw = dict(seed=trial) if sched == "sunflow" else dict(
            seed=trial, scheduling=sched)
        got = port.run(p, alg, **kw)
        assert_same_oracle_schedule(got, ref.run(inst, alg, **kw),
                                    f"{alg} {sched}")
        port.validate(got)


def test_run_rejects_what_the_reference_rejects():
    inst = _random_instance(0)
    with pytest.raises(ValueError, match="unknown algorithm"):
        port.run(to_port(inst), "nope")
    with pytest.raises(KeyError):
        port.run(to_port(inst), "ours", scheduling="nope")


@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
@pytest.mark.parametrize("trial", TRIALS)
def test_run_online_matches_reference_for_every_point(trial, pattern):
    inst = _online_instance(trial)
    o = ref.OnlineInstance(inst=inst, releases=_releases(inst, pattern, trial))
    po = to_port_online(o)
    for alg, sched in POINTS:
        kw = dict(seed=trial, scheduling=sched)
        got = port.run_online(po, alg, **kw)
        assert_same_oracle_schedule(got, ref.run_online(o, alg, **kw),
                                    f"{alg} {sched}")
        port.validate(got, releases=po.releases)


@pytest.mark.parametrize("trial", TRIALS[:3])
def test_run_online_with_zero_releases_is_the_offline_run(trial):
    inst = _online_instance(trial)
    o = port.OnlineInstance(inst=to_port(inst), releases=np.zeros(inst.M))
    for alg, sched in POINTS:
        kw = dict(seed=trial) if sched == "sunflow" else dict(
            seed=trial, scheduling=sched)
        on, off = port.run_online(o, alg, **kw), port.run(o.inst, alg, **kw)
        for name in ("pi", "core", "t_establish", "ccts"):
            assert torch.equal(getattr(on, name), getattr(off, name)), name


def test_run_online_replays_a_given_assignment():
    inst = _online_instance(4)
    o = ref.OnlineInstance(inst=inst, releases=_releases(inst, "uniform", 4))
    po = to_port_online(o)
    arrival, _ = port.online_orders(po.inst, po.releases)
    a = port.assign_rho_only(po.inst, arrival)
    want = ref.run_online(o, "ours", assignment=ref.assign_rho_only(
        inst, arrival.numpy()))
    got = port.run_online(po, "ours", assignment=a)
    assert got.assignment is a
    assert_same_schedule(got, want)


@st.composite
def instances(draw):
    """tests/test_properties.py's strategy."""
    M = draw(st.integers(1, 6))
    N = draw(st.integers(2, 8))
    K = draw(st.integers(1, 4))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    demands, weights = [], []
    for _ in range(M):
        D = rng.exponential(10, (N, N)) * (rng.random((N, N)) < 0.5)
        if not D.any():
            D[rng.integers(N), rng.integers(N)] = 1.0
        demands.append(D)
        weights.append(float(rng.integers(1, 10)))
    return mk_inst(demands, rates=rng.uniform(1.0, 30.0, K),
                   delta=float(rng.uniform(0.0, 10.0)), weights=weights)


@settings(max_examples=25, deadline=None)
@given(instances(), st.sampled_from(ref.ALGORITHMS))
def test_run_matches_reference_on_random_instances(inst, alg):
    got = port.run(to_port(inst), alg, seed=0)
    assert_same_oracle_schedule(got, ref.run(inst, alg, seed=0), alg)
    port.validate(got)
    port.check_lemma1(got)


@pytest.mark.parametrize("seed", range(3))
def test_assign_ref_matches_reference(seed):
    """The gate's third implementation: fp64 state at fp64 and fp32-cast
    inputs, choices and final bounds equal to the reference's."""
    from repro.kernels.ref import assign_ref as ref_assign_ref
    from repro_torch.kernels.ref import assign_ref

    rng = np.random.default_rng(seed)
    F, K, N = 300, int(rng.integers(1, 9)), int(rng.integers(2, 20))
    fi, fj = rng.integers(0, N, F), rng.integers(0, N, F)
    sizes = rng.exponential(30, F)
    rates = rng.uniform(5, 30, K)
    for cast in (np.float64, np.float32):
        args = (fi, fj, sizes.astype(cast), rates.astype(cast),
                float(cast(7.5)), N)
        (gc, gb), (wc, wb) = assign_ref(*args), ref_assign_ref(*args)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gb, wb)
        assert gc.dtype == wc.dtype == np.int32
