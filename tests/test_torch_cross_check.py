"""The port's differential gates vs the reference's, on the CPU.

``schedule_all_cores`` must equal ``run_fast`` row for row (the reference's
``test_run_fast_flat_path_matches_schedule_all_cores``) and the reference's
own ``schedule_all_cores``; ``cross_check`` and ``cross_check_online`` must
pass where the reference's pass, on the reference's differential-test
instances, under ``backend="numpy"`` and ``"kernel"`` (the kernel's plain
version here, against the reference's ``"pallas"`` in interpret mode), and
raise the reference's ``AssertionError`` when a choice, a CCT or an
establishment time is corrupted; ``run_batch(check="oracle")`` rows must
equal the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.core.engine as ref_engine
from repro.core.online import online_orders as ref_online_orders
import repro_torch.core as port
import repro_torch.core.engine as port_engine
from test_engine_differential import _random_instance
from test_online_differential import _releases
from test_online_differential import _random_instance as _online_instance
from test_torch_batch import _grid, assert_same_rows
from test_torch_coflow import to_port
from test_torch_engine import assert_same_schedule
from test_torch_online import to_port_online

POLICIES = ("work-conserving", "priority-guard", "reserving")
POINTS = [(a, s) for a in ref.ALGORITHMS
          for s in (("sunflow",) if "sunflow" in a else POLICIES)]
TRIALS = (1, 2, 5, 9, 14, 27, 40, 51)
REF_BACKEND = {"numpy": "numpy", "kernel": "pallas"}


def _online(trial, pattern="bursty"):
    inst = _online_instance(trial)
    return ref.OnlineInstance(inst=inst,
                              releases=_releases(inst, pattern, trial))


# ---------------------------------------------------------------------------
# schedule_all_cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", (2, 7, 11))
def test_run_fast_flat_path_matches_schedule_all_cores(trial):
    inst = _random_instance(trial)
    p = to_port(inst)
    pi = port.order_coflows(p)
    a = port.assign_tau_aware(p, pi)
    via_objects = port.schedule_all_cores(p, pi, a, "work-conserving")
    flat = port.run_fast(p, "ours")
    assert flat.assignment is None and via_objects.assignment is a
    for name in ("pi", "pos", "cid", "fi", "fj", "core", "size",
                 "t_establish", "t_start", "t_complete", "ccts"):
        assert torch.equal(getattr(flat, name), getattr(via_objects, name))


@pytest.mark.parametrize("scheduling", POLICIES + ("sunflow",))
@pytest.mark.parametrize("trial", TRIALS[:4])
def test_schedule_all_cores_matches_reference(trial, scheduling):
    o = _online(trial)
    inst = o.inst
    p = to_port_online(o)
    for rel in (None, o.releases):
        pi = (ref.order_coflows(inst) if rel is None
              else ref_online_orders(inst, rel)[0])
        want_a = ref.assign_rho_only(inst, pi)
        got_a = port.assign_rho_only(p.inst, torch.as_tensor(pi))
        want = ref.schedule_all_cores(inst, pi, want_a, scheduling,
                                      releases=rel)
        got = port.schedule_all_cores(
            p.inst, torch.as_tensor(pi), got_a, scheduling,
            releases=None if rel is None else torch.from_numpy(rel))
        assert_same_schedule(got, want, scheduling)
        assert got.assignment is got_a


def test_flow_table_from_assignment_matches_reference():
    inst = _random_instance(9)
    pi = ref.order_coflows(inst)
    want = ref_engine.FlowTable.from_assignment(ref.assign_tau_aware(inst, pi))
    got = port.FlowTable.from_assignment(
        port.assign_tau_aware(to_port(inst), torch.as_tensor(pi)))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      getattr(want, f.name), err_msg=f.name)
        assert getattr(got, f.name).dtype == torch.from_numpy(
            getattr(want, f.name)).dtype


def test_schedule_all_cores_rejects_an_unknown_policy():
    inst = to_port(_random_instance(0))
    pi = port.order_coflows(inst)
    with pytest.raises(ValueError, match="unknown scheduling"):
        port.schedule_all_cores(inst, pi, port.assign_tau_aware(inst, pi),
                                "nope")


# ---------------------------------------------------------------------------
# cross_check and cross_check_online
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", TRIALS)
def test_cross_check_passes_on_the_differential_instances(trial):
    """The reference's test_engine_matches_oracle_randomized, on the port."""
    p = to_port(_random_instance(trial))
    for alg, sched in POINTS:
        for backend in ("numpy", "kernel"):
            got = port.cross_check(p, alg, seed=trial, scheduling=sched,
                                   backend=backend)
            want = port.run_fast(p, alg, seed=trial, scheduling=sched,
                                 backend=backend)
            assert torch.equal(got.t_establish, want.t_establish)


@pytest.mark.parametrize("pattern", ("uniform", "bursty"))
@pytest.mark.parametrize("trial", TRIALS)
def test_cross_check_online_passes_on_the_differential_instances(trial,
                                                                 pattern):
    po = to_port_online(_online(trial, pattern))
    for alg, sched in POINTS:
        for backend in ("numpy", "kernel"):
            port.cross_check_online(po, alg, seed=trial, scheduling=sched,
                                    backend=backend)


@pytest.mark.parametrize("online", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("trial", (3, 6))
def test_cross_check_returns_the_references_schedule(trial, backend, online):
    o = _online(trial)
    for alg, sched in (("ours", "work-conserving"),
                       ("sunflow-core", "sunflow")):
        kw = dict(seed=trial, scheduling=sched)
        if online:
            want = ref_engine.cross_check_online(
                o, alg, backend=REF_BACKEND[backend], **kw)
            got = port.cross_check_online(to_port_online(o), alg,
                                          backend=backend, **kw)
        else:
            want = ref_engine.cross_check(o.inst, alg,
                                          backend=REF_BACKEND[backend], **kw)
            got = port.cross_check(to_port(o.inst), alg, backend=backend,
                                   **kw)
        assert_same_schedule(got, want, alg)


def _flip_one(choices, K):
    """The choices with the middle one moved to the next core."""
    bad = choices.clone() if isinstance(choices, torch.Tensor) \
        else choices.copy()
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % K
    return bad


@pytest.mark.parametrize("online", [False, True])
def test_a_corrupted_fp64_choice_makes_the_gate_raise(monkeypatch, online):
    """A flipped choice of the flat backend: both gates name the oracle."""
    o = _online(8)
    K = o.inst.K
    real = {"ref": ref_engine.assign_fast, "port": port_engine.assign_fast}
    monkeypatch.setattr(ref_engine, "assign_fast",
                        lambda *a, **k: _flip_one(real["ref"](*a, **k), K))
    monkeypatch.setattr(port_engine, "assign_fast",
                        lambda *a, **k: _flip_one(real["port"](*a, **k), K))
    for gate, arg in (
            (ref_engine.cross_check_online if online
             else ref_engine.cross_check, o if online else o.inst),
            (port.cross_check_online if online else port.cross_check,
             to_port_online(o) if online else to_port(o.inst))):
        with pytest.raises(AssertionError,
                           match="choice mismatch with the dataclass oracle"):
            gate(arg, "ours")


@pytest.mark.parametrize("online", [False, True])
def test_corrupted_kernel_choices_make_the_gate_raise(monkeypatch, online):
    """Every kernel choice shifted by one core: far beyond the fp32
    allowance, in both packages."""
    o = _online(8)
    monkeypatch.setattr(
        ref_engine, "_pallas_choices",
        lambda inst, flows: (np.arange(flows[0].size) + 1) % inst.K)
    monkeypatch.setattr(
        port_engine, "coflow_assign",
        lambda fi, fj, size, rates, delta, n_ports: (
            torch.arange(fi.numel()) + 1) % rates.numel())
    for gate, arg, backend in (
            (ref_engine.cross_check_online if online
             else ref_engine.cross_check, o if online else o.inst, "pallas"),
            (port.cross_check_online if online else port.cross_check,
             to_port_online(o) if online else to_port(o.inst), "kernel")):
        with pytest.raises(AssertionError, match="assign_ref diverge"):
            gate(arg, "ours", backend=backend)


@pytest.mark.parametrize("field, match", [
    ("ccts", "CCT mismatch"),
    ("t_establish", "t_establish mismatch"),
    ("core", "flow sets differ"),
])
@pytest.mark.parametrize("online", [False, True])
def test_a_corrupted_engine_schedule_makes_the_gate_raise(online, field,
                                                          match):
    o = _online(20)
    po = to_port_online(o)
    if online:
        run_ref, run_port = ref.run_fast_online, port.run_fast_online
        gates = (ref_engine.cross_check_online, port.cross_check_online)
        args = (o, po)
    else:
        run_ref, run_port = ref.run_fast, port.run_fast
        gates = (ref_engine.cross_check, port.cross_check)
        args = (o.inst, po.inst)
    want, got = run_ref(args[0]), run_port(args[1])
    if field == "ccts":
        want = dataclasses.replace(want, ccts=want.ccts + 0.5)
        got = dataclasses.replace(got, ccts=got.ccts + 0.5)
    elif field == "t_establish":
        want.flows[0] = dataclasses.replace(
            want.flows[0], t_establish=want.flows[0].t_establish + 0.5)
        te = got.t_establish.clone()
        te[0] += 0.5
        got = dataclasses.replace(got, t_establish=te)
    else:
        want.flows[0] = dataclasses.replace(
            want.flows[0], core=(want.flows[0].core + 1) % o.inst.K)
        core = got.core.clone()
        core[0] = (core[0] + 1) % o.inst.K
        got = dataclasses.replace(got, core=core)
    for gate, arg, fast in zip(gates, args, (want, got)):
        with pytest.raises(AssertionError, match=match):
            gate(arg, "ours", fast=fast)


def test_the_kernel_gate_adds_no_launch_given_the_schedule(monkeypatch):
    """``backend="kernel"``: the gate reads the engine's own choices, so
    ``cross_check`` calls the kernel once, through ``run_fast``, and not at
    all when given ``fast``."""
    calls = []
    real = port_engine.coflow_assign
    monkeypatch.setattr(port_engine, "coflow_assign",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    p = to_port(_random_instance(14))
    fast = port.cross_check(p, "ours", backend="kernel")
    assert len(calls) == 1
    port.cross_check(p, "ours", backend="kernel", fast=fast)
    assert len(calls) == 1


def test_kernel_divergence_counts_against_assign_ref():
    p = to_port(_random_instance(26))
    pi = port.order_coflows(p)
    flows = port.extract_flows(p, pi)
    fast = port.run_fast(p, backend="kernel")
    choices = port_engine._choices_of(fast, pi, flows, "")
    assert port_engine._kernel_divergence(p, flows, choices) == (
        0, max(1, int(np.ceil(0.03 * choices.numel()))))
    assert port_engine._kernel_divergence(
        p, flows, _flip_one(choices, p.K))[0] == 1


# ---------------------------------------------------------------------------
# run_batch(check="oracle")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_run_batch_oracle_rows_match_reference(backend):
    insts, rel = _grid()
    kw = dict(seeds=(0, 5), schedulings=POLICIES, check="oracle")
    want = ref.run_batch(insts, ref.ALGORITHMS, releases=rel, workers=0,
                         backend=REF_BACKEND[backend], **kw)
    got = port.run_batch(
        [to_port_online(i) if isinstance(i, ref.OnlineInstance)
         else to_port(i) for i in insts], port.ALGORITHMS,
        releases=[None if r is None else torch.from_numpy(r) for r in rel],
        backend=backend, **kw)
    assert_same_rows(got.rows, want.rows)


def test_run_batch_oracle_runs_the_gate(monkeypatch):
    """check="oracle" really calls the gates, given each point's schedule."""
    seen = []
    for name in ("cross_check", "cross_check_online"):
        real = getattr(port.batch, name)
        monkeypatch.setattr(
            port.batch, name,
            lambda *a, _real=real, _name=name, **k: seen.append(
                (_name, k["fast"] is not None)) or _real(*a, **k))
    o = to_port_online(_online(3))
    port.run_batch([o.inst, o], ("ours",), check="oracle")
    assert seen == [("cross_check", True), ("cross_check_online", True)]
