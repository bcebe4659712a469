"""The port's certificates of the paper's guarantees vs the reference's, on
the CPU.

On ``tests/test_theory.py``'s trace fixture (N=16, M=50, seed=11), on its
random sweep and on its two adversarial counterexamples, every
``check_*`` of ``repro_torch.core.theory`` returns the reference's dict
(pairs, violations, ratios, bounds; Lemma 1's arrays as tensors) and raises
where the reference raises.
"""
import math

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from test_online_differential import _releases
from test_online_differential import _random_instance as _online_instance
from test_torch_coflow import mk_inst, to_port
from test_torch_online import to_port_online

CHECKS = ("check_lemma1", "check_lemma2", "check_lemma3", "check_theorem1",
          "check_theorem2")


def _same(got, want):
    """Exact equality of a certificate's value; a port tensor is compared
    with the reference's array, a NaN ratio with a NaN."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if isinstance(want, np.ndarray):
        return np.array_equal(got, want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(map(_same, got, want))
    if isinstance(want, float) and math.isnan(want):
        return math.isnan(got)
    return bool(got == want)


def assert_same_certificate(name, got_s, want_s, **kw):
    """``name`` on both schedules: the same dict, or the same exception."""
    try:
        want = getattr(ref, name)(want_s, **kw)
    except AssertionError as exc:
        with pytest.raises(AssertionError) as info:
            getattr(port, name)(got_s, **kw)
        assert str(info.value) == str(exc), name
        return None
    got = getattr(port, name)(got_s, **kw)
    assert got.keys() == want.keys(), name
    for key in want:
        assert _same(got[key], want[key]), (name, key, got[key], want[key])
    return got


def assert_same_certificates(got_s, want_s):
    for name in CHECKS:
        kw = {"strict": False} if name in ("check_lemma3",
                                           "check_theorem2") else {}
        assert_same_certificate(name, got_s, want_s, **kw)


@pytest.fixture(scope="module")
def trace_instance():
    trace = ref.synth_fb_trace()
    return ref.sample_instance(trace, N=16, M=50, rates=[10, 20, 30], delta=8,
                               seed=11)


@pytest.mark.parametrize("scheduling", ("work-conserving", "priority-guard",
                                        "reserving"))
def test_certificates_on_the_trace_fixture(trace_instance, scheduling):
    want = ref.run(trace_instance, "ours", scheduling=scheduling)
    got = port.run(to_port(trace_instance), "ours", scheduling=scheduling)
    assert_same_certificates(got, want)
    if scheduling == "work-conserving":
        res = port.check_lemma3(got, strict=False)
        assert res["violations"]  # the reference's documented finding
        with pytest.raises(AssertionError, match="Lemma 3 violated"):
            port.check_lemma3(got)


@pytest.mark.parametrize("alg", ref.ALGORITHMS)
def test_certificates_on_the_trace_fixture_every_algorithm(trace_instance,
                                                           alg):
    want = ref.run(trace_instance, alg, seed=2)
    got = port.run(to_port(trace_instance), alg, seed=2)
    assert_same_certificates(got, want)


def test_certificates_on_schedule_all_cores_and_run_fast(trace_instance):
    """The engine's schedule of an assignment carries it; the flat one
    serves the assignment-free certificates."""
    p = to_port(trace_instance)
    pi = port.order_coflows(p)
    got = port.schedule_all_cores(p, pi, port.assign_tau_aware(p, pi))
    want = ref.run(trace_instance, "ours")
    assert_same_certificates(got, want)
    flat = port.run_fast(p)
    for name in ("check_lemma1", "check_theorem1", "check_theorem2"):
        assert_same_certificate(name, flat, want)


@pytest.mark.parametrize("pattern", ("uniform", "bursty"))
@pytest.mark.parametrize("trial", (1, 8, 10))
def test_certificates_on_online_schedules(trial, pattern):
    inst = _online_instance(trial)
    o = ref.OnlineInstance(inst=inst, releases=_releases(inst, pattern, trial))
    assert_same_certificates(port.run_online(to_port_online(o), "ours"),
                             ref.run_online(o, "ours"))


def _sweep():
    """tests/test_theory.py's random sweep."""
    rng = np.random.default_rng(123)
    out = []
    for _ in range(20):
        M = int(rng.integers(1, 8))
        N = int(rng.integers(2, 10))
        K = int(rng.integers(1, 5))
        rates = rng.uniform(5, 40, K)
        delta = float(rng.uniform(0, 10))
        demands = [rng.uniform(0, 30, (N, N))
                   * (rng.random((N, N)) < rng.uniform(0.2, 0.9))
                   for _ in range(M)]
        weights = rng.integers(1, 11, M).astype(float)
        if not any(d.any() for d in demands):
            continue
        out.append(mk_inst(demands, rates=rates, delta=delta,
                           weights=list(weights)))
    return out


SWEEP = _sweep()


@pytest.mark.parametrize("idx", range(len(SWEEP)))
def test_certificates_on_the_random_sweep(idx):
    inst = SWEEP[idx]
    assert_same_certificates(port.run(to_port(inst), "ours"),
                             ref.run(inst, "ours"))


def test_lemma3_holds_for_single_coflows():
    rng = np.random.default_rng(0)
    for _ in range(20):
        N = int(rng.integers(2, 12))
        D = rng.exponential(10, (N, N)) * (rng.random((N, N)) < 0.6)
        if not D.any():
            continue
        inst = mk_inst([D], rates=(1.0,), delta=float(rng.uniform(0, 10)))
        got = assert_same_certificate("check_lemma3",
                                      port.run(to_port(inst), "ours"),
                                      ref.run(inst, "ours"), strict=True)
        assert got["violations"] == []


@pytest.mark.parametrize("scheduling", ("work-conserving", "reserving"))
def test_lemma3_adversarial_counterexamples(scheduling):
    """tests/test_theory.py's two counterexamples: the priority coflow
    waits behind a long flow (work-conserving), and a staircase of
    entangled ports (reserving)."""
    if scheduling == "work-conserving":
        A = np.zeros((2, 2))
        A[0, 0], A[1, 0] = 10.0, 5.0
        B = np.zeros((2, 2))
        B[1, 1] = 100.0
        inst = mk_inst([A, B], rates=(1.0,), delta=0.0, weights=[100.0, 1.0])
    else:
        D = np.zeros((8, 8))
        D[0, 0] = 16.0
        for q in range(1, 8):
            D[q, q - 1] = D[q, q] = 4.0
        inst = mk_inst([D], rates=(1.0,), delta=0.0)
    got_s = port.run(to_port(inst), "ours", scheduling=scheduling)
    port.validate(got_s)
    got = assert_same_certificate("check_lemma3", got_s,
                                  ref.run(inst, "ours", scheduling=scheduling),
                                  strict=False)
    assert got["violations"]


def test_theorem2_eq41_counterexample():
    """M identical single-port coflows on one core: Eq. 41's M-independent
    bound fails while Theorem 1's holds."""
    D = np.zeros((2, 2))
    D[0, 0] = 10.0
    inst = mk_inst([D.copy() for _ in range(24)], rates=(1.0,), delta=0.0)
    got_s = port.run(to_port(inst), "ours")
    want_s = ref.run(inst, "ours")
    got = assert_same_certificate("check_theorem2", got_s, want_s,
                                  strict=False)
    assert got["empirical_ratio"] > got["bound"]
    with pytest.raises(AssertionError, match="Theorem 2 violated"):
        port.check_theorem2(got_s)
    assert_same_certificate("check_theorem1", got_s, want_s)


@pytest.mark.parametrize("w", [np.ones(10), np.r_[1.0, np.full(9, 1e-12)],
                               np.arange(1.0, 8.0)])
def test_gamma_w_matches_reference(w):
    assert port.gamma_w(w) == ref.gamma_w(w)
    assert port.gamma_w(torch.from_numpy(w)) == ref.gamma_w(w)


@pytest.mark.parametrize("name", ("check_lemma2", "check_lemma3"))
def test_flat_schedule_raises_the_references_value_error(trace_instance,
                                                         name):
    flat = port.run_fast(to_port(trace_instance))
    assert flat.assignment is None
    with pytest.raises(ValueError, match="needs Schedule.assignment"):
        getattr(port, name)(flat)
    with pytest.raises(ValueError, match="needs Schedule.assignment"):
        getattr(ref, name)(ref.run_fast(trace_instance))


def test_lemma1_reports_a_violation_as_the_reference(trace_instance):
    """A schedule whose CCTs fall below delta + rho/R fails Lemma 1."""
    import dataclasses

    want = ref.run(trace_instance, "ours")
    got = port.run(to_port(trace_instance), "ours")
    want = dataclasses.replace(want, ccts=want.ccts * 0.5)
    got = dataclasses.replace(got, ccts=got.ccts * 0.5)
    assert_same_certificate("check_lemma1", got, want)
