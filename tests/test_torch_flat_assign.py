"""The port's fp64 assignment backend vs the reference's, on the CPU.

``repro_torch.core.assignment`` is the reference's flat front-end
(``FlatAssignState``, ``assign_fast``) op for op over Python floats, and its
random policy draws from the same PCG64 stream, so every choice must be
bit-identical: one-shot and chunked, under ``up`` masks, ``set_delta``,
``reset_core`` and ``locality > 0``. The instances are those of
``tests/test_assign_fast.py``.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core.assignment import FlatAssignState as RefState
from repro_torch.core.assignment import FlatAssignState as PortState
import repro_torch.core as port
from test_assign_fast import N_RANDOM_INSTANCES, POLICIES, _random_instance
from test_torch_coflow import to_port


def _trace_instance():
    trace = ref.synth_fb_trace(120, seed=11)
    return ref.sample_instance(trace, N=16, M=40, rates=[10, 20, 30],
                               delta=8.0, seed=2)


def _flows(inst):
    return ref.extract_flows(inst, ref.order_coflows(inst))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(policy, inst, seed=0, locality=0.0):
    """A reference state and a port state over the same fabric."""
    return (RefState(policy, inst.rates, inst.delta, inst.N, seed=seed,
                     locality=locality),
            PortState(policy, _t(inst.rates), inst.delta, inst.N, seed=seed,
                      locality=locality))


def _feed(states, fi, fj, sz, **kw):
    """Feed one chunk to both states; assert equal choices."""
    a, b = states
    want = a.assign(fi, fj, sz, **kw)
    up = kw.get("up")
    got = b.assign(_t(fi), _t(fj), _t(sz),
                   **({} if up is None else {"up": _t(up)}))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trial", range(N_RANDOM_INSTANCES))
def test_assign_fast_bit_identical_to_reference(trial, policy):
    inst = _random_instance(trial)
    pi = ref.order_coflows(inst)
    want = ref.assign_fast(inst, pi, policy, seed=trial)
    p = to_port(inst)
    got = port.assign_fast(p, torch.as_tensor(pi), policy, seed=trial)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
def test_assign_fast_trace_instance(policy):
    inst = _trace_instance()
    pi = ref.order_coflows(inst)
    p = to_port(inst)
    flows = port.extract_flows(p, torch.as_tensor(pi))
    np.testing.assert_array_equal(
        port.assign_fast(p, torch.as_tensor(pi), policy, seed=7,
                         flows=flows).numpy(),
        ref.assign_fast(inst, pi, policy, seed=7))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trial", [1, 4, 9, 17, 26])
def test_chunked_equals_one_shot(trial, policy):
    """Chunks at random boundaries give the reference's one-shot choices."""
    inst = _random_instance(trial)
    _pos, _cid, fi, fj, sz = _flows(inst)
    want = ref.assign_fast(inst, ref.order_coflows(inst), policy, seed=trial)
    st = PortState(policy, _t(inst.rates), inst.delta, inst.N, seed=trial)
    rng = np.random.default_rng(trial)
    cuts = np.sort(rng.integers(0, fi.size + 1, 4))
    got = [st.assign(_t(a), _t(b), _t(c)) for a, b, c in zip(
        np.split(fi, cuts), np.split(fj, cuts), np.split(sz, cuts))]
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert st.n_assigned == fi.size


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trial", [2, 5, 11, 23])
def test_up_masks_set_delta_and_reset_core(trial, policy):
    """One stream of chunks through both states, with cores masked, a
    drifted delay set and cleared, and a core reset between chunks."""
    inst = _trace_instance() if trial == 23 else _random_instance(trial)
    _pos, _cid, fi, fj, sz = _flows(inst)
    K = inst.K
    states = _pair(policy, inst, seed=trial)
    rng = np.random.default_rng(100 + trial)
    cuts = np.sort(rng.integers(0, fi.size + 1, 7))
    chunks = list(zip(np.split(fi, cuts), np.split(fj, cuts),
                      np.split(sz, cuts)))
    for step, (a, b, c) in enumerate(chunks):
        up = None
        if step % 2 == 1 and K > 1:
            up = rng.random(K) < 0.6
            up[rng.integers(K)] = True
        elif step == 2:
            up = np.ones(K, dtype=bool)  # all up: the unmasked loop
        _feed(states, a, b, c, up=up)
        if step == 1:
            for s in states:
                s.set_delta(K - 1, inst.delta * 2.5 + 1.0)
        if step == 3:
            for s in states:
                s.reset_core(0)
        if step == 5:
            for s in states:
                s.set_delta(K - 1, inst.delta)  # back to nominal
    assert states[0]._drifted == states[1]._drifted


@pytest.mark.parametrize("locality", [0.5, 2.0, 16.0])
@pytest.mark.parametrize("trial", [3, 8, 14])
def test_locality_matches_reference(trial, locality):
    """The batch-affinity bias scopes to each call: the same chunks give
    the reference's choices, with and without masks and drift."""
    inst = _random_instance(trial)
    _pos, _cid, fi, fj, sz = _flows(inst)
    states = _pair("tau-aware", inst, locality=locality)
    cuts = np.linspace(0, fi.size, 5).astype(int)[1:-1]
    chunks = list(zip(np.split(fi, cuts), np.split(fj, cuts),
                      np.split(sz, cuts)))
    for step, (a, b, c) in enumerate(chunks):
        up = None
        if step == 2 and inst.K > 1:
            up = np.arange(inst.K) != 0
        _feed(states, a, b, c, up=up)
        if step == 0:
            for s in states:
                s.set_delta(0, inst.delta + 3.0)
    p = to_port(inst)
    pi = ref.order_coflows(inst)
    np.testing.assert_array_equal(
        port.assign_fast(p, torch.as_tensor(pi), locality=locality).numpy(),
        ref.assign_fast(inst, pi, locality=locality))


def test_random_probabilities_follow_numpy_summation():
    """RAND-ASSIGN's p = r / R, with R summed as numpy sums it, at K=9 (past
    the eight accumulators of numpy's pairwise sum)."""
    rng = np.random.default_rng(5)
    rates = rng.uniform(1.0, 30.0, 9)
    inst = ref.Instance(coflows=tuple(
        ref.Coflow(cid=m, demand=rng.exponential(5, (6, 6)), weight=1.0)
        for m in range(20)), rates=rates, delta=1.0)
    pi = ref.order_coflows(inst)
    np.testing.assert_array_equal(
        port.assign_fast(to_port(inst), torch.as_tensor(pi), "random",
                         seed=3).numpy(),
        ref.assign_fast(inst, pi, "random", seed=3))


_ONE = (np.zeros(1, np.int64), np.zeros(1, np.int64), np.ones(1))


@pytest.mark.parametrize("args, kw, act, match", [
    (("nope", [10.0]), {}, None, "unknown policy"),
    (("tau-aware", [10.0]), {"locality": -1.0}, None, "locality"),
    (("tau-aware", [10.0, 5.0]), {}, lambda s, f: s.set_delta(0, -1.0),
     "drifted delta"),
    (("rho-only", [10.0, 5.0]), {}, lambda s, f: s.reset_core(2),
     "out of range"),
    (("random", [10.0, 5.0]), {},
     lambda s, f: s.assign(*f, up=np.array([True])), "up mask must have shape"),
    (("tau-aware", [10.0, 5.0]), {},
     lambda s, f: s.assign(*f, up=np.array([False, False])), "no core is up"),
])
def test_rejects_what_the_reference_rejects(args, kw, act, match):
    policy, rates = args
    for State, flows in ((RefState, _ONE),
                         (PortState, tuple(_t(a) for a in _ONE))):
        with pytest.raises(ValueError, match=match):
            st = State(policy, np.array(rates), 1.0, 4, **kw)
            if act is not None:
                act(st, flows)


def test_assign_fast_rejects_unknown_policy():
    p = to_port(_random_instance(0))
    with pytest.raises(ValueError, match="unknown policy"):
        port.assign_fast(p, port.order_coflows(p), "nope")
