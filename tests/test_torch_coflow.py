"""Port data model vs the reference: instances, demand math, WSPT order,
flow extraction and the trace sampler, on the CPU.

Every equality here is exact: the port sums in numpy's order, draws from
numpy's PCG64 and sorts stably, so the reference's floats, permutations and
flow lists come out bit for bit.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch
import repro_torch.core as port
from test_engine_differential import N_RANDOM_INSTANCES, _random_instance

SRC = Path(__file__).resolve().parents[1] / "src"


def to_port(inst: "ref.Instance") -> "port.Instance":
    """The same instance in the port, on the CPU."""
    N = inst.N
    demand = (np.stack([c.demand for c in inst.coflows]) if inst.M
              else np.zeros((0, N, N)))
    return port.instance_from_arrays(
        demand, inst.weights, np.array([c.cid for c in inst.coflows]),
        inst.rates, inst.delta, device="cpu")


def mk_inst(demands, rates=(10, 20, 30), delta=8.0, weights=None, cids=None):
    cs = [ref.Coflow(cid=idx if cids is None else cids[idx],
                     demand=np.asarray(d, dtype=float),
                     weight=1.0 if weights is None else weights[idx])
          for idx, d in enumerate(demands)]
    return ref.Instance(coflows=tuple(cs), rates=np.asarray(rates, float),
                        delta=delta)


def _core_grid():
    """The hand-built and seeded instances of tests/test_coflow_core.py,
    plus one with free cids and one with an all-zero coflow."""
    D2 = np.array([[2.0, 3.0], [0.0, 5.0]])
    big = np.full((3, 3), 10.0)
    small = np.eye(3)
    rng = np.random.default_rng(1)
    seeded = [rng.exponential(10, (6, 6)) * (rng.random((6, 6)) < 0.5)
              for _ in range(8)]
    rng = np.random.default_rng(4)
    heavy = [rng.exponential(10, (8, 8)) * (rng.random((8, 8)) < 0.4)
             for _ in range(10)]
    return [
        mk_inst([D2]),
        mk_inst([big, small], weights=[1.0, 10.0]),
        mk_inst([D2, D2, D2]),
        mk_inst(seeded),
        mk_inst(heavy, weights=list(rng.integers(1, 11, 10).astype(float))),
        mk_inst([np.zeros((4, 4)), np.diag([1.0, 2.0, 0.0, 3.0])]),
        mk_inst(seeded[:3], cids=[7, 3, 11], rates=(10,), delta=0.0),
    ]


GRID = _core_grid() + [_random_instance(t) for t in range(N_RANDOM_INSTANCES)]


@pytest.mark.parametrize("idx", range(len(GRID)))
def test_order_and_flows_match_reference(idx):
    inst = GRID[idx]
    p = to_port(inst)
    np.testing.assert_array_equal(port.priority_scores(p).numpy(),
                                  ref.priority_scores(inst))
    pi = ref.order_coflows(inst)
    np.testing.assert_array_equal(port.order_coflows(p).numpy(), pi)
    want = ref.extract_flows(inst, pi)
    got = port.extract_flows(p, torch.as_tensor(pi))
    for name, w, g in zip(("pos", "cid", "fi", "fj", "size"), want, got):
        assert g.dtype == torch.from_numpy(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("idx", range(len(GRID)))
def test_demand_math_matches_reference(idx):
    inst = GRID[idx]
    p = to_port(inst)
    assert p.R == inst.R
    for m, c in enumerate(inst.coflows):
        D = p.demand[m]
        np.testing.assert_array_equal(port.row_loads(D).numpy(),
                                      ref.row_loads(c.demand))
        np.testing.assert_array_equal(port.col_loads(D).numpy(),
                                      ref.col_loads(c.demand))
        assert port.rho(D) == ref.rho(c.demand)
        assert port.tau(D) == ref.tau(c.demand)
        assert port.global_lb(D, inst.R, inst.delta) == ref.global_lb(
            c.demand, inst.R, inst.delta)
        for r in inst.rates:
            assert port.per_core_lb(D, float(r), inst.delta) == ref.per_core_lb(
                c.demand, float(r), inst.delta)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 127, 128, 129, 150, 300, 512])
def test_port_sums_follow_numpy_order(n):
    """Rows wider than numpy's 128-element pairwise block split as numpy
    does; columns of a square demand add up top to bottom."""
    rng = np.random.default_rng(n)
    D = rng.exponential(10, (n, n)) * (rng.random((n, n)) < 0.6)
    np.testing.assert_array_equal(port.row_loads(torch.from_numpy(D)).numpy(),
                                  D.sum(axis=1))
    np.testing.assert_array_equal(port.col_loads(torch.from_numpy(D)).numpy(),
                                  D.sum(axis=0))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(N=16, M=40),
    dict(N=8, M=30, weight_mode="unit"),
    dict(N=12, M=20, machine_map="fold", weight_mode="normal",
         weight_params=(5.0, 2.0)),
])
def test_sample_instance_matches_reference(seed, kw):
    tr = ref.synth_fb_trace(120, seed=seed + 5)
    tp = port.synth_fb_trace(120, seed=seed + 5)
    assert [dataclass_tuple(t) for t in tp] == [dataclass_tuple(t) for t in tr]
    rinst = ref.sample_instance(tr, rates=[10, 20, 30], delta=8.0, seed=seed, **kw)
    pinst = port.sample_instance(tp, rates=[10, 20, 30], delta=8.0, seed=seed,
                                 device="cpu", **kw)
    np.testing.assert_array_equal(
        pinst.demand.numpy(), np.stack([c.demand for c in rinst.coflows]))
    np.testing.assert_array_equal(pinst.weights.numpy(), rinst.weights)
    np.testing.assert_array_equal(pinst.cids.numpy(),
                                  [c.cid for c in rinst.coflows])
    np.testing.assert_array_equal(pinst.rates.numpy(), rinst.rates)
    assert pinst.delta == rinst.delta


def dataclass_tuple(t):
    return (t.cid, t.arrival_ms, t.mappers, t.reducers, t.reducer_mb)


def test_extract_flows_empty_instance():
    p = port.instance_from_arrays(np.zeros((0, 3, 3)), np.zeros(0),
                                  np.zeros(0, np.int64), [10.0], 1.0,
                                  device="cpu")
    pos, cid, fi, fj, size = port.extract_flows(p, port.order_coflows(p))
    assert all(t.numel() == 0 for t in (pos, cid, fi, fj, size))
    assert size.dtype == torch.float64


@pytest.mark.parametrize("bad, match", [
    (dict(demand=-np.ones((1, 2, 2))), "non-negative"),
    (dict(demand=np.ones((1, 2, 3))), "float64 \\(M, N, N\\)"),
    (dict(weights=np.zeros(1)), "weights must be positive"),
    (dict(rates=np.array([10.0, 0.0])), "rates"),
    (dict(delta=-1.0), "delta"),
])
def test_instance_rejects_bad_input(bad, match):
    args = dict(demand=np.ones((1, 2, 2)), weights=np.ones(1),
                cids=np.zeros(1, np.int64), rates=np.array([10.0]), delta=1.0)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        port.instance_from_arrays(**args, device="cpu")


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.kernels.ops, repro_torch.core.assignment, "
            "repro_torch.core.online, repro_torch.core.batch, "
            "repro_torch.core.arrays, repro_torch.core.fabric, "
            "repro_torch.core.fault, repro_torch.obs, "
            "repro_torch.obs.clock, repro_torch.obs.metrics, "
            "repro_torch.obs.trace, repro_torch.service, "
            "repro_torch.service.admission, repro_torch.service.cache, "
            "repro_torch.service.manager, repro_torch.service.program\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.sample_instance(port.synth_fb_trace(10, seed=0), N=4, M=2,
                             rates=[10.0], delta=1.0)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
