"""The port's sweep API vs the reference's, on the CPU.

``repro_torch.core.run_batch`` runs the grid serially in grid order; each
row must equal the reference's row exactly, apart from ``wall_s``: the
weighted sum, the total and the tail quantiles are reduced by numpy on the
host, as the reference reduces them. ``backend`` defaults to the
reference's ``"numpy"``.
"""
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from test_online_differential import _random_instance, _releases
from test_torch_coflow import to_port
from test_torch_online import to_port_online

SUMS = ("weighted_cct", "total_cct", "p95", "p99")


def assert_same_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = g.as_dict(), w.as_dict()
        for key in ("instance", "algorithm", "scheduling", "seed", "n_flows",
                    "makespan") + SUMS:
            assert g[key] == w[key], (key, g, w)
        assert g["wall_s"] >= 0.0


def _grid():
    """Two offline instances, one online instance and one offline instance
    given releases through the keyword."""
    insts = [_random_instance(t) for t in (1, 2, 3, 4)]
    online = ref.OnlineInstance(inst=insts[2],
                                releases=_releases(insts[2], "bursty", 3))
    rel = _releases(insts[3], "uniform", 4)
    return ([insts[0], insts[1], online, insts[3]], [None, None, None, rel])


@pytest.mark.parametrize("materialize", ["full", "metrics"])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_run_batch_rows_match_reference(backend, materialize):
    insts, rel = _grid()
    kw = dict(seeds=(0, 5), schedulings=("work-conserving", "priority-guard",
                                         "reserving"),
              check="validate" if materialize == "full" else "none",
              materialize=materialize)
    want = ref.run_batch(insts, ref.ALGORITHMS, releases=rel, workers=0,
                         backend={"kernel": "pallas"}.get(backend, backend),
                         **kw)
    got = port.run_batch(
        [to_port_online(i) if isinstance(i, ref.OnlineInstance)
         else to_port(i) for i in insts], port.ALGORITHMS,
        releases=[None if r is None else torch.from_numpy(r) for r in rel],
        backend=backend, **kw)
    assert_same_rows(got.rows, want.rows)


@pytest.mark.parametrize("workers", [None, 0, 1])
def test_pair_seeds_and_serial_workers(workers):
    insts = [_random_instance(t) for t in (6, 7, 8)]
    kw = dict(seeds=(3, 1, 4), pair_seeds=True,
              schedulings=("reserving", "work-conserving"))
    want = ref.run_batch(insts, ("rand-assign", "rand-sunflow", "ours"),
                         workers=0, **kw)
    got = port.run_batch([to_port(i) for i in insts],
                         ("rand-assign", "rand-sunflow", "ours"),
                         workers=workers, **kw)
    assert_same_rows(got.rows, want.rows)


def test_rows_equal_direct_engine_runs():
    """A row's metrics are those of the point's own run."""
    o = to_port_online(ref.OnlineInstance(
        inst=_random_instance(9), releases=_releases(_random_instance(9),
                                                     "uniform", 9)))
    tab = port.run_batch([o], ("ours", "sunflow-core"))
    s = port.run_fast_online(o, "sunflow-core")
    row = tab.filter(algorithm="sunflow-core").rows[0]
    assert row.scheduling == "sunflow" and row.n_flows == s.n_flows
    assert row.weighted_cct == port.weighted_cct(s)
    assert row.p99 == port.tail_cct(s, 0.99)


def test_empty_instance_gives_zero_rows():
    empty = port.instance_from_arrays(np.zeros((0, 3, 3)), np.zeros(0),
                                      np.zeros(0, np.int64), [10.0, 20.0],
                                      2.0, device="cpu")
    for kw in (dict(check="validate"),
               dict(check="none", materialize="metrics")):
        tab = port.run_batch([empty], port.ALGORITHMS, **kw)
        assert len(tab) == len(port.ALGORITHMS)
        for r in tab:
            assert r.weighted_cct == r.total_cct == r.p95 == r.p99 == 0.0
            assert r.makespan == 0.0 and r.n_flows == 0


def test_result_table_slicing_and_empty_filter():
    tab = port.run_batch([to_port(_random_instance(0))], ("ours", "rho-assign"),
                         schedulings=("work-conserving", "reserving"))
    assert len(tab) == 4 and repr(tab) == "ResultTable(4 rows)"
    assert len(tab.filter(algorithm="ours")) == 2
    col = tab.column("weighted_cct", scheduling="reserving")
    assert col.shape == (2,)
    assert tab.mean("weighted_cct", algorithm="ours") > 0
    assert [d["algorithm"] for d in tab.to_dicts()] == \
        ["ours", "ours", "rho-assign", "rho-assign"]
    with pytest.raises(ValueError, match="no rows match"):
        tab.column("weighted_cct", algorithm="bogus")


@pytest.mark.parametrize("kw, match", [
    (dict(algorithms=("nope",)), "unknown algorithms"),
    (dict(check="bogus"), "unknown check"),
    (dict(backend="bogus"), "unknown backend"),
    (dict(materialize="bogus"), "unknown materialize"),
    (dict(materialize="metrics"), "requires"),
    (dict(pair_seeds=True, seeds=(0, 1)), "pair_seeds"),
    (dict(releases=[None, None]), "releases must align"),
])
def test_run_batch_rejects_what_the_reference_rejects(kw, match):
    inst = _random_instance(0)
    for run, i in ((ref.run_batch, inst), (port.run_batch, to_port(inst))):
        with pytest.raises(ValueError, match=match):
            run([i], **{"workers": 0, **kw})


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_pool_rows_equal_serial_and_reference(backend):
    """``workers=2`` (a spawn pool) gives the serial rows and the
    reference's, offline and online, under ``check="oracle"``."""
    insts, rel = _grid()
    kw = dict(seeds=(0,), schedulings=("work-conserving", "reserving"),
              check="oracle")
    want = ref.run_batch(insts, ref.ALGORITHMS, releases=rel, workers=0,
                         backend={"kernel": "pallas"}.get(backend, backend),
                         **kw)
    pinsts = [to_port_online(i) if isinstance(i, ref.OnlineInstance)
              else to_port(i) for i in insts]
    prel = [None if r is None else torch.from_numpy(r) for r in rel]
    serial = port.run_batch(pinsts, port.ALGORITHMS, releases=prel,
                            backend=backend, workers=0, **kw)
    pooled = port.run_batch(pinsts, port.ALGORITHMS, releases=prel,
                            backend=backend, workers=2, **kw)
    assert_same_rows(pooled.rows, want.rows)
    assert_same_rows(pooled.rows, serial.rows)


def test_worker_point_rebuilds_the_instance_from_host_arrays():
    """What a worker is sent is host data only, and its point gives the
    serial row, with the kernels' launches it made (none on the CPU)."""
    from repro_torch.core import batch

    o = to_port_online(ref.OnlineInstance(
        inst=_random_instance(5), releases=_releases(_random_instance(5),
                                                     "uniform", 5)))
    point = (0, o.inst, o.releases, "ours", "reserving", 2, "validate",
             "kernel", "full")
    host = batch._host_point(*point)
    assert not any(torch.is_tensor(x) for x in host)
    assert all(isinstance(a, np.ndarray) for a in host[1]) and \
        host[3] == "cpu"
    row, launches = batch._run_point(host)
    assert launches == {"chain_sm90": 0, "lanes_sm90": 0}
    assert_same_rows([row], [batch._run_one(*point)])
