"""The port's collectives-as-coflows layer against the reference's, on the
CPU: group decoding, block demand matrices, coflows and circuit plans.

The same ``CollectiveOp`` fields go through both packages' ``decode_groups``
/ ``collective_demands`` / ``step_coflows``, and the same coflows through
both ``plan_circuits`` and ``plan_circuits_service`` (both plan in fp64 on
the host; the port's instance is on the CPU here): the demand matrices, the
coflows and every ``PlanReport.row()`` are bit-equal. Then the reference's
own cases (``tests/test_analysis.py``, ``tests/test_comm_planner.py``) on
the port.
"""
import numpy as np
import pytest

import repro.analysis.hlo as ref_hlo
import repro.comm as ref_comm
import repro.comm.planner as ref_planner
import repro.core as ref_core
import repro_torch.analysis.collectives as port_coll
import repro_torch.comm as port_comm
import repro_torch.core as port_core

ALGS = ref_core.ALGORITHMS

#: (kind, operand bytes, result bytes, group size, trip_mult, metadata) on
#: the (2, 2, 2) mesh of 4 blocks and the (2, 16, 16) mesh of 32 blocks
OPS_8 = [
    ("all-reduce", 800, 800, 8, 1, "[1,8]<=[8]"),
    ("all-gather", 256, 512, 2, 3, "{{0,2},{1,3},{4,6},{5,7}}"),
    ("reduce-scatter", 4096, 2048, 2, 2, "{{0,4},{1,5},{2,6},{3,7}}"),
    ("all-to-all", 100, 100, 4, 1, "[2,4]<=[2,2,2]T(1,0,2)"),
    ("all-reduce", 64, 64, 2, 5, "{{0,1},{2,3},{4,5},{6,7}}"),
    ("collective-permute", 8, 8, 2, 1, "|st={0,2},{2,4},{4,6},{6,0}"),
]
OPS_512 = [
    ("all-gather", 1 << 20, 1 << 24, 16, 22,
     "[32,16]<=[2,16,16]T(0,2,1)"),
    ("reduce-scatter", 1 << 24, 1 << 20, 16, 22,
     "[32,16]<=[2,16,16]T(0,2,1)"),
    ("all-reduce", 4096, 4096, 2, 1, "[256,2]<=[2,256]T(1,0)"),
]


def _mk_coflows(Coflow, seed=0, m=12, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for cid in range(m):
        D = np.zeros((n, n))
        for _ in range(rng.integers(2, 10)):
            D[rng.integers(n), rng.integers(n)] += rng.exponential(1e9)
        out.append(Coflow(cid=cid, demand=D, weight=float(rng.integers(1, 5))))
    return out


def _maps(mesh_shape):
    return (ref_comm.BlockMap.from_mesh_shape(mesh_shape, ("pod", "data")),
            port_comm.BlockMap.from_mesh_shape(mesh_shape, ("pod", "data")))


@pytest.mark.parametrize("ops, mesh_shape", [
    (OPS_8, {"pod": 2, "data": 2, "model": 2}),
    (OPS_512, {"pod": 2, "data": 16, "model": 16}),
], ids=["2x2x2", "2x16x16"])
def test_demands_and_coflows_bit_equal(ops, mesh_shape):
    rmap, pmap = _maps(mesh_shape)
    np.testing.assert_array_equal(rmap.block_of, pmap.block_of)
    assert (rmap.n_blocks, rmap.n_devices) == (pmap.n_blocks, pmap.n_devices)
    rops = [ref_hlo.CollectiveOp(*o) for o in ops]
    pops = [port_coll.CollectiveOp(*o) for o in ops]
    for r, p in zip(rops, pops):
        assert ref_comm.decode_groups(r, rmap.n_devices) == \
            port_comm.decode_groups(p, pmap.n_devices)
        assert ref_comm.decode_pairs(r) == port_comm.decode_pairs(p)
        for trips in (True, False):
            np.testing.assert_array_equal(
                ref_comm.collective_demands(r, rmap, include_trips=trips),
                port_comm.collective_demands(p, pmap, include_trips=trips))
        assert (r.wire_bytes, r.total_operand_bytes) == \
            (p.wire_bytes, p.total_operand_bytes)
    ran = ref_hlo.HLOAnalysis(flops=0.0, hbm_bytes=0.0, collectives=rops)
    pan = port_coll.HLOAnalysis(flops=0.0, hbm_bytes=0.0, collectives=pops)
    assert ran.collective_counts() == pan.collective_counts()
    assert ran.collective_operand_bytes == pan.collective_operand_bytes
    assert ran.collective_wire_bytes == pan.collective_wire_bytes
    for kw in (dict(), dict(unroll_trips=True), dict(weights="bytes")):
        rc = ref_comm.step_coflows(ran, rmap, **kw)
        pc = port_comm.step_coflows(pan, pmap, **kw)
        assert len(rc) == len(pc) > 0
        for a, b in zip(rc, pc):
            assert (a.cid, a.weight, a.total_bytes) == \
                (b.cid, b.weight, b.total_bytes)
            np.testing.assert_array_equal(a.demand, b.demand.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_rows_bit_equal(seed):
    fab_r = ref_comm.OCSFabric(rates=(25e9, 50e9), delta=5e-3)
    fab_p = port_comm.OCSFabric(rates=(25e9, 50e9), delta=5e-3)
    want = ref_comm.plan_circuits(_mk_coflows(ref_core.Coflow, seed), fab_r)
    got = port_comm.plan_circuits(_mk_coflows(port_core.Coflow, seed), fab_p,
                                  device="cpu")
    assert list(got) == list(want) == list(ALGS)
    for alg in ALGS:
        assert got[alg].row() == want[alg].row(), alg


def test_plan_rows_of_a_step_bit_equal():
    """The coflows of OPS_512 on the default fabric, the phase-16 shape."""
    rmap, pmap = _maps({"pod": 2, "data": 16, "model": 16})
    rc = ref_comm.step_coflows(ref_hlo.HLOAnalysis(
        0.0, 0.0, [ref_hlo.CollectiveOp(*o) for o in OPS_512]), rmap)
    pc = port_comm.step_coflows(port_coll.HLOAnalysis(
        0.0, None, [port_coll.CollectiveOp(*o) for o in OPS_512]), pmap)
    want = ref_comm.plan_circuits(rc)
    got = port_comm.plan_circuits(pc, device="cpu")
    for alg in ALGS:
        assert got[alg].row() == want[alg].row(), alg


def test_plan_circuits_service_rows_cache_and_degraded():
    want, rmgr = ref_planner.plan_circuits_service(
        _mk_coflows(ref_core.Coflow))
    got, pmgr = port_comm.plan_circuits_service(
        _mk_coflows(port_core.Coflow), device="cpu")
    for alg in ALGS:
        assert got[alg].row() == want[alg].row(), alg
        assert not got[alg].cached and not got[alg].degraded
    again, _ = port_comm.plan_circuits_service(
        _mk_coflows(port_core.Coflow), manager=pmgr, device="cpu")
    assert all(r.cached for r in again.values())
    pmgr.report_fault(port_core.CoreDown(t=0.0, core=0))
    rmgr.report_fault(ref_core.CoreDown(t=0.0, core=0))
    down, _ = port_comm.plan_circuits_service(
        _mk_coflows(port_core.Coflow), manager=pmgr, device="cpu")
    want_down, _ = ref_planner.plan_circuits_service(
        _mk_coflows(ref_core.Coflow), manager=rmgr)
    for alg in ALGS:
        r = down[alg]
        assert r.degraded and not r.cached
        assert 0 not in set(r.program.core.tolist())
        assert r.row() == want_down[alg].row(), alg


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_wire_bytes_model():
    CollectiveOp = port_coll.CollectiveOp
    assert CollectiveOp("all-reduce", 1000, 1000, 4, 2).wire_bytes == \
        int(2 * 3 / 4 * 1000) * 2
    assert CollectiveOp("all-gather", 250, 1000, 4, 1).wire_bytes == \
        int(3 / 4 * 1000)
    assert CollectiveOp("collective-permute", 500, 500, 2, 3).wire_bytes \
        == 1500


def test_group_decoding():
    CollectiveOp = port_coll.CollectiveOp
    c = CollectiveOp("all-reduce", 10, 10, 2, 1, metadata="{{0,1},{2,3}}")
    assert port_comm.decode_groups(c, 4) == [[0, 1], [2, 3]]
    c2 = CollectiveOp("all-gather", 10, 40, 4, 1, metadata="[2,4]<=[8]")
    assert port_comm.decode_groups(c2, 8) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    c3 = CollectiveOp("all-gather", 10, 20, 2, 1,
                      metadata="[2,2]<=[2,2]T(1,0)")
    assert port_comm.decode_groups(c3, 4) == [[0, 2], [1, 3]]
    c4 = CollectiveOp("collective-permute", 8, 8, 2, 1,
                      metadata="|st={0,1},{1,0}")
    assert port_comm.decode_pairs(c4) == [(0, 1), (1, 0)]


def test_block_demand_matrices():
    CollectiveOp = port_coll.CollectiveOp
    bmap = port_comm.BlockMap.from_mesh_shape(
        {"pod": 2, "data": 2, "model": 2}, ("pod", "data"))
    assert bmap.n_blocks == 4 and bmap.n_devices == 8
    np.testing.assert_array_equal(bmap.block_of, [0, 0, 1, 1, 2, 2, 3, 3])
    c = CollectiveOp("all-reduce", 800, 800, 8, 1, metadata="[1,8]<=[8]")
    D = port_comm.collective_demands(c, bmap)
    per_dev = 2 * 800 * 7 / 8
    assert D[0, 1] == per_dev and D[1, 2] == per_dev and D[3, 0] == per_dev
    assert D[0, 0] == 0
    c2 = CollectiveOp("all-to-all", 100, 100, 2, 1, metadata="{{0,1}}")
    assert port_comm.collective_demands(c2, bmap).sum() == 0


def test_plan_circuits_feasible_and_bounded():
    cfs = _mk_coflows(port_core.Coflow)
    reports = port_comm.plan_circuits(
        cfs, port_comm.OCSFabric(rates=(25e9, 50e9), delta=5e-3),
        device="cpu")
    for alg, r in reports.items():
        port_core.validate(r.schedule)
        port_core.check_lemma1(r.schedule)
    ours = reports["ours"]
    port_core.check_theorem1(ours.schedule)
    port_core.check_theorem2(ours.schedule)
    assert ours.weighted_cct > 0
    assert ours.ideal_lb_sum <= ours.total_cct + 1e-9
