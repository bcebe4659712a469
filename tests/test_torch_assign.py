"""The assignment kernel's plain version vs the reference kernel and oracle.

On the CPU, ``repro_torch.kernels.ops.coflow_assign`` runs
``coflow_assign_plain``, the sequential fp32 twin of the CUDA kernel (which
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold to it bit for bit on
the card). Here it must give exactly the choices of the Pallas kernel in
interpret mode and of the numpy oracle ``assign_ref`` at fp32 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
from repro.kernels.coflow_assign import coflow_assign_fwd
from repro.kernels.ref import assign_ref
from repro_torch.kernels import coflow_assign as ca
from repro_torch.kernels.hazards import HAZARD_DISTANCES, KINDS, hazard_stream
from repro_torch.kernels.ops import coflow_assign
from test_kernels_assign import CASES


def _random_flows(rng, F, K, N, scale=50.0):
    fi = rng.integers(0, N, F).astype(np.int32)
    fj = rng.integers(0, N, F).astype(np.int32)
    sz = (rng.exponential(scale, F) + 0.1).astype(np.float32)
    rates = np.sort(rng.uniform(5, 30, K)).astype(np.float32)
    return fi, fj, sz, rates


def _three_way(fi, fj, sz, rates, delta, N, block_f=256):
    """(plain version, Pallas interpret, assign_ref) choices."""
    plain = ca.coflow_assign_plain(torch.from_numpy(fi), torch.from_numpy(fj),
                                   torch.from_numpy(sz),
                                   torch.from_numpy(rates), delta, n_ports=N)
    pallas = coflow_assign_fwd(jnp.array(fi), jnp.array(fj), jnp.array(sz),
                               jnp.array(rates), delta, n_ports=N,
                               block_f=block_f, interpret=True)
    oracle, _ = assign_ref(fi, fj, sz, rates, delta, N)
    assert plain.dtype == torch.int32
    return plain.numpy(), np.asarray(pallas), oracle


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_plain_matches_pallas_and_oracle_on_cases(case):
    F, K, N, delta, bf = case
    rng = np.random.default_rng(F + K)
    fi = rng.integers(0, N, F).astype(np.int32)
    fj = rng.integers(0, N, F).astype(np.int32)
    sz = rng.exponential(50, F).astype(np.float32)
    rates = np.sort(rng.uniform(5, 30, K)).astype(np.float32)
    plain, pallas, oracle = _three_way(fi, fj, sz, rates, delta, N, bf)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)


def test_plain_empty_flow_list():
    e = torch.zeros(0, dtype=torch.int32)
    out = ca.coflow_assign_plain(e, e, torch.zeros(0), torch.tensor([10.0, 20.0]),
                                 2.0, n_ports=8)
    assert out.shape == (0,) and out.dtype == torch.int32


def test_plain_single_block_small_f():
    rng = np.random.default_rng(0)
    F, N = 5, 8
    fi = rng.integers(0, N, F).astype(np.int32)
    fj = rng.integers(0, N, F).astype(np.int32)
    sz = (rng.exponential(20, F) + 0.1).astype(np.float32)
    rates = np.array([10.0, 20.0, 30.0], np.float32)
    plain, pallas, oracle = _three_way(fi, fj, sz, rates, 4.0, N)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)


# (F, K, N) x (delta, seed): repeated port pairs (small N), one core, a full
# warp of cores, the trace's N, F past the Pallas block size; zero and
# fractional delta. delta and the data are traced, so each shape compiles the
# interpret-mode kernel once.
SHAPES = [(300, 3, 6), (257, 1, 12), (220, 32, 16), (333, 3, 150), (128, 8, 9)]
GRID = [(*s, delta, seed) for s in SHAPES
        for delta, seed in ((8.0, 0), (0.7 if s[1] != 1 else 0.0, 1))]


@pytest.mark.parametrize("case", GRID, ids=[str(c) for c in GRID])
def test_plain_matches_pallas_and_oracle_on_seeded_grid(case):
    F, K, N, delta, seed = case
    rng = np.random.default_rng([F, K, N, seed])
    plain, pallas, oracle = _three_way(*_random_flows(rng, F, K, N), delta, N)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)


def test_plain_matches_pallas_and_oracle_on_trace_instance():
    trace = ref.synth_fb_trace(200, seed=7)
    inst = ref.sample_instance(trace, N=24, M=60, rates=[10, 20, 30],
                               delta=8.0, seed=3)
    _pos, _cid, fi, fj, sz = ref.extract_flows(inst, ref.order_coflows(inst))
    assert fi.size > 3000
    plain, pallas, oracle = _three_way(
        fi.astype(np.int32), fj.astype(np.int32), sz.astype(np.float32),
        inst.rates.astype(np.float32), inst.delta, inst.N)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)


def test_ops_casts_like_reference_ops():
    """int64/fp64 flow tensors, as extract_flows gives them, are cast to the
    kernel's int32/fp32 exactly as ``repro.kernels.ops.coflow_assign``
    casts them; the CPU runs the plain version and launches nothing."""
    from repro.kernels.ops import coflow_assign as ref_assign

    rng = np.random.default_rng(3)
    fi = rng.integers(0, 12, 200)
    fj = rng.integers(0, 12, 200)
    sz = rng.exponential(30, 200) + 1e-3
    rates = np.array([10.0, 20.0, 30.0])
    before = ca.launches
    got = coflow_assign(torch.from_numpy(fi), torch.from_numpy(fj),
                        torch.from_numpy(sz), torch.from_numpy(rates), 8.0,
                        n_ports=12)
    assert ca.launches == before
    want = ref_assign(fi, fj, sz, rates, 8.0, n_ports=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cuda_wrapper_rejects_cpu_tensors_and_bad_shapes():
    f = torch.zeros(4, dtype=torch.int32)
    sz = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ca.coflow_assign_cuda(f, f, sz, torch.ones(3), 1.0, n_ports=4)


# ---------------------------------------------------------------------------
# Hazard streams: flows that repeat the ports of a flow 1..4 steps before,
# runs of one egress port, exact ties and zero sizes. The chain kernel
# forwards exactly these in registers; tests/test_torch_cuda.py holds it to
# the plain version on all of them, and here the plain version is held to
# the Pallas kernel and the oracle on a few (K, N) of each kind.
# ---------------------------------------------------------------------------
HAZARD_CASES = [("cell@1", 3, 8), ("col@2", 8, 150), ("row@3", 5, 8),
                ("mixed", 4, 150), ("run", 2, 150), ("ties", 6, 8),
                ("zeros", 3, 150), ("cell@4", 1, 512)]


@pytest.mark.parametrize("case", HAZARD_CASES, ids=[str(c) for c in HAZARD_CASES])
def test_plain_matches_pallas_and_oracle_on_hazard_streams(case):
    kind, K, N = case
    fi, fj, sz, rates, delta = hazard_stream(kind, K, N)
    plain, pallas, oracle = _three_way(fi, fj, sz, rates, delta, N)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)


@pytest.mark.parametrize("kind", KINDS)
def test_hazard_streams_hit_their_hazard(kind):
    """Each stream is made from its seed alone and hits what it is named
    for, often: a port repeated at its distance, a run of one egress port,
    ties, zero sizes."""
    fi, fj, sz, rates, delta = hazard_stream(kind, 3, 150)
    again = hazard_stream(kind, 3, 150)
    for a, b in zip((fi, fj, sz, rates), again[:4]):
        np.testing.assert_array_equal(a, b)
    assert fi.dtype == fj.dtype == np.int32 and sz.dtype == np.float32
    assert fi.min() >= 0 and fj.max() < 150 and rates.shape == (3,)
    if "@" in kind:
        what, d = kind.split("@")
        d = int(d)
        assert d in HAZARD_DISTANCES
        same_i = np.mean(fi[d:] == fi[:-d])
        same_j = np.mean(fj[d:] == fj[:-d])
        if what in ("row", "cell"):
            assert same_i > 0.4
        if what in ("col", "cell"):
            assert same_j > 0.4
    elif kind == "run":
        assert np.mean(fj[1:] == fj[:-1]) > 0.9
    elif kind == "ties":
        assert delta == 0.0 and np.unique(rates).size == 1
        assert np.unique(sz).size == 1
    elif kind == "zeros":
        assert np.mean(sz == 0.0) > 0.4
    else:  # mixed: every distance and port set shows up
        assert np.mean(fj[1:] == fj[:-1]) > 0.05
        assert np.mean(fi[4:] == fi[:-4]) > 0.05


def test_routing_and_kernel_choice():
    """K <= 8 goes to the chain kernel, 9 and up to the lanes kernel; a
    named kernel is checked before anything is launched."""
    assert [ca.kernel_for(k) for k in (1, 3, 8, 9, 32)] == [
        "chain_sm90", "chain_sm90", "chain_sm90", "lanes_sm90", "lanes_sm90"]
    f = torch.zeros(4, dtype=torch.int32)
    sz = torch.ones(4)
    with pytest.raises(ValueError, match="one of"):
        ca.coflow_assign_cuda(f, f, sz, torch.ones(3), 1.0, n_ports=4,
                              kernel="fast")
    with pytest.raises(ValueError, match="K <= 8"):
        ca.coflow_assign_cuda(f, f, sz, torch.ones(9), 1.0, n_ports=4,
                              kernel="chain_sm90")
    assert set(ca.launches_by_kernel) == set(ca.KERNELS)


def test_lanes_kernel_serves_every_k_above_eight():
    """Every K from 9 up is the lanes kernel's: in registers up to 32 lanes
    of LANES_PER_LANE cores (256), in memory past that (257, 512, 1024).
    Each K passes the wrapper's checks of K and reaches the one that the
    tensors lie on the card; K < 1 does not."""
    assert ca.LANES_PER_LANE == 8
    assert {ca.kernel_for(k) for k in range(9, 1025)} == {"lanes_sm90"}
    f = torch.zeros(4, dtype=torch.int32)
    sz = torch.ones(4)
    for k in (33, 64, 100, 256, 257, 512, 1024):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ca.coflow_assign_cuda(f, f, sz, torch.ones(k), 1.0, n_ports=4)
    with pytest.raises(ValueError, match="1 <= K"):
        ca.coflow_assign_cuda(f, f, sz, torch.ones(0), 1.0, n_ports=4)


# (K, N, state in shared, bitmap in shared): C = 1 at N = 150 holds both;
# the state of N = 512 goes global, and so does the bitmap with it; at
# K = 64 (C = 2), N = 150 the state stays and the bitmap goes; C = 8 at
# N = 8 holds both. Past 256 cores (C = 9, 16, 32) the cores' pairs take
# shared memory first: beside both at N = 8, beside the state alone at
# K = 1024, N = 11, beside neither at N = 150.
LANES_LAYOUTS = [(9, 8, True, True), (16, 150, True, True),
                 (32, 150, True, True), (32, 512, False, False),
                 (33, 150, True, False), (64, 150, True, False),
                 (100, 24, True, True), (256, 8, True, True),
                 (256, 150, False, False), (257, 8, True, True),
                 (257, 150, False, False), (512, 8, True, True),
                 (1024, 11, True, False), (1024, 150, False, False)]


@pytest.mark.parametrize("K, N, state_shared, nz_shared", LANES_LAYOUTS)
def test_lanes_kernel_layout(K, N, state_shared, nz_shared):
    """The lanes kernel's shared and global bytes, reckoned by hand: the
    ring's 4 stages of 512 flows at 16 B in and 4 B out, 8 mbarriers of
    8 B and 32 lanes' slots of two (load, tau) pairs and a choice; past
    8 cores a lane, a (bound, 1/r) fp32 pair a core; row and col state of
    C planes of 32 (load, tau) fp32 pairs a port, and C 32-bit words a
    cell of bitmap; the state goes to shared memory first, the bitmap after
    it, each while the block's 227 KB hold it."""
    c, smem, state_global, nz_global = ca._lanes_layout(K, N)
    assert c == -(-K // 32) and 32 * (c - 1) < K <= 32 * c
    ring = 4 * 512 * (16 + 4) + 8 * 8 + 32 * (8 + 8 + 4)
    ring += 32 * c * (4 + 4) if c > ca.LANES_PER_LANE else 0
    state = 2 * N * (32 * c) * (4 + 4)
    bitmap = N * N * c * 4
    assert smem == ring + (state if state_shared else 0) + (
        bitmap if nz_shared else 0)
    assert smem <= ca.SMEM_LIMIT
    assert state_global == (0 if state_shared else state)
    assert nz_global == (0 if nz_shared else bitmap)
    if not nz_shared:  # it went global because it did not fit
        assert ring + (state if state_shared else 0) + bitmap > ca.SMEM_LIMIT


# The lanes kernel's cores: one a lane (9, 16, 32), two (33, 64, the
# second lane of core 32 alone at K = 33), four (100: lanes 25-31 padding),
# then past its registers, nine (257: core 256 alone on lane 28's ninth;
# 300: lanes 30-31 padding). Every K meets exact ties, and one more hazard
# kind each.
LANES_HAZARDS = [(K, kind, N) for K, other, N in (
    (9, "cell@1", 8), (16, "col@2", 24), (32, "mixed", 12),
    (33, "row@3", 24), (64, "cell@3", 8), (100, "zeros", 24),
    (257, "cell@2", 8), (300, "mixed", 12))
    for kind in ("ties", other)]


@pytest.mark.parametrize("case", LANES_HAZARDS,
                         ids=[str(c) for c in LANES_HAZARDS])
def test_plain_matches_pallas_and_oracle_past_eight_cores(case):
    """The K the lanes kernel serves: the plain version (which
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel to bit
    for bit) against the Pallas kernel in interpret mode and the oracle."""
    K, kind, N = case
    fi, fj, sz, rates, delta = hazard_stream(kind, K, N, n_flows=300)
    plain, pallas, oracle = _three_way(fi, fj, sz, rates, delta, N)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, oracle)
    if kind == "ties":  # every core ties on the first flow: the lowest wins
        assert plain[0] == 0


@pytest.mark.parametrize("K, N, nz_shared", [
    (3, 150, True), (8, 150, True), (8, 512, False), (1, 400, True)])
def test_chain_kernel_layout(K, N, nz_shared):
    """The chain kernel's bitmap (a byte per cell) stays in shared memory
    while it fits beside the ring and the state, else it goes global."""
    smem, shared = ca._chain_smem_layout(K, N)
    assert shared is nz_shared
    assert smem <= ca.SMEM_LIMIT
    ring = ca.CHAIN_CHUNK * ca.CHAIN_STAGES
    assert smem == 16 * ca.CHAIN_STAGES + 20 * ring + 16 * N * K + (
        N * N if shared else 0)
