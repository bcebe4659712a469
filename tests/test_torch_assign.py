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


@pytest.mark.parametrize("K, N, nz_shared", [
    (3, 150, True), (8, 150, True), (8, 512, False), (32, 64, True)])
def test_bitmap_placement(K, N, nz_shared):
    """The nonzero bitmap stays in shared memory while K*N^2 bits fit beside
    the loads, else it moves to a global scratch buffer."""
    stride, words, smem, shared = ca._smem_layout(K, N)
    assert shared is nz_shared
    assert stride % 2 == 1 and stride >= N
    assert words * 32 >= N * N
    assert smem <= ca.SMEM_LIMIT
