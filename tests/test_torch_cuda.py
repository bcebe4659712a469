"""The port on a CUDA card: the assignment kernel vs its plain version.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) with ``nvcc``; they
carry the ``cuda`` marker and skip elsewhere. This file imports neither
``jax`` nor ``repro``, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as port
from repro_torch.kernels import coflow_assign as ca
from repro_torch.kernels.ops import coflow_assign

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flows(dev, F, K, N, seed, n_distinct=None):
    rng = np.random.default_rng(seed)
    ports = rng.choice(N, size=min(N, n_distinct or N), replace=False)
    fi = ports[rng.integers(0, ports.size, F)].astype(np.int32)
    fj = ports[rng.integers(0, ports.size, F)].astype(np.int32)
    sz = (rng.exponential(50, F) + 0.1).astype(np.float32)
    rates = np.sort(rng.uniform(5, 30, K)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (fi, fj, sz, rates))


# (F, K, N, delta): the reference kernel tests' CASES, one core, a full warp
# of cores, the trace's N, and N=512 whose bitmap lives in global memory.
SHAPES = [(64, 3, 16, 8.0), (200, 4, 32, 2.0), (129, 5, 16, 0.5),
          (32, 2, 8, 0.0), (300, 1, 12, 2.0), (500, 32, 64, 1.0),
          (1000, 8, 150, 8.0), (1000, 8, 512, 8.0)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_kernel_equals_plain_version(dev, shape):
    F, K, N, delta = shape
    args = _flows(dev, F, K, N, seed=F + K, n_distinct=48)
    before = ca.launches
    got = ca.coflow_assign_cuda(*args, delta, n_ports=N)
    torch.cuda.synchronize()
    assert ca.launches == before + 1
    want = ca.coflow_assign_plain(*args, delta, n_ports=N)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_empty_flow_list_launches_nothing(dev):
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    before = ca.launches
    out = ca.coflow_assign_cuda(e, e, e.float(),
                                torch.tensor([10.0, 20.0], device=dev), 2.0,
                                n_ports=8)
    assert out.shape == (0,) and out.dtype == torch.int32
    assert ca.launches == before


def test_wrapper_rejects_what_the_kernel_cannot_take(dev):
    fi, fj, sz, rates = _flows(dev, 10, 33, 8, seed=0)
    with pytest.raises(ValueError, match="K <= 32"):
        ca.coflow_assign_cuda(fi, fj, sz, rates, 1.0, n_ports=8)
    fi, fj, sz, rates = _flows(dev, 10, 3, 8, seed=0)
    with pytest.raises(ValueError, match="int32"):
        ca.coflow_assign_cuda(fi.long(), fj, sz, rates, 1.0, n_ports=8)


def test_ops_launches_the_kernel_for_cuda_tensors(dev):
    fi, fj, sz, rates = _flows(dev, 256, 3, 16, seed=1)
    before = ca.launches
    got = coflow_assign(fi.long(), fj.long(), sz.double(), rates.double(),
                        8.0, n_ports=16)
    assert ca.launches == before + 1
    want = ca.coflow_assign_plain(fi, fj, sz, rates, 8.0, n_ports=16)
    assert torch.equal(got, want)


def test_run_fast_on_the_card_equals_the_cpu_run(dev):
    trace = port.synth_fb_trace(200, seed=7)
    runs = {d: port.run_fast(port.sample_instance(
        trace, N=24, M=60, rates=[10, 20, 30], delta=8.0, seed=3, device=d))
        for d in (dev, "cpu")}
    gpu, cpu = runs[dev], runs["cpu"]
    port.validate(gpu)
    for name in ("core", "t_establish", "t_complete", "ccts"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
