"""The port on a CUDA card: each kernel vs its plain version, and runs on the
card against runs on the CPU.

Every test here needs an NVIDIA GPU (Hopper, sm_90a) with ``nvcc``; they
carry the ``cuda`` marker and skip elsewhere. This file imports neither
``jax`` nor ``repro``, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as port
import ctypes

from repro_torch.kernels import _build
from repro_torch.kernels import coflow_assign as ca
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.hazards import FLASH_SHAPES, KINDS, hazard_stream
from repro_torch.kernels.ops import coflow_assign, flash_attention
from repro_torch.models.api import ModelConfig, build_model, model_class
from repro_torch.models.attention import attend
from repro_torch.models.dense import DenseLM
from repro_torch.serve.engine import build_decode, build_prefill

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
        trace, N=24, M=60, rates=[10, 20, 30], delta=8.0, seed=3, device=d),
        backend="kernel") for d in (dev, "cpu")}
    gpu, cpu = runs[dev], runs["cpu"]
    port.validate(gpu)
    for name in ("core", "t_establish", "t_complete", "ccts"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name


def _on(dev, fi, fj, sz, rates):
    return tuple(torch.as_tensor(a, device=dev) for a in (fi, fj, sz, rates))


@pytest.mark.parametrize("n_ports", [8, 150, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_chain_kernel_equals_plain_on_hazard_streams(dev, kind, n_ports):
    """The chain kernel forwards the commits of the flows just ahead in
    registers: held to the plain version on streams that hit every such
    hazard, for every K it serves (1..8)."""
    for K in range(1, ca.CHAIN_MAX_CORES + 1):
        fi, fj, sz, rates, delta = hazard_stream(kind, K, n_ports)
        args = _on(dev, fi, fj, sz, rates)
        before = dict(ca.launches_by_kernel)
        got = ca.coflow_assign_cuda(*args, delta, n_ports=n_ports)
        torch.cuda.synchronize()
        assert ca.launches_by_kernel == {
            **before, "chain_sm90": before["chain_sm90"] + 1}
        want = ca.coflow_assign_plain(*args, delta, n_ports=n_ports)
        assert torch.equal(got, want), (kind, K, n_ports)


@pytest.mark.parametrize("K", [9, 32])
@pytest.mark.parametrize("kind", ["cell@1", "col@2", "mixed", "ties"])
def test_warp_kernel_serves_more_than_eight_cores(dev, kind, K):
    fi, fj, sz, rates, delta = hazard_stream(kind, K, 150)
    args = _on(dev, fi, fj, sz, rates)
    before = dict(ca.launches_by_kernel)
    got = ca.coflow_assign_cuda(*args, delta, n_ports=150)
    assert ca.launches_by_kernel == {**before, "warp": before["warp"] + 1}
    assert torch.equal(got, ca.coflow_assign_plain(*args, delta, n_ports=150))


@pytest.mark.parametrize("K, N", [(3, 150), (8, 512)])
def test_chain_kernel_equals_warp_kernel_at_length(dev, K, N):
    """At 20,000 flows, where the plain version is slow, the two kernels
    agree choice for choice (the warp kernel named for the comparison)."""
    args = _flows(dev, 20_000, K, N, seed=K * N, n_distinct=40)
    chain = ca.coflow_assign_cuda(*args, 8.0, n_ports=N)
    warp = ca.coflow_assign_cuda(*args, 8.0, n_ports=N, kernel="warp")
    assert torch.equal(chain, warp)


def test_chain_kernel_layout_agrees_with_the_source(dev):
    fn = _build.load("coflow_assign_sm90").coflow_assign_sm90_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for K in range(1, 9):
        for N in (8, 150, 400, 512):
            smem, shared = ca._chain_smem_layout(K, N)
            assert fn(K, N, int(shared)) == smem


def test_run_fast_goes_through_the_chain_kernel(dev):
    trace = port.synth_fb_trace(200, seed=7)
    inst = port.sample_instance(trace, N=24, M=60, rates=[10, 20, 30],
                                delta=8.0, seed=3, device=dev)
    before = dict(ca.launches_by_kernel)
    port.run_fast(inst, backend="kernel")
    assert ca.launches_by_kernel == {
        **before, "chain_sm90": before["chain_sm90"] + 1}


def _small_online(device, span=400.0):
    return port.sample_online_instance(
        port.synth_fb_trace(200, seed=7), N=24, M=60, rates=[10, 20, 30],
        delta=8.0, span=span, seed=3, device=device)


def test_run_fast_online_goes_through_the_chain_kernel(dev):
    oinst = _small_online(dev)
    before = dict(ca.launches_by_kernel)
    s = port.run_fast_online(oinst, backend="kernel")
    assert ca.launches_by_kernel == {
        **before, "chain_sm90": before["chain_sm90"] + 1}
    port.validate(s, releases=oinst.releases)


@pytest.mark.parametrize("kw", [dict(backend="numpy"), dict(),
                                dict(locality=0.5, backend="kernel"),
                                dict(delta_k=[8.0, 12.0, 8.0],
                                     backend="kernel")])
def test_host_backend_runs_launch_no_kernel(dev, kw):
    """``backend="numpy"``, ``locality > 0`` and a drifted ``delta_k`` run
    the fp64 host backend, offline and online, and launch nothing."""
    oinst = _small_online(dev)
    before = dict(ca.launches_by_kernel)
    for alg in ("ours", "sunflow-core"):
        port.run_fast(oinst.inst, alg, **kw)
        port.run_fast_online(oinst, alg, **kw)
    assert ca.launches_by_kernel == before


@pytest.mark.parametrize("online", [False, True])
def test_cross_check_on_the_card_launches_the_chain_kernel_once(dev, online):
    """The kernel gate reads the engine's own choices: one launch, through
    ``run_fast*``; the checked schedule equals the CPU's, and the oracle
    grid point given it launches nothing more."""
    runs = {d: _small_online(d) for d in (dev, "cpu")}
    gate = port.cross_check_online if online else port.cross_check
    arg = {d: runs[d] if online else runs[d].inst for d in runs}
    before = dict(ca.launches_by_kernel)
    gpu = gate(arg[dev], "ours", backend="kernel")
    assert ca.launches_by_kernel == {
        **before, "chain_sm90": before["chain_sm90"] + 1}
    gate(arg[dev], "ours", backend="kernel", fast=gpu)
    assert ca.launches_by_kernel["chain_sm90"] == before["chain_sm90"] + 1
    cpu = gate(arg["cpu"], "ours", backend="kernel")
    for name in ("pi", "core", "t_establish", "ccts"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    tab = port.run_batch([arg[dev]], ("ours", "rho-assign"), seeds=(3,),
                         check="oracle", backend="kernel")
    assert ca.launches_by_kernel["chain_sm90"] == before["chain_sm90"] + 2
    assert tab.rows[0].weighted_cct == port.weighted_cct(gpu)


def test_certificates_on_the_card_equal_the_cpu_run(dev):
    runs = {d: _small_online(d).inst for d in (dev, "cpu")}
    s = {d: port.run(runs[d], "ours") for d in runs}
    assert s[dev].ccts.device.type == "cuda"
    for fn in (port.check_lemma1, port.check_lemma2, port.check_theorem1,
               lambda x: port.check_lemma3(x, strict=False),
               lambda x: port.check_theorem2(x, strict=False)):
        got, want = fn(s[dev]), fn(s["cpu"])
        for key in want:
            if torch.is_tensor(want[key]):
                assert torch.equal(got[key].cpu(), want[key])
            else:
                assert got[key] == want[key]


POINTS = [(a, s) for a in port.ALGORITHMS
          for s in (("sunflow",) if "sunflow" in a else
                    ("work-conserving", "priority-guard", "reserving"))]


@pytest.mark.parametrize("backend", port.BACKENDS)
def test_online_grid_on_the_card_equals_the_cpu_run(dev, backend):
    runs = {d: _small_online(d) for d in (dev, "cpu")}
    for alg, sched in POINTS:
        kw = dict(seed=3, scheduling=sched, backend=backend)
        gpu = port.run_fast_online(runs[dev], alg, **kw)
        cpu = port.run_fast_online(runs["cpu"], alg, **kw)
        port.validate(gpu, releases=runs[dev].releases)
        for name in ("pi", "core", "t_establish", "t_complete", "ccts"):
            assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), \
                (alg, sched, name)


# ---------------------------------------------------------------------------
# The streaming fabric manager: the card against the CPU
# ---------------------------------------------------------------------------

def _serve_stream(device, N=16, M=80):
    """examples/serve_fabric.py's stream: N=16, M=80, released over the
    offline makespan."""
    trace = port.synth_fb_trace(526, seed=2026)
    off = port.sample_online_instance(trace, N=N, M=M, rates=[10, 20, 30],
                                      delta=8.0, span=0.0, seed=7,
                                      device="cpu")
    span = float(port.run_fast_online(off).ccts.max())
    return port.sample_online_instance(trace, N=N, M=M, rates=[10, 20, 30],
                                       delta=8.0, span=span, seed=7,
                                       device=device)


def _faulted_manager(device, span):
    from repro_torch.core import CoreDown, CoreUp, DeltaDrift, FaultInjector
    from repro_torch.core import PortFlap
    from repro_torch.service import FabricConfig, FabricManager

    inj = FaultInjector([
        CoreDown(t=0.25 * span, core=2), CoreUp(t=0.5 * span, core=2),
        PortFlap(t=0.6 * span, t_end=0.62 * span, core=1, port=0),
        DeltaDrift(t=0.7 * span, core=0, delta=12.0)])
    return FabricManager(FabricConfig(rates=(10.0, 20.0, 30.0), delta=8.0,
                                      N=16, faults=inj), device=device)


def _serve(mgr, oinst, n_ticks=12, late_fault=None):
    arrivals = list(port.arrival_stream(oinst))
    span = arrivals[-1][1]
    nxt, reports = 0, []
    for x, T in enumerate(np.linspace(span / n_ticks, span, n_ticks)):
        while nxt < len(arrivals) and arrivals[nxt][1] <= T:
            mgr.submit(*arrivals[nxt])
            nxt += 1
        reports.append(mgr.tick(float(T)))
        if late_fault is not None and x == n_ticks // 2:
            mgr.report_fault(late_fault(float(T)))
    reports.append(mgr.flush())
    return reports


def test_faulted_stream_on_the_card_equals_the_cpu_run(dev):
    from repro_torch.core import CoreDown

    runs = {}
    for d in (dev, "cpu"):
        oinst = _serve_stream(d)
        span = float(oinst.releases.max())
        mgr = _faulted_manager(d, span)
        before = dict(ca.launches_by_kernel)
        reports = _serve(mgr, oinst, late_fault=lambda T: CoreDown(
            t=T - 0.05 * span, core=2))
        assert ca.launches_by_kernel == before  # the streaming plane: none
        runs[d] = (mgr, reports)
    (gm, greps), (cm, creps) = runs[dev], runs["cpu"]
    for g, c in zip(greps, creps):
        assert g.program.device.type == "cuda"
        for name in ("core", "ingress", "egress", "cid", "size",
                     "t_establish", "t_complete"):
            assert torch.equal(getattr(g.program, name).cpu(),
                               getattr(c.program, name)), name
        assert (g.committed_flows, g.finalized, g.pending_flows,
                g.aborted) == (c.committed_flows, c.finalized,
                               c.pending_flows, c.aborted)
    assert torch.equal(gm.ccts().cpu(), cm.ccts())
    assert gm.state.aborted_keys() == cm.state.aborted_keys()
    program = gm.program()
    program.validate()
    assert program.device.type == "cuda"


def test_empty_program_lands_on_the_card_by_default(dev):
    from repro_torch.service import CircuitProgram, FabricConfig
    from repro_torch.service import FabricManager, merge_programs

    empty = CircuitProgram.empty((10.0, 20.0, 30.0), 8.0, 16)
    assert empty.device.type == "cuda" and empty.rates.device.type == "cuda"
    assert merge_programs([], [10.0, 20.0, 30.0], 8.0, 16).device.type == \
        "cuda"
    oinst = _serve_stream(dev)
    mgr = FabricManager(FabricConfig(rates=(10.0, 20.0, 30.0), delta=8.0,
                                     N=16), device=dev)
    assert mgr.program().device.type == "cuda"
    reports = _serve(mgr, oinst)
    merged = empty.merge(mgr.program())
    assert merged.device.type == "cuda"
    assert merged.n_segments == sum(r.committed_flows for r in reports)
    merged.validate()


def test_one_shot_plane_launches_the_chain_kernel_on_a_miss_only(dev):
    from repro_torch.service import FabricConfig, FabricManager

    inst = port.sample_instance(port.synth_fb_trace(200, seed=7), N=24,
                                M=60, rates=[10, 20, 30], delta=8.0, seed=3,
                                device=dev)
    mgr = FabricManager(FabricConfig(rates=(10.0, 20.0, 30.0), delta=8.0,
                                     N=24), device=dev)
    before = dict(ca.launches_by_kernel)
    miss, hit0 = mgr.schedule_instance(inst, backend="kernel")
    assert ca.launches_by_kernel == {
        **before, "chain_sm90": before["chain_sm90"] + 1}
    again, hit1 = mgr.schedule_instance(inst, backend="kernel")
    assert (hit0, hit1) == (False, True)
    assert ca.launches_by_kernel["chain_sm90"] == before["chain_sm90"] + 1
    for name in ("core", "cid", "t_establish", "t_complete"):
        assert torch.equal(getattr(miss, name), getattr(again, name))
    miss.validate()
    fp64, _ = mgr.schedule_instance(inst)  # the default: no launch
    assert ca.launches_by_kernel["chain_sm90"] == before["chain_sm90"] + 1
    fp64.validate()


# ---------------------------------------------------------------------------
# The flash-attention kernel vs its plain version
# ---------------------------------------------------------------------------

# (B, S, H, KVH, Dh, causal, window, dtype): tests/test_kernels_attention.py
# CASES, then Dh=128 with GQA, S not a multiple of 64, a window wider than S,
# a non-causal window, and a single row. bf16 goes to the sm90 kernel (2e-2),
# fp32 to the SIMT kernel (1e-5).
FA_CASES = [
    (2, 128, 4, 4, 64, True, None, torch.float32),
    (2, 256, 4, 2, 64, True, None, torch.float32),
    (1, 256, 8, 1, 128, True, None, torch.bfloat16),
    (2, 256, 4, 1, 64, True, 128, torch.bfloat16),
    (1, 128, 2, 2, 64, False, None, torch.float32),
    (1, 512, 4, 4, 128, True, 256, torch.float32),
    (3, 192, 6, 3, 64, True, None, torch.bfloat16),
    (2, 320, 8, 2, 128, True, None, torch.float32),
    (2, 200, 4, 2, 64, True, None, torch.float32),
    (1, 77, 4, 4, 128, True, 33, torch.bfloat16),
    (1, 130, 2, 1, 64, True, 1000, torch.float32),
    (2, 190, 4, 2, 64, False, 50, torch.float32),
    (1, 1, 2, 1, 64, True, None, torch.float32),
]
# The bf16 kernel's edges: every S around its 128-row tiles, both head dims,
# each mask and GQA group in turn; then every mask x group at one ragged S.
_MASKS = [(True, None), (True, 1), (True, 70), (True, 128), (True, 300),
          (False, None)]
_GROUPS = [1, 2, 8]
_EDGE_S = [1, 63, 64, 65, 127, 128, 129, 200, 2064]
FA_CASES += [
    (1 if S > 1000 else 2, S, 8, 8 // _GROUPS[i % 3], Dh,
     *_MASKS[i % len(_MASKS)], torch.bfloat16)
    for i, (S, Dh) in enumerate((S, Dh) for S in _EDGE_S for Dh in (64, 128))]
FA_CASES += [(1, 200, 8, 8 // g, 64, c, w, torch.bfloat16)
             for c, w in _MASKS for g in _GROUPS]


def _fa_inputs(dev, B, S, H, KVH, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                 device=dev).to(dtype)
                 for shape in ((B, S, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)))


def _fa_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_flash_kernel_equals_plain_version(dev, case):
    B, S, H, KVH, Dh, causal, window, dtype = case
    q, k, v = _fa_inputs(dev, B, S, H, KVH, Dh, dtype, seed=S * H + Dh)
    before, by_kernel = fa.launches, dict(fa.launches_by_kernel)
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    kernel = "sm90_bf16" if dtype == torch.bfloat16 else "simt_fp32"
    assert fa.launches_by_kernel == {
        **by_kernel, kernel: by_kernel[kernel] + 1}
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, S, H, Dh)
    tol = _fa_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_SHAPES,
                         ids=[str(c) for c in FLASH_SHAPES])
def test_flash_kernel_equals_plain_version_at_new_shapes(dev, case, dtype):
    B, Sq, Sk, H, KVH, Dh, causal, window = case
    rng = np.random.default_rng(Sq * 31 + Sk + Dh)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=dev).to(dtype)
               for shape in ((B, Sq, H, Dh), (B, Sk, KVH, Dh),
                             (B, Sk, KVH, Dh)))
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.shape == (B, Sq, H, Dh) and got.dtype == dtype
    tol = _fa_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_inputs(dev, dtype):
    """q, k, v as views of a fused (B, S, H + 2*KVH, Dh) tensor and of a
    (B, H, S, Dh) one: the kernel follows the strides, copies nothing."""
    B, S, H, KVH, Dh = 2, 160, 8, 2, 64
    rng = np.random.default_rng(11)
    fused = torch.as_tensor(rng.standard_normal(
        (B, S, H + 2 * KVH, Dh)).astype(np.float32), device=dev).to(dtype)
    q, k, v = fused.split([H, KVH, KVH], dim=2)
    bhsd = torch.as_tensor(rng.standard_normal((B, H, S, Dh)).astype(
        np.float32), device=dev).to(dtype).transpose(1, 2)
    for qq in (q, bhsd):
        assert not qq.is_contiguous()
        got = fa.flash_attention_cuda(qq, k, v, causal=True, window=70)
        want = fa.flash_attention_plain(qq.contiguous(), k.contiguous(),
                                        v.contiguous(), causal=True, window=70)
        tol = _fa_tol(dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_sm90_kernel_is_deterministic(dev):
    """Two launches on the same inputs give bitwise the same output."""
    q, k, v = _fa_inputs(dev, 2, 2064, 8, 2, 64, torch.bfloat16, seed=5)
    a = fa.flash_attention_cuda(q, k, v, causal=True)
    b = fa.flash_attention_cuda(q, k, v, causal=True)
    assert torch.equal(a, b)


def test_sm90_kernel_refuses_what_tma_cannot_load(dev):
    """A bf16 view whose Dh stride is not 1 raises; nothing is copied and
    no other kernel takes over."""
    q, k, v = _fa_inputs(dev, 1, 64, 4, 2, 128, torch.bfloat16, seed=0)
    before = dict(fa.launches_by_kernel)
    with pytest.raises(ValueError, match="Dh stride 1"):
        fa.flash_attention_cuda(q[..., ::2], k[..., ::2], v[..., ::2])
    assert fa.launches_by_kernel == before


def test_flash_wrapper_rejects_what_the_kernel_cannot_take(dev):
    q, k, v = _fa_inputs(dev, 1, 64, 4, 2, 32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(dev, 1, 64, 4, 2, 64, torch.float16, seed=0)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(dev, 1, 64, 4, 3, 64, torch.float32, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _fa_inputs(dev, 1, 64, 4, 2, 64, torch.float32, seed=0)
    pos = torch.arange(64, device=dev)[None]
    with pytest.raises(ValueError, match="q_positions"):
        flash_attention(q[:, :1], k, v, q_positions=pos[:, :1])
    before = fa.launches
    flash_attention(q[:, :1], k, v)  # Sq != Sk is the kernel's contract
    assert fa.launches == before + 1


def test_flash_kernel_launches_from_ops_and_attend(dev):
    q, k, v = _fa_inputs(dev, 1, 128, 4, 2, 64, torch.float32, seed=2)
    before = fa.launches
    a = flash_attention(q, k, v, causal=True)
    b = attend(q, k, v, impl="pallas", causal=True)
    assert fa.launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_dense_lm_on_the_card_equals_the_cpu_run(dev, dtype):
    """Prefill (flash kernel, 2 launches) and 3 greedy decode steps of a
    2-layer GQA model, on the card and on the CPU from the same weights."""
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=512, vocab=1000,
                      attention_impl="pallas", dtype=dtype)
    cpu = DenseLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gpu = DenseLM.from_state(cfg, {n: t.to(dev)
                                   for n, t in cpu.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 100)))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    kernel = "sm90_bf16" if dtype == torch.bfloat16 else "simt_fp32"
    runs = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        cache = model.make_caches(2, 104)
        before = fa.launches_by_kernel[kernel]
        logits, cache = build_prefill(model)(cache, {"tokens": tokens})
        launched = fa.launches_by_kernel[kernel] - before
        out = [logits.float().cpu()]
        nxt = tokens[:, -1:]
        for _ in range(3):
            nxt = out[-1][:, -1].argmax(-1)[:, None] if dtype == torch.float32 \
                else nxt  # bf16: feed the same tokens to both runs
            logits, cache = build_decode(model)(cache, nxt)
            out.append(logits.float().cpu())
        runs[name] = (launched, out)
    assert runs["gpu"][0] == cfg.n_layers and runs["cpu"][0] == 0
    for g, c in zip(runs["gpu"][1], runs["cpu"][1]):
        torch.testing.assert_close(g, c, atol=tol, rtol=tol)


# A tiny model of every other family: the prefill's launches and its and
# three decode steps' logits on the card equal the CPU run's.
_TINY = {
    "moe": dict(family="moe", n_layers=2, d_model=256, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab=500, n_experts=4, top_k=2),
    "vlm": dict(family="vlm", n_layers=2, d_model=256, n_heads=4,
                n_kv_heads=2, d_ff=256, vocab=500, n_prefix_tokens=16),
    "hybrid": dict(family="hybrid", n_layers=5, d_model=256, n_heads=1,
                   n_kv_heads=1, d_ff=256, vocab=500, window=40,
                   block_pattern=("rec", "rec", "attn"),
                   pattern_tail=("rec", "rec"), rnn_state_dim=256),
    "audio": dict(family="audio", n_layers=2, d_model=256, n_heads=4,
                  n_kv_heads=4, d_ff=256, vocab=499, vocab_pad_to=512,
                  norm="layer", enc_layers=2, dec_layers=2),
    "ssm": dict(family="ssm", n_layers=4, d_model=256, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab=500, slstm_period=2),
}
#: flash-kernel launches of one fresh prefill of each tiny config.
_TINY_LAUNCHES = {"moe": 2, "vlm": 2, "hybrid": 1, "audio": 6, "ssm": 0}


@pytest.mark.parametrize("family", list(_TINY))
def test_tiny_family_on_the_card_equals_the_cpu_run(dev, family):
    cfg = ModelConfig(name=f"tiny-{family}", attention_impl="pallas",
                      dtype=torch.float32, **_TINY[family])
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    gpu = model_class(family).from_state(
        cfg, {n: t.to(dev) for n, t in cpu.state_dict().items()})
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 100)))
    extra = {}
    if family == "vlm":
        extra["prefix_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
    if family == "audio":
        extra["src_frames"] = torch.as_tensor(rng.standard_normal(
            (2, 300, cfg.d_model)).astype(np.float32))
    kw = {"s_src": 300} if family == "audio" else {}
    runs = {}
    for name, model in (("gpu", gpu), ("cpu", cpu)):
        batch = {"tokens": tokens, **{k: v.to(model.device)
                                      for k, v in extra.items()}}
        cache = model.make_caches(2, 120, **kw)
        before = fa.launches_by_kernel["simt_fp32"]
        logits, cache = build_prefill(model)(cache, batch)
        launched = fa.launches_by_kernel["simt_fp32"] - before
        out = [logits.float().cpu()]
        for _ in range(3):
            nxt = out[-1][:, -1].argmax(-1)[:, None]
            logits, cache = build_decode(model)(cache, nxt)
            out.append(logits.float().cpu())
        runs[name] = (launched, out)
    assert runs["gpu"][0] == _TINY_LAUNCHES[family] and runs["cpu"][0] == 0
    for g, c in zip(runs["gpu"][1], runs["cpu"][1]):
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The pool and training on the card
# ---------------------------------------------------------------------------

def test_pool_on_the_card_counts_the_workers_launches(dev):
    """``run_batch(workers=2)`` over card instances: the rows of the serial
    run (but for ``wall_s``), and one chain-kernel launch per kernel point,
    counted in the workers and added here."""
    import dataclasses

    runs = [_small_online(dev), _small_online(dev).inst]
    kw = dict(schedulings=("work-conserving", "reserving"), backend="kernel")
    before = dict(ca.launches_by_kernel)
    pooled = port.run_batch(runs, ("ours", "sunflow-core"), workers=2, **kw)
    got = {k: ca.launches_by_kernel[k] - before[k] for k in before}
    assert got == {"chain_sm90": len(pooled), "warp": 0}
    serial = port.run_batch(runs, ("ours", "sunflow-core"), workers=0, **kw)
    assert [dataclasses.replace(r, wall_s=0.0) for r in pooled] == \
        [dataclasses.replace(r, wall_s=0.0) for r in serial]


@pytest.mark.parametrize("family", ["dense"] + list(_TINY))
def test_tiny_family_trains_on_the_card_as_on_the_cpu(dev, family):
    """fp32 loss and gradients of a tiny model of each family, card against
    CPU: the loss within 1e-5 relative, each leaf within 1e-4 x max|g|
    (``"chunked"`` where it engages, at S=2,048 for the dense model)."""
    spec = dict(family="dense", n_layers=2, d_model=128, n_heads=2,
                n_kv_heads=1, d_ff=256, vocab=500) if family == "dense" \
        else _TINY[family]
    cfg = ModelConfig(name=f"tiny-{family}", attention_impl="chunked",
                      dtype=torch.float32, **spec)
    S = 2048 if family == "dense" else 64
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    gpu = model_class(cfg.family).from_state(
        cfg, {n: t.to(dev) for n, t in cpu.state_dict().items()})
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, S))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab, (2, S)))}
    if family == "vlm":
        batch["prefix_embeds"] = torch.as_tensor(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
    if family == "audio":
        batch["src_frames"] = torch.as_tensor(rng.standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32))
    from repro_torch.train.step import loss_and_grads

    loss_c, g_c = loss_and_grads(cpu, lambda: cpu.loss(batch))
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    loss_g, g_g = loss_and_grads(gpu, lambda: gpu.loss(dbatch))
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    assert set(g_g) == set(g_c)
    for name, c in g_c.items():
        torch.testing.assert_close(g_g[name].cpu(), c, rtol=0,
                                   atol=1e-4 * float(c.abs().max()) + 1e-30,
                                   msg=name)


def test_train_loop_on_the_card(dev, tmp_path):
    """A tiny model trains through ``train_loop`` on the card: finite
    falling loss, a checkpoint, and a resume that continues the run (to
    1e-6: the card's gradient scatters may sum in another order)."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                      n_heads=2, n_kv_heads=1, d_ff=256, vocab=500,
                      attention_impl="chunked")
    kw = dict(global_batch=4, seq_len=2048, log_every=0, microbatches=2,
              opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                      total_steps=6))
    whole = train_loop(cfg, steps=6, **kw)
    losses = [h["loss"] for h in whole.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    train_loop(cfg, steps=4, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    resumed = train_loop(cfg, steps=6, ckpt_dir=str(tmp_path), **kw)
    np.testing.assert_allclose([h["loss"] for h in resumed.history],
                               losses[4:], rtol=1e-6)
    assert next(iter(whole.params.values())).device.type == "cuda"


def test_pallas_training_raises_on_the_card(dev):
    cfg = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=128,
                      n_heads=2, n_kv_heads=1, d_ff=256, vocab=500,
                      attention_impl="pallas")
    model = build_model(cfg, device=dev)
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = torch.zeros((1, 128), dtype=torch.int64, device=dev)
    before = fa.launches
    with pytest.raises(ValueError, match="no backward"):
        model.loss({"tokens": tokens, "labels": tokens})
    assert fa.launches == before
