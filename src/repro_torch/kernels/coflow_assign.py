"""Tau-aware greedy cross-core flow assignment (Alg. 1 lines 5-17).

Port of the Pallas TPU kernel ``_assign_kernel`` (``repro.kernels.
coflow_assign``). One function, in three versions:

  - :func:`coflow_assign_cuda`, the wrapper of two hand-written Hopper
    kernels, chosen by the number of cores K: ``"chain_sm90"``
    (``csrc/coflow_assign_sm90.cu``, 1 <= K <= 8: the chain of choices in
    registers, the per-core arithmetic spread over a warp's lanes, flows
    streamed by a producer warp) and ``"warp"`` (``csrc/coflow_assign.cu``,
    9 <= K <= 32: one warp, lane k owns core k).
    The notes in the sources give each design and what bounds it.
  - :func:`coflow_assign_plain`, the plain PyTorch version: the same
    sequential fp32 chain in the same operation order, one flow at a time.
    The CPU tests and ``chip_smoke.py`` hold both kernels to it bit for bit.

All return the same choices as the Pallas kernel, including its argmin
tie-break (lowest core). ``launches`` counts the kernels' launches and
``launches_by_kernel`` splits the count by kernel, so a run can show which
kernel served its main path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["coflow_assign_cuda", "coflow_assign_plain", "launches",
           "launches_by_kernel", "KERNELS", "kernel_for", "MAX_CORES",
           "CHAIN_MAX_CORES", "SMEM_LIMIT"]

#: Lanes of the warp kernel's one warp: it gives each core one lane.
MAX_CORES = 32
#: Cores the chain kernel serves: every lane holds all K candidates.
CHAIN_MAX_CORES = 8
#: Shared memory a block may use on Hopper (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232_448
#: Kernel name -> csrc source.
KERNELS = {"chain_sm90": "coflow_assign_sm90", "warp": "coflow_assign"}
#: The chain kernel's flow ring (``kChunk`` flows a stage, ``kStages``
#: stages in ``csrc/coflow_assign_sm90.cu``).
CHAIN_CHUNK, CHAIN_STAGES = 512, 4

launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)


def kernel_for(k_cores: int) -> str:
    """The kernel that serves K cores: ``"chain_sm90"`` for K <= 8, else
    ``"warp"``."""
    return "chain_sm90" if k_cores <= CHAIN_MAX_CORES else "warp"


def coflow_assign_plain(fi: torch.Tensor, fj: torch.Tensor,
                        sizes: torch.Tensor, rates: torch.Tensor,
                        delta: float, *, n_ports: int) -> torch.Tensor:
    """The plain PyTorch version: choices ``(F,)`` int32 on the inputs' device.

    Per flow it evaluates, for all cores at once,
    ``li = (row_load[:, i] + d) * (1/r) + (row_tau[:, i] + new) * delta``
    and ``lj`` likewise, ``cand = max(bound, max(li, lj))``, takes the
    first argmin and commits with a one-hot mask as the Pallas kernel does.
    Each step is a separate fp32 operation, so nothing is contracted.
    """
    dev = fi.device
    k_cores = rates.shape[0]
    rates = rates.to(torch.float32)
    inv_rates = torch.ones_like(rates) / rates
    delta32 = torch.tensor(delta, dtype=torch.float32, device=dev)
    row_load = torch.zeros((k_cores, n_ports), dtype=torch.float32, device=dev)
    col_load = torch.zeros_like(row_load)
    row_tau = torch.zeros_like(row_load)
    col_tau = torch.zeros_like(row_load)
    nz = torch.zeros((k_cores, n_ports, n_ports), dtype=torch.float32,
                     device=dev)
    bound = torch.zeros(k_cores, dtype=torch.float32, device=dev)
    iota_k = torch.arange(k_cores, device=dev)
    out = torch.empty(fi.shape[0], dtype=torch.int32, device=dev)
    sizes = sizes.to(torch.float32)
    for t, (i, j) in enumerate(zip(fi.tolist(), fj.tolist())):
        d = sizes[t]
        new = 1.0 - nz[:, i, j]
        li = (row_load[:, i] + d) * inv_rates + (row_tau[:, i] + new) * delta32
        lj = (col_load[:, j] + d) * inv_rates + (col_tau[:, j] + new) * delta32
        cand = torch.maximum(bound, torch.maximum(li, lj))
        k_star = torch.argmin(cand)  # first minimum: ties -> lowest core
        one_hot = (iota_k == k_star).to(torch.float32)
        row_load[:, i] += d * one_hot
        col_load[:, j] += d * one_hot
        row_tau[:, i] += new * one_hot
        col_tau[:, j] += new * one_hot
        nz[:, i, j] = torch.maximum(nz[:, i, j], one_hot)
        bound = torch.maximum(bound, cand * one_hot)
        out[t] = k_star
    return out


def _chain_smem_layout(k_cores: int, n_ports: int) -> tuple[int, bool]:
    """The chain kernel's (shared bytes, bitmap in shared): mbarriers, the
    flow ring (16 B a flow), the choice ring (4 B), row and col state
    (``[N][K]`` pairs of fp32 load and tau) and, while it fits, the
    byte-per-cell bitmap."""
    ring = CHAIN_CHUNK * CHAIN_STAGES
    fixed = 16 * CHAIN_STAGES + ring * (16 + 4) + 2 * n_ports * k_cores * 8
    if fixed + n_ports * n_ports <= SMEM_LIMIT:
        return fixed + n_ports * n_ports, True
    return fixed, False


def _smem_layout(k_cores: int, n_ports: int) -> tuple[int, int, int, bool]:
    """The warp kernel's (stride, bitmap words per core, shared bytes,
    bitmap in shared)."""
    stride = n_ports | 1  # odd row stride: the K lanes hit K distinct banks
    loads = 4 * k_cores * stride * 4
    words = (n_ports * n_ports + 31) // 32
    if loads + k_cores * words * 4 <= SMEM_LIMIT:
        return stride, words, loads + k_cores * words * 4, True
    return stride, words, loads, False


def coflow_assign_cuda(fi: torch.Tensor, fj: torch.Tensor,
                       sizes: torch.Tensor, rates: torch.Tensor,
                       delta: float, *, n_ports: int,
                       kernel: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream; choices ``(F,)`` int32.

    Takes ``fi``/``fj`` int32, ``sizes`` float32 (all ``(F,)``) and
    ``rates`` float32 ``(K,)``, contiguous, on one CUDA device. ``kernel``
    is ``None`` (``kernel_for(K)``: the chain kernel for K <= 8, the warp
    kernel above) or a name of ``KERNELS``, so a test can run the warp
    kernel at K <= 8 beside the chain kernel; ``ops.coflow_assign`` never
    names one. Raises on anything else, on K > 32 (K > 8 for the chain
    kernel), and when the build or the launch fails. F = 0 returns an empty
    tensor without a launch.
    """
    global launches
    k_cores = rates.shape[0]
    if not 1 <= k_cores <= MAX_CORES:
        raise ValueError(f"the kernel gives each core one lane of a warp: "
                         f"1 <= K <= {MAX_CORES}, got K={k_cores}")
    name = kernel_for(k_cores) if kernel is None else kernel
    if name not in KERNELS:
        raise ValueError(f"kernel must be None or one of {list(KERNELS)}, "
                         f"got {kernel!r}")
    if name == "chain_sm90" and k_cores > CHAIN_MAX_CORES:
        raise ValueError(f"the chain kernel holds K <= {CHAIN_MAX_CORES} "
                         f"cores in registers, got K={k_cores}")
    tensors = (fi, fj, sizes, rates)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("coflow_assign_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("coflow_assign_cuda inputs must share one device")
    if (fi.dtype, fj.dtype, sizes.dtype, rates.dtype) != (
            torch.int32, torch.int32, torch.float32, torch.float32):
        raise ValueError("coflow_assign_cuda takes int32 ports and float32 "
                         "sizes and rates")
    n_flows = fi.shape[0]
    if any(t.ndim != 1 or not t.is_contiguous() for t in tensors) \
            or fj.shape[0] != n_flows or sizes.shape[0] != n_flows:
        raise ValueError("coflow_assign_cuda takes contiguous 1-D inputs "
                         "with one length F")
    if name == "chain_sm90":
        smem, nz_shared = _chain_smem_layout(k_cores, n_ports)
        nz_bytes = n_ports * n_ports
    else:
        stride, words, smem, nz_shared = _smem_layout(k_cores, n_ports)
        nz_bytes = 4 * k_cores * words
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={k_cores}, N={n_ports}: the {name} kernel's "
                         f"state needs {smem} B of shared memory, more than "
                         f"the {SMEM_LIMIT} B a block can have")
    out = torch.empty(n_flows, dtype=torch.int32, device=fi.device)
    if n_flows == 0:
        return out
    lib = _build.load(KERNELS[name])
    nz = None if nz_shared else torch.zeros(
        nz_bytes, dtype=torch.uint8, device=fi.device)
    nz_ptr = None if nz is None else nz.data_ptr()
    with torch.cuda.device(fi.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (fi.data_ptr(), fj.data_ptr(), sizes.data_ptr(),
                rates.data_ptr())
        if name == "chain_sm90":
            fn = lib.coflow_assign_sm90_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + \
                [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            err = fn(*ptrs, float(delta), n_flows, k_cores, n_ports, nz_ptr,
                     out.data_ptr(), stream)
        else:
            fn = lib.coflow_assign_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + \
                [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p]
            err = fn(*ptrs, float(delta), n_flows, k_cores, n_ports, stride,
                     words, nz_ptr, smem, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"coflow_assign {name} kernel launch failed: CUDA "
                           f"error {err} (K={k_cores}, N={n_ports}, "
                           f"F={n_flows}, {smem} B shared)")
    launches += 1
    launches_by_kernel[name] += 1
    return out
