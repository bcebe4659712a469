"""Tau-aware greedy cross-core flow assignment (Alg. 1 lines 5-17).

Port of the Pallas TPU kernel ``_assign_kernel`` (``repro.kernels.
coflow_assign``). Two versions of one function live here:

  - :func:`coflow_assign_cuda`, the wrapper of the hand-written Hopper
    kernel ``csrc/coflow_assign.cu`` (one warp, lane k owns core k; see the
    note in the source for its design and what bounds it);
  - :func:`coflow_assign_plain`, the plain PyTorch version: the same
    sequential fp32 chain in the same operation order, one flow at a time.
    The CPU tests and ``chip_smoke.py`` hold the kernel to it bit for bit.

Both return the same choices as the Pallas kernel, including its argmin
tie-break (lowest core). ``launches`` counts the kernel's launches, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["coflow_assign_cuda", "coflow_assign_plain", "launches",
           "MAX_CORES", "SMEM_LIMIT"]

#: Lanes of the one warp: the kernel gives each core one lane.
MAX_CORES = 32
#: Shared memory a block may use on Hopper (227 KB, opt-in above 48 KB).
SMEM_LIMIT = 232_448

launches = 0


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


def _smem_layout(k_cores: int, n_ports: int) -> tuple[int, int, int, bool]:
    """(stride, bitmap words per core, shared bytes, bitmap in shared)."""
    stride = n_ports | 1  # odd row stride: the K lanes hit K distinct banks
    loads = 4 * k_cores * stride * 4
    words = (n_ports * n_ports + 31) // 32
    if loads + k_cores * words * 4 <= SMEM_LIMIT:
        return stride, words, loads + k_cores * words * 4, True
    return stride, words, loads, False


def coflow_assign_cuda(fi: torch.Tensor, fj: torch.Tensor,
                       sizes: torch.Tensor, rates: torch.Tensor,
                       delta: float, *, n_ports: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; choices ``(F,)`` int32.

    Takes ``fi``/``fj`` int32, ``sizes`` float32 (all ``(F,)``) and
    ``rates`` float32 ``(K,)``, contiguous, on one CUDA device. Raises on
    anything else, on K > 32, and when the launch fails. F = 0 returns an
    empty tensor without a launch.
    """
    global launches
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
    k_cores = rates.shape[0]
    if not 1 <= k_cores <= MAX_CORES:
        raise ValueError(f"the kernel gives each core one lane of a warp: "
                         f"1 <= K <= {MAX_CORES}, got K={k_cores}")
    stride, words, smem, nz_shared = _smem_layout(k_cores, n_ports)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={k_cores}, N={n_ports}: the load and tau "
                         f"arrays need {smem} B of shared memory, more than "
                         f"the {SMEM_LIMIT} B a block can have")
    out = torch.empty(n_flows, dtype=torch.int32, device=fi.device)
    if n_flows == 0:
        return out
    lib = _build.load("coflow_assign")
    fn = lib.coflow_assign_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    nz = None if nz_shared else torch.zeros(
        k_cores * words, dtype=torch.int32, device=fi.device)
    with torch.cuda.device(fi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fi.data_ptr(), fj.data_ptr(), sizes.data_ptr(),
                 rates.data_ptr(), float(delta), n_flows, k_cores, n_ports,
                 stride, words, None if nz is None else nz.data_ptr(), smem,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"coflow_assign kernel launch failed: CUDA error "
                           f"{err} (K={k_cores}, N={n_ports}, F={n_flows}, "
                           f"{smem} B shared)")
    launches += 1
    return out
