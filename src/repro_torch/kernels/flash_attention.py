"""Blocked causal/local GQA attention forward (flash attention).

Port of the Pallas TPU kernel ``_fa_kernel`` (``repro.kernels.
flash_attention``). One function, in three versions:

  - :func:`flash_attention_cuda`, the wrapper of two hand-written Hopper
    kernels, chosen by dtype: bfloat16 goes to
    ``csrc/flash_attention_sm90.cu`` (``"sm90_bf16"``: TMA loads of 128-row
    q tiles and 128-row kv tiles, 64-row at Dh=256, both products on the
    tensor cores with ``wgmma``, fp32 online softmax, P rounded to bf16
    before P.V), float32 to
    ``csrc/flash_attention.cu`` (``"simt_fp32"``: fp32 products on the CUDA
    cores, since fp32 inputs must meet 1e-5 and wgmma has no full-fp32
    mode). The notes in the sources give each design and what bounds it.
  - :func:`flash_attention_plain`, the plain PyTorch version, the
    counterpart of ``repro.kernels.ref.attention_ref``: K/V heads repeated
    with ``repeat_interleave``, an fp32 einsum, a ``-inf`` masked softmax and
    an fp32 P.V. The CPU tests and ``chip_smoke.py`` hold both kernels to it.

All take q ``(B, Sq, H, Dh)`` and k, v ``(B, Sk, KVH, Dh)`` with positions
implicitly 0..Sq-1 and 0..Sk-1, as the Pallas kernel does: Sq == Sk is
self-attention, Sq != Sk cross-attention (non-causal) or a causal mask
aligned top-left (``kp <= qp``). They return ``(B, Sq, H, Dh)`` in
``q.dtype``. A row that sees no key gives 0 in the plain version and the
sm90 kernel; the SIMT kernel follows the Pallas kernel's finite mask
there, so such rows (only possible with Sq > Sk and a window) are outside
the contract.
``launches`` counts the kernels' launches and ``launches_by_kernel`` splits
the count by kernel, so a run can show which kernel served its main path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches",
           "launches_by_kernel", "HEAD_DIMS", "KERNELS", "kernel_for",
           "check_tma"]

#: Head dims the kernels are compiled for.
HEAD_DIMS = (64, 128, 256)
#: Kernel name -> (csrc source, dtype it takes).
KERNELS = {"sm90_bf16": ("flash_attention_sm90", torch.bfloat16),
           "simt_fp32": ("flash_attention", torch.float32)}

launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel that takes ``dtype``: ``"sm90_bf16"`` or ``"simt_fp32"``."""
    for name, (_, dt) in KERNELS.items():
        if dt == dtype:
            return name
    raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 q, k, "
                     f"v, got {dtype}")


def check_tma(x: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless TMA can load ``x`` (B, S, H, Dh) bf16 as
    it lies: Dh stride 1, the stride of every other dimension longer than 1
    a positive multiple of 16 bytes, a 16-byte aligned base. Nothing is
    copied to make it so."""
    size = x.element_size()
    if x.shape[3] > 1 and x.stride(3) != 1:
        raise ValueError(f"{name}: the bf16 kernel loads tiles by TMA and "
                         f"needs Dh stride 1, got strides {x.stride()}")
    for dim in range(3):
        st = x.stride(dim) * size
        if x.shape[dim] > 1 and (st <= 0 or st % 16):
            raise ValueError(
                f"{name}: TMA needs the stride of dim {dim} to be a positive "
                f"multiple of 16 bytes, got {st} B (strides {x.stride()})")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned base, got "
                         f"address {x.data_ptr():#x}")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash attention takes q (B, Sq, H, Dh) and k, v "
                         "(B, Sk, KVH, Dh) of one shape")
    b, _, h, dh = q.shape
    if (k.shape[0], k.shape[3]) != (b, dh):
        raise ValueError(
            f"flash attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            f"must agree in B and Dh")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of KVH={k.shape[2]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: ``(B, Sq, H, Dh)`` in ``q.dtype``."""
    _check_shapes(q, k, v)
    _, sq, h, dh = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    logits.masked_fill_(~mask, float("-inf"))
    # a row with no visible key: softmax gives NaN, the kernels give 0
    probs = torch.softmax(logits, dim=-1).nan_to_num_(0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softmax_scale: float | None = None) -> torch.Tensor:
    """Launch the kernel for ``q.dtype`` on the current stream.

    Takes q ``(B, Sq, H, Dh)`` and k, v ``(B, Sk, KVH, Dh)`` on one CUDA
    device, all bfloat16 (the sm90 kernel, whose strides must satisfy
    :func:`check_tma`) or all float32 (the SIMT kernel, any strides), with
    Dh in :data:`HEAD_DIMS`, and returns ``(B, Sq, H, Dh)`` in their dtype.
    The strides are passed to the kernel; nothing is copied. Raises on
    anything else and when the launch fails. Sq = 0 returns an empty tensor
    without a launch, and so does Sk = 0 (zeros: no row sees a key).
    """
    global launches
    _check_shapes(q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention_cuda inputs must share one device")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    kernel = kernel_for(q.dtype)
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for Dh in {HEAD_DIMS}, got "
                         f"Dh={dh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if kernel == "sm90_bf16":
        for x, name in ((q, "q"), (k, "k"), (v, "v")):
            check_tma(x, name)
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    source = KERNELS[kernel][0]
    fn = getattr(_build.load(source), f"{source}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, sq, sk, h, k.shape[2], dh, float(scale),
                 int(causal),
                 0 if window is None else int(window), stream)
    if err != 0:
        what = {-2: "libcuda offers no cuTensorMapEncodeTiled"}.get(
            err, f"tensor map refused (CUresult {-err - 1000})"
            if err <= -1000 else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"{what} (B={b}, Sq={sq}, Sk={sk}, H={h}, "
                           f"KVH={k.shape[2]}, Dh={dh}, {q.dtype})")
    launches += 1
    launches_by_kernel[kernel] += 1
    return out
