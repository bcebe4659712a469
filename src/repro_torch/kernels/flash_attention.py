"""Blocked causal/local GQA self-attention forward (flash attention).

Port of the Pallas TPU kernel ``_fa_kernel`` (``repro.kernels.
flash_attention``). Two versions of one function live here:

  - :func:`flash_attention_cuda`, the wrapper of the hand-written Hopper
    kernel ``csrc/flash_attention.cu`` (one CTA per 64-row q block, head and
    batch row; fp32 online softmax over 64-row kv blocks; see the note in
    the source for its design and what bounds it);
  - :func:`flash_attention_plain`, the plain PyTorch version, the
    counterpart of ``repro.kernels.ref.attention_ref``: K/V heads repeated
    with ``repeat_interleave``, an fp32 einsum, a ``-inf`` masked softmax and
    an fp32 P.V. The CPU tests and ``chip_smoke.py`` hold the kernel to it.

Both compute self-attention with positions implicitly 0..S-1 (q and k of
one length), ``(B, S, H, Dh)`` in, ``(B, S, H, Dh)`` in ``q.dtype`` out.
``launches`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches",
           "HEAD_DIMS", "BLOCK"]

#: Head dims the kernel is compiled for.
HEAD_DIMS = (64, 128)
#: Rows of the kernel's q and kv tiles (fixed; S need not be a multiple).
BLOCK = 64

launches = 0


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError("flash attention takes q (B, S, H, Dh) and k, v "
                         "(B, S, KVH, Dh) of one shape")
    b, s, h, dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, dh):
        raise ValueError(
            f"flash attention is self-attention with positions 0..S-1: q "
            f"{tuple(q.shape)} and k {tuple(k.shape)} must agree in B, S and "
            f"Dh")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of KVH={k.shape[2]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softmax_scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: ``(B, S, H, Dh)`` in ``q.dtype``."""
    _check_shapes(q, k, v)
    _, s, h, dh = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softmax_scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; ``(B, S, H, Dh)``.

    Takes q, k, v on one CUDA device, all float32 or all bfloat16, with
    Dh in :data:`HEAD_DIMS`, in any strides (they are passed to the kernel;
    nothing is copied). Raises on anything else and when the launch fails.
    S = 0 returns an empty tensor without a launch.
    """
    global launches
    _check_shapes(q, k, v)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention_cuda inputs must share one device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, s, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for Dh in {HEAD_DIMS}, got "
                         f"Dh={dh}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, s, h, k.shape[2], dh,
                 int(q.dtype == torch.bfloat16), float(scale), int(causal),
                 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={b}, S={s}, H={h}, KVH={k.shape[2]}, "
                           f"Dh={dh}, {q.dtype})")
    launches += 1
    return out
