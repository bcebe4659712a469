"""Blocked causal/local GQA attention forward (flash attention).

Port of the Pallas TPU kernel ``_fa_kernel`` (``repro.kernels.
flash_attention``). One function, in three versions:

  - :func:`flash_attention_cuda`, the wrapper of two hand-written Hopper
    kernels, chosen by dtype: bfloat16 goes to
    ``csrc/flash_attention_sm90.cu`` (``"sm90_bf16"``: TMA loads of 128-row
    q tiles and 128-row kv tiles, 64-row at Dh=256, both products on the
    tensor cores with ``wgmma``, fp32 online softmax, P rounded to bf16
    before P.V), float32 to ``csrc/flash_attention_fp32_sm90.cu``
    (``"sm90_fp32"``: both products on the tensor cores in 3xTF32, which
    keeps the 1e-5 that one TF32 product misses: a pre-pass splits K and
    V^T into tf32 hi and lo planes, which :func:`tf32_planes_plain`
    computes in plain PyTorch, then TMA + ``wgmma`` over 64-key tiles).
    The notes in the sources give each design and what bounds it.
  - :func:`flash_attention_plain`, the plain PyTorch version, the
    counterpart of ``repro.kernels.ref.attention_ref``: K/V heads repeated
    with ``repeat_interleave``, an fp32 einsum, a ``-inf`` masked softmax and
    an fp32 P.V. The CPU tests and ``chip_smoke.py`` hold both kernels to it.

All take q ``(B, Sq, H, Dh)`` and k, v ``(B, Sk, KVH, Dh)`` with positions
implicitly 0..Sq-1 and 0..Sk-1, as the Pallas kernel does: Sq == Sk is
self-attention, Sq != Sk cross-attention (non-causal) or a causal mask
aligned top-left (``kp <= qp``). They return ``(B, Sq, H, Dh)`` in
``q.dtype``. A row that sees no key (only possible with Sq > Sk and a
window) gives 0 in all three: the kernels give a masked score's weight 0
outright, so such a row's softmax sum is 0, and the Pallas kernel's rule
for l == 0 gives 0.
``launches`` counts the kernels' launches and ``launches_by_kernel`` splits
the count by kernel, so a run can show which kernel served its main path.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "launches",
           "launches_by_kernel", "HEAD_DIMS", "TILES", "KERNELS", "kernel_for",
           "check_tma", "split_tf32_plain", "tf32_planes_plain",
           "tf32_planes_cuda", "KEY_ORDER"]

#: Head dims the kernels are compiled for.
HEAD_DIMS = (64, 128, 256)
#: Rows of each kernel's (q, kv) tiles at each head dim, as its source fixes
#: them (``kBlockQ`` or ``block_q(Dh)``, and ``block_k(Dh)`` or
#: ``kBlockK``); reprolint's blockspec-shape rule holds the two equal.
TILES = {"sm90_bf16": {64: (128, 128), 128: (128, 128), 256: (128, 64)},
         "sm90_fp32": {64: (128, 64), 128: (128, 64), 256: (64, 64)}}
#: Kernel name -> (csrc source, dtype it takes).
KERNELS = {"sm90_bf16": ("flash_attention_sm90", torch.bfloat16),
           "sm90_fp32": ("flash_attention_fp32_sm90", torch.float32)}
#: The order in which the fp32 kernel's V^T planes hold each run of 8 keys:
#: the order in which a thread's S accumulator holds them (columns 2c and
#: 2c + 1 of 8 are the k = c and c + 4 of P.V's A registers).
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)


def kernel_for(dtype: torch.dtype) -> str:
    """The kernel that takes ``dtype``: ``"sm90_bf16"`` or ``"sm90_fp32"``."""
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


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to tf32 (10-bit mantissa; nearest, ties away from
    zero) by integer operations on its fp32 bits: add half of the 13 low
    bits' unit to the magnitude, then clear them. NaN stays NaN."""
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(x), x, bits.view(torch.float32))


def split_tf32_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of fp32 ``x`` on any device, as the fp32 kernel
    makes it (``cvt.rna.tf32.f32``), bit for bit: ``hi = tf32(x)`` and
    ``lo = tf32(x - hi)`` (``x - hi`` is exact), so ``hi + lo`` is ``x``
    within 2^-22 of it and both have their 13 low bits zero. ``lo`` is 0
    where ``x`` is not finite (``hi`` is then ``x``)."""
    if x.dtype != torch.float32:
        raise ValueError(f"split_tf32_plain takes float32, got {x.dtype}")
    hi = _rna_tf32(x)
    lo = torch.where(torch.isfinite(x), _rna_tf32(x - hi), 0.0)
    return hi, lo


def _pad_keys(sk: int) -> int:
    """Sk rounded up to the fp32 kernel's kv tile: the planes' key extent."""
    bk = TILES["sm90_fp32"][HEAD_DIMS[0]][1]
    return -(-sk // bk) * bk


def tf32_planes_plain(k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernel's pre-pass in plain PyTorch: from k, v ``(B, Sk,
    KVH, Dh)`` fp32, the K planes ``(2, B, KVH, Sk_pad, Dh)`` (hi, lo) and
    the V^T planes ``(2, B, KVH, Dh, Sk_pad)``, Sk_pad = Sk rounded up to
    the kv tile, zero past Sk, each run of 8 keys of V^T in
    :data:`KEY_ORDER`."""
    b, sk, kvh, dh = k.shape
    pad = _pad_keys(sk)
    kt = k.new_zeros((b, kvh, pad, dh), dtype=torch.float32)
    kt[:, :, :sk] = k.permute(0, 2, 1, 3)
    vt = v.new_zeros((b, kvh, dh, pad), dtype=torch.float32)
    vt[..., :sk] = v.permute(0, 2, 3, 1)
    order = torch.arange(pad, device=v.device).view(-1, 8)[
        :, list(KEY_ORDER)].reshape(-1)
    return torch.stack(split_tf32_plain(kt)), torch.stack(
        split_tf32_plain(vt[..., order]))


def tf32_planes_cuda(k: torch.Tensor, v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernel's pre-pass alone, on the card: what
    :func:`tf32_planes_plain` computes, from CUDA fp32 k, v of any strides.
    A comparison's launch: it is not counted in ``launches``."""
    if k.ndim != 4 or v.shape != k.shape or not (k.is_cuda and v.is_cuda) \
            or (k.dtype, v.dtype) != (torch.float32, torch.float32):
        raise ValueError("tf32_planes_cuda takes CUDA float32 k, v of one "
                         "shape (B, Sk, KVH, Dh)")
    b, sk, kvh, dh = k.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for Dh in {HEAD_DIMS}, got "
                         f"Dh={dh}")
    pad = _pad_keys(sk)
    kp = torch.empty((2, b, kvh, pad, dh), dtype=torch.float32,
                     device=k.device)
    vp = torch.empty((2, b, kvh, dh, pad), dtype=torch.float32,
                     device=k.device)
    if kp.numel() == 0:
        return kp, vp
    source = KERNELS["sm90_fp32"][0]
    fn = getattr(_build.load(source), f"{source}_split")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    strides = (ctypes.c_longlong * 8)(*k.stride(), *v.stride())
    with torch.cuda.device(k.device):
        err = fn(k.data_ptr(), v.data_ptr(), strides, kp.data_ptr(),
                 vp.data_ptr(), b, sk, kvh, dh,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention sm90_fp32 pre-pass launch "
                           f"failed: CUDA error {err}")
    return kp, vp


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
    device, all bfloat16 (the bf16 kernel, whose strides must satisfy
    :func:`check_tma`) or all float32 (the 3xTF32 kernel, any strides), with
    Dh in :data:`HEAD_DIMS`, and returns ``(B, Sq, H, Dh)`` in their dtype.
    The strides are passed to the kernel; nothing is copied (the fp32
    kernel's pre-pass writes K and V^T split into tf32 planes, which this
    wrapper allocates). Raises on anything else and when the launch fails.
    Sq = 0 returns an empty tensor without a launch, and so does Sk = 0
    (zeros: no row sees a key).
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
    planes = ()  # the fp32 kernel's K and V^T planes (tf32_planes_plain)
    if kernel == "sm90_fp32":
        pad = _pad_keys(sk)
        if 2 * b * k.shape[2] * max(pad, dh) >= 2 ** 31:
            raise ValueError(f"B={b}, KVH={k.shape[2]}, Sk={sk}: the fp32 "
                             f"kernel's planes have more rows than a TMA "
                             f"coordinate (int32) reaches")
        planes = tuple(torch.empty(shape, dtype=torch.float32,
                                   device=q.device) for shape in (
            (2, b, k.shape[2], pad, dh), (2, b, k.shape[2], dh, pad)))
    source = KERNELS[kernel][0]
    fn = getattr(_build.load(source), f"{source}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)] \
        + [ctypes.c_void_p] * len(planes) + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, *(t.data_ptr() for t in planes), b, sq, sk, h,
                 k.shape[2], dh, float(scale), int(causal),
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
