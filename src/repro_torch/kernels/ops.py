"""Public entry points of the port's kernels.

A CUDA tensor launches the hand-written kernel (or raises); a CPU tensor runs
the kernel's plain PyTorch version. Nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from .coflow_assign import coflow_assign_cuda, coflow_assign_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain

__all__ = ["coflow_assign", "flash_attention"]


def coflow_assign(fi: torch.Tensor, fj: torch.Tensor, sizes: torch.Tensor,
                  rates: torch.Tensor, delta: float, *,
                  n_ports: int) -> torch.Tensor:
    """Tau-aware greedy assignment; per-flow core choices ``(F,)`` int32.

    Takes the flat flow tensors of ``core.coflow.extract_flows`` (any
    integer/float dtype; cast here to the kernel's int32/fp32) and the
    ``(K,)`` core rates, all on one device. The state accumulates in fp32,
    as in the Pallas kernel this replaces, so at large F a near-tie choice
    can differ from an fp64 oracle; both versions here give the same
    choices as the Pallas kernel.
    """
    dev = fi.device
    args = (fi.to(torch.int32).contiguous(), fj.to(torch.int32).contiguous(),
            sizes.to(torch.float32).contiguous(),
            rates.to(device=dev, dtype=torch.float32).contiguous())
    if dev.type == "cuda":
        return coflow_assign_cuda(*args, delta, n_ports=n_ports)
    if dev.type == "cpu":
        return coflow_assign_plain(*args, delta, n_ports=n_ports)
    raise ValueError(f"coflow_assign runs on cuda or cpu, not {dev.type}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softmax_scale: float | None = None,
                    q_positions: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Flash kernel: q ``(B, Sq, H, Dh)``, k, v ``(B, Sk, KVH, Dh)`` ->
    ``(B, Sq, H, Dh)`` in ``q.dtype``.

    The kernel's contract is the reference kernel's: positions are
    implicitly 0..Sq-1 and 0..Sk-1, so Sq == Sk is self-attention over a
    fresh sequence and Sq != Sk a cross-attention (or a top-left aligned
    causal mask). The reference wrapper accepts and drops ``q_positions``,
    ``kv_positions`` and ``kv_valid``, which is wrong for a cached call;
    here any of them raises ``ValueError``. Cached and decode calls belong
    to ``models.attention.attend_xla``. The kernels tile Sq and Sk in fixed
    blocks (bf16: 128-row q tiles, 128-row kv tiles, 64 at Dh=256; fp32: 64)
    and mask the ragged tails themselves, so no block size is chosen here.
    """
    if q_positions is not None or kv_positions is not None \
            or kv_valid is not None:
        raise ValueError(
            "flash_attention takes no q_positions, kv_positions or kv_valid: "
            "the kernel attends over positions 0..Sq-1 and 0..Sk-1; cached "
            "calls go to attend_xla")
    dev = q.device
    if dev.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    softmax_scale=softmax_scale)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softmax_scale=softmax_scale)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {dev.type}")
