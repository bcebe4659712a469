"""Grouped-query attention with causal/local masking, and the KV cache.

Port of ``repro.models.attention``. Implementations behind ``attend``:

  - ``impl="xla"``: einsum + fp32 softmax (:func:`attend_xla`), with
    positions, window and ``kv_valid``; the oracle, and the path of every
    cached (decode) call;
  - ``impl="pallas"``: the hand-written CUDA flash-attention kernel through
    ``kernels.ops.flash_attention`` (its plain version on the CPU). It
    attends over implicit positions and raises on positions or
    ``kv_valid``; it is forward only, as the reference's kernel, so under
    autograd it raises ``ValueError`` (train with ``"xla"`` or
    ``"chunked"``);
  - ``impl="chunked"``: the flash algorithm in plain PyTorch
    (:func:`attend_chunked`), a ``torch.autograd.Function`` with the
    reference's custom VJP, which recomputes each kv chunk in the backward
    and carries only ``dq``. As in the reference it takes self-attention
    with ``Sq >= 2048`` and no ``kv_valid`` whose length a chunk divides;
    every other call goes to ``attend_xla``.

Shapes follow ``(B, S, H, Dh)`` throughout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..kernels import ops as kops

__all__ = ["NEG_INF", "CHUNK_KV", "KVCache", "attend", "attend_xla",
           "attend_chunked", "kv_cache_init", "kv_cache_layer_update",
           "kv_cache_slot_positions"]

#: The reference's finite mask value, -0.7 * finfo(float32).max.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, Dh) -> (B, S, KVH*n_rep, Dh) by head replication (GQA)."""
    if n_rep == 1:
        return k
    b, s, kvh, dh = k.shape
    k = k[:, :, :, None, :].expand(b, s, kvh, n_rep, dh)
    return k.reshape(b, s, kvh * n_rep, dh)


def attend_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, q_positions: torch.Tensor | None = None,
               kv_positions: torch.Tensor | None = None,
               window: int | None = None,
               kv_valid: torch.Tensor | None = None,
               softmax_scale: float | None = None) -> torch.Tensor:
    """Reference attention. Returns ``(B, Sq, H, Dh)`` in ``q.dtype``.

    As in the reference: the scores are formed in ``q.dtype`` and then
    scaled in fp32, the mask value is the finite :data:`NEG_INF` (a row
    with no visible key averages all values instead of giving NaN), and
    the fp32 softmax is cast to ``q.dtype`` before the P.V product.
    """
    b, sq, h, dh = q.shape
    _, sk, kvh, _ = k.shape
    if h % kvh:
        raise ValueError(f"H={h} is not a multiple of KVH={kvh}")
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5

    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale

    mask = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal or window is not None:
        if q_positions is None:
            q_positions = torch.arange(sq, device=q.device).expand(b, sq)
        if kv_positions is None:
            kv_positions = torch.arange(sk, device=q.device).expand(b, sk)
        qp = q_positions[:, None, :, None]
        kp = kv_positions[:, None, None, :]
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]

    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           impl: str = "xla", **kw) -> torch.Tensor:
    if impl == "xla":
        return attend_xla(q, k, v, **kw)
    if impl == "pallas":
        if torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            raise ValueError(
                'attention_impl="pallas" has no backward: the flash kernel '
                'is forward only, as the reference\'s; train with "xla" or '
                '"chunked"')
        return kops.flash_attention(q, k, v, **kw)
    if impl == "chunked":
        if (kw.get("kv_valid") is None and q.shape[1] == k.shape[1]
                and q.shape[1] >= 2048 and _pick_chunk(k.shape[1])):
            return attend_chunked(q, k, v, causal=kw.get("causal", True),
                                  window=kw.get("window"),
                                  softmax_scale=kw.get("softmax_scale"))
        return attend_xla(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# Chunked (flash-algorithm) attention with the reference's custom VJP
# ---------------------------------------------------------------------------

CHUNK_KV = 1024


def _pick_chunk(sk: int) -> int:
    for c in (CHUNK_KV, 512, 256, 128, 64):
        if sk % c == 0:
            return c
    return 0


def _chunk_scores(qf, kk, c0, chunk, causal, window):
    """Masked fp32 scores ``(B, H, Sq, chunk)`` of the scaled fp32 queries
    against the kv chunk starting at ``c0``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float())
    if causal or window is not None:
        qpos = torch.arange(qf.shape[1], device=qf.device)[:, None]
        kpos = c0 + torch.arange(chunk, device=qf.device)[None, :]
        mask = torch.ones((qf.shape[1], chunk), dtype=torch.bool,
                          device=qf.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def _chunked_fwd(q, k, v, scale, causal, window, chunk):
    """Returns ``(out, lse)``: ``out (B, Sq, H, Dh)`` fp32 and ``lse (B, H,
    Sq)``. k/v are already head-repeated."""
    b, sq, h, dh = q.shape
    qf = q.float() * scale
    m_run = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        s = _chunk_scores(qf, k[:, c0:c0 + chunk], c0, chunk, causal, window)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, v[:, c0:c0 + chunk].float())
        m_run = m_new
    safe = torch.where(l_run == 0, torch.ones_like(l_run), l_run)
    out = acc / safe.transpose(1, 2)[..., None]
    return out, m_run + torch.log(safe)


class _ChunkedAttention(torch.autograd.Function):
    """The reference's ``_chunked_attn`` with its custom VJP. The backward
    recomputes each kv chunk's probabilities from the saved ``lse``: no
    pass holds more than one ``(B, H, Sq, chunk)`` block."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, chunk):
        out, lse = _chunked_fwd(q, k, v, scale, causal, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, chunk)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, chunk = ctx.args
        qf = q.float() * scale
        do = dout.float()
        delta = torch.einsum("bqhd,bqhd->bhq", do, out)  # rowsum(dout*out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for c0 in range(0, k.shape[1], chunk):
            kk, vv = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
            s = _chunk_scores(qf, kk, c0, chunk, causal, window)
            p = torch.exp(s - lse[..., None])  # (B, H, Sq, chunk)
            dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, do))
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vv.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kk.float()) * scale
            dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
        return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
                torch.cat(dvs, dim=1).to(v.dtype), None, None, None, None)


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   softmax_scale: float | None = None) -> torch.Tensor:
    """Streaming self-attention over positions 0..S-1, ``(B, Sq, H, Dh)``
    in ``q.dtype``. The kv heads are repeated before the function, so their
    gradients sum over each group through ``_repeat_kv``, as in the
    reference."""
    h, kvh = q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    chunk = _pick_chunk(k.shape[1])
    if not chunk:
        raise ValueError(f"no kv chunk divides Sk={k.shape[1]}")
    return _ChunkedAttention.apply(q, k, v, scale, causal, window, chunk)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Preallocated KV cache for autoregressive decoding.

    ``k``/``v`` are ``(L, B, S_max, KVH, Dh)``; ``length (B,)`` counts the
    tokens written; ``positions (B, S_max)`` holds the absolute position of
    every slot (-1 when empty). Writes wrap modulo ``S_max`` (bounded window
    caches). Unlike the reference's immutable arrays, ``k`` and ``v`` are
    written in place: a model step returns a cache that shares them with
    the one it was given (a full-width cache is hundreds of MB).
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32
    positions: torch.Tensor  # (B, S_max) int32

    @property
    def s_max(self) -> int:
        return self.k.shape[2]


def kv_cache_init(n_layers: int, batch: int, s_max: int, kv_heads: int,
                  head_dim: int, dtype: torch.dtype = torch.bfloat16, *,
                  device=None) -> KVCache:
    """An empty cache on ``device`` (``None``: CUDA, and ``RuntimeError``
    without it; ``"cpu"`` only when asked for)."""
    device = resolve_device(device)
    shape = (n_layers, batch, s_max, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        positions=torch.full((batch, s_max), -1, dtype=torch.int32,
                             device=device),
    )


def _slots(start: torch.Tensor, sq: int, s_max: int) -> torch.Tensor:
    return (start[:, None].long()
            + torch.arange(sq, device=start.device)[None, :]) % s_max


def kv_cache_layer_update(layer_k: torch.Tensor, layer_v: torch.Tensor,
                          new_k: torch.Tensor, new_v: torch.Tensor,
                          start: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write ``Sq`` new entries at ``start (B,)``, wrapping modulo S_max,
    into ``layer_k``/``layer_v (B, S_max, KVH, Dh)`` in place; returns them.

    When ``Sq >= S_max`` only the trailing ``S_max`` entries are written, so
    every slot is written once and the scatter is deterministic.
    """
    s_max = layer_k.shape[1]
    sq = new_k.shape[1]
    if sq >= s_max:
        drop = sq - s_max
        new_k, new_v = new_k[:, drop:], new_v[:, drop:]
        start = start + drop
        sq = s_max
    slot = _slots(start, sq, s_max)  # (B, Sq)
    bidx = torch.arange(layer_k.shape[0], device=layer_k.device)[:, None]
    layer_k[bidx, slot] = new_k.to(layer_k.dtype)
    layer_v[bidx, slot] = new_v.to(layer_v.dtype)
    return layer_k, layer_v


def kv_cache_slot_positions(positions: torch.Tensor,
                            q_positions: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
    """``positions (B, S_max)`` with ``q_positions (B, Sq)`` written at
    ``start``; a new tensor (the input is not changed)."""
    s_max = positions.shape[1]
    sq = q_positions.shape[1]
    if sq >= s_max:
        drop = sq - s_max
        q_positions = q_positions[:, drop:]
        start = start + drop
        sq = s_max
    slot = _slots(start, sq, s_max)
    bidx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    out = positions.clone()
    out[bidx, slot] = q_positions.to(positions.dtype)
    return out
