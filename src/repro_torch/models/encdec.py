"""Encoder-decoder transformer (seamless-m4t-large-v2 backbone, audio family).

Port of ``repro.models.encdec``. The speech frontend is a stub, as in the
reference: the batch carries precomputed frame embeddings ``src_frames
(B, S_src, D)``. ``enc_layers`` pre-LayerNorm bidirectional self-attention
layers encode the frames; ``dec_layers`` decoder layers run causal
self-attention (RoPE), cross-attention over the encoder output, and a GeLU
MLP with biases. The logits of the ``vocab_pad_to`` padding rows are -1e9;
serving returns the first ``vocab`` of them.

Attention under ``attention_impl="pallas"`` goes to the CUDA flash kernel
in three places, one launch per layer each:

  - the encoder's self-attention (``causal=False``, Sq = Sk = S_src);
  - a fresh prefill's decoder self-attention, over the in-flight K/V
    (causal, Sq = Sk = the target prefix);
  - the prefill's cross-attention (``causal=False``, Sq = the target
    prefix, Sk = S_src).

Decode attends with ``attend_xla``: its self-attention over the cache needs
positions and ``kv_valid``, which the kernel does not take, and its
cross-attention has one query row, which would fill one of the kernel's
128 q rows; keeping decode off the kernel also keeps the prefill's launch
count the whole count. ``batch`` keys: ``src_frames``, ``tokens (B, St)``,
``labels (B, St)`` for ``loss``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .api import ModelConfig
from .attention import attend, kv_cache_layer_update, kv_cache_slot_positions
from .common import (ParamFactory, apply_rope, gelu_mlp, layer_norm,
                     maybe_remat, rope_frequencies)
from .family import FamilyLM

__all__ = ["EncDecLM", "EncDecCache", "param_shapes"]


class EncDecCache(NamedTuple):
    """Decoder self-attention KV cache and the projected encoder K/V; the
    self-attention tensors are written in place by a step."""

    self_k: torch.Tensor  # (Ld, B, S_max, KVH, dh)
    self_v: torch.Tensor
    self_pos: torch.Tensor  # (Ld, B, S_max), -1 empty
    cross_k: torch.Tensor  # (Ld, B, S_src, KVH, dh)
    cross_v: torch.Tensor
    length: torch.Tensor  # (B,)


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """State-dict name -> shape of an enc-dec model's weights."""
    D, H, KVH, dh, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                         cfg.d_ff)
    V = cfg.padded_vocab

    def attn(L):
        return {"wq": (L, D, H * dh), "wo": (L, H * dh, D), "ln": (L, D),
                "lnb": (L, D), "wk": (L, D, KVH * dh), "wv": (L, D, KVH * dh)}

    def mlp(L):
        return {"w_in": (L, D, F_), "b_in": (L, F_), "w_out": (L, F_, D),
                "b_out": (L, D), "ln_m": (L, D), "ln_mb": (L, D)}

    Le, Ld = cfg.enc_layers, cfg.dec_layers
    shapes = {f"enc.sa_{k}": v for k, v in attn(Le).items()}
    shapes.update({f"enc.{k}": v for k, v in mlp(Le).items()})
    shapes.update({f"dec.sa_{k}": v for k, v in attn(Ld).items()})
    shapes.update({f"dec.ca_{k}": v for k, v in attn(Ld).items()})
    shapes.update({f"dec.{k}": v for k, v in mlp(Ld).items()})
    shapes.update({"embed": (V, D), "ln_enc": (D,), "ln_encb": (D,),
                   "ln_f": (D,), "ln_fb": (D,), "unembed": (V, D)})
    return shapes


class EncDecLM(FamilyLM):
    """Enc-dec LM (see :class:`family.FamilyLM`)."""

    FAMILIES = ("audio",)
    param_shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, **kw):
        if not (cfg.enc_layers and cfg.dec_layers):
            raise ValueError(f"{cfg.name}: an enc-dec model needs enc_layers "
                             f"and dec_layers")
        super().__init__(cfg, **kw)

    def _init_leaf(self, f: ParamFactory, name: str, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        base = name.split(".")[-1]
        if base in ("sa_ln", "ca_ln", "ln_m", "ln_enc", "ln_f"):
            return f.ones(shape, dtype=dtype)
        if base in ("sa_lnb", "ca_lnb", "ln_mb", "ln_encb", "ln_fb", "b_in",
                    "b_out"):
            return f.zeros(shape, dtype=dtype)
        return f.dense(shape, scale=0.02 if name == "embed" else None,
                       dtype=dtype)

    def _place(self, dev: torch.device) -> None:
        inv_freq, self.rot = rope_frequencies(self.cfg.dh,
                                              base=self.cfg.rope_base)
        self.register_buffer("inv_freq", inv_freq.to(dev), persistent=False)

    def _lp(self, stack: str, layer: int) -> dict:
        return {k: v[layer] for k, v in getattr(self, stack).items()}

    def _heads(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], n, self.cfg.dh)

    def _qkv(self, h, wq, wk, wv):
        cfg = self.cfg
        return (self._heads(h @ wq, cfg.n_heads),
                self._heads(h @ wk, cfg.n_kv_heads),
                self._heads(h @ wv, cfg.n_kv_heads))

    def _flat(self, o: torch.Tensor) -> torch.Tensor:
        return o.reshape(o.shape[0], o.shape[1], -1)

    def _attend(self, q, k, v, *, causal, positions=None):
        """Attention over K/V in hand (no cache): the flash kernel under
        ``"pallas"``, else ``attend_xla`` (with ``positions`` when causal)."""
        impl = self.cfg.attention_impl
        if impl == "pallas" or not causal:
            return attend(q, k, v, impl=impl, causal=causal)
        return attend(q, k, v, impl=impl, causal=True,
                      q_positions=positions, kv_positions=positions)

    # ---------------------------------------------------------------- encoder
    def _enc_layer(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        lp = self._lp("enc", layer)
        hn = layer_norm(h, lp["sa_ln"], lp["sa_lnb"])
        q, k, v = self._qkv(hn, lp["sa_wq"], lp["sa_wk"], lp["sa_wv"])
        h = h + self._flat(self._attend(q, k, v, causal=False)) @ lp["sa_wo"]
        hn = layer_norm(h, lp["ln_m"], lp["ln_mb"])
        return h + gelu_mlp(hn, lp["w_in"], lp["b_in"], lp["w_out"],
                            lp["b_out"])

    def encode(self, src_frames: torch.Tensor) -> torch.Tensor:
        """The encoder over ``src_frames``; each layer remat'd per
        ``cfg.remat_policy`` under autograd."""
        h = src_frames.to(self.device, self.cfg.dtype)
        layer_fn = maybe_remat(self._enc_layer, self.cfg.remat_policy)
        for layer in range(self.cfg.enc_layers):
            h = layer_fn(h, layer)
        return layer_norm(h, self.ln_enc, self.ln_encb)

    # ---------------------------------------------------------------- decoder
    def _cross_kv(self, enc_out: torch.Tensor, lp: dict):
        kv = self.cfg.n_kv_heads
        return (self._heads(enc_out @ lp["ca_wk"], kv),
                self._heads(enc_out @ lp["ca_wv"], kv))

    def _dec_tail(self, h, lp, cross_k, cross_v, decode=False):
        """Cross-attention and the MLP of one decoder layer."""
        hn = layer_norm(h, lp["ca_ln"], lp["ca_lnb"])
        qc = self._heads(hn @ lp["ca_wq"], self.cfg.n_heads)
        if decode:  # one query row (see the docstring)
            oc = attend(qc, cross_k, cross_v, impl="xla", causal=False)
        else:
            oc = self._attend(qc, cross_k, cross_v, causal=False)
        h = h + self._flat(oc) @ lp["ca_wo"]
        hn = layer_norm(h, lp["ln_m"], lp["ln_mb"])
        return h + gelu_mlp(hn, lp["w_in"], lp["b_in"], lp["w_out"],
                            lp["b_out"])

    def _self_qkv(self, h, lp, qpos):
        hn = layer_norm(h, lp["sa_ln"], lp["sa_lnb"])
        q, k, v = self._qkv(hn, lp["sa_wq"], lp["sa_wk"], lp["sa_wv"])
        return (apply_rope(q, qpos, self.inv_freq, self.rot),
                apply_rope(k, qpos, self.inv_freq, self.rot), v)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._masked_logits(h, self.unembed)

    def _dec_layer(self, h, layer, enc_out, qpos):
        lp = self._lp("dec", layer)
        q, k, v = self._self_qkv(h, lp, qpos)
        o = self._attend(q, k, v, causal=True, positions=qpos)
        h = h + self._flat(o) @ lp["sa_wo"]
        return self._dec_tail(h, lp, *self._cross_kv(enc_out, lp))

    def _forward(self, batch: dict, *, last: bool = False) -> torch.Tensor:
        """Logits ``(B, St, V)`` of the whole target, or of its last
        position alone when ``last``. Each decoder layer (with its
        cross-attention's K/V projection) is remat'd per
        ``cfg.remat_policy``."""
        enc_out = self.encode(batch["src_frames"])
        h = self._embed(batch["tokens"])
        B, St, _ = h.shape
        qpos = torch.arange(St, dtype=torch.int32,
                            device=h.device).expand(B, St)
        layer_fn = maybe_remat(self._dec_layer, self.cfg.remat_policy)
        for layer in range(self.cfg.dec_layers):
            h = layer_fn(h, layer, enc_out, qpos)
        if last:
            h = h[:, -1:]
        return self._logits(layer_norm(h, self.ln_f, self.ln_fb))

    # ----------------------------------------------------------------- serve
    def make_caches(self, batch: int, s_max: int, *, s_src: int = 0
                    ) -> EncDecCache:
        """An empty cache; ``s_src`` (default ``s_max // 8``, as the
        reference) sizes the cross K/V, which a prefill replaces when its
        source has another length."""
        cfg = self.cfg
        Ld, KVH, dh, dev = cfg.dec_layers, cfg.n_kv_heads, cfg.dh, self.device
        s_src = s_src or max(s_max // 8, 1)

        def zeros(*shape):
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)

        return EncDecCache(
            self_k=zeros(Ld, batch, s_max, KVH, dh),
            self_v=zeros(Ld, batch, s_max, KVH, dh),
            self_pos=torch.full((Ld, batch, s_max), -1, dtype=torch.int32,
                                device=dev),
            cross_k=zeros(Ld, batch, s_src, KVH, dh),
            cross_v=zeros(Ld, batch, s_src, KVH, dh),
            length=torch.zeros((batch,), dtype=torch.int32, device=dev))

    def _self_attend_cached(self, h, lp, cache, layer, start, qpos, fresh):
        """Decoder self-attention of one layer; writes its K/V and positions
        into ``cache``. A fresh prefill under ``"pallas"`` attends over the
        in-flight K/V with the kernel, any other call over the cache."""
        q, k, v = self._self_qkv(h, lp, qpos)
        sk, sv = kv_cache_layer_update(cache.self_k[layer],
                                       cache.self_v[layer], k, v, start)
        sp = kv_cache_slot_positions(cache.self_pos[layer], qpos, start)
        cache.self_pos[layer] = sp
        if fresh and self.cfg.attention_impl == "pallas":
            o = attend(q, k, v, impl="pallas", causal=True)
        else:
            o = attend(q, sk, sv, impl="xla", causal=True, q_positions=qpos,
                       kv_positions=sp, kv_valid=sp >= 0)
        return h + self._flat(o) @ lp["sa_wo"]

    def _qpos(self, start: torch.Tensor, sq: int) -> torch.Tensor:
        return start[:, None] + torch.arange(sq, dtype=torch.int32,
                                             device=start.device)[None]

    @torch.inference_mode()
    def prefill(self, cache: EncDecCache, batch: dict
                ) -> tuple[torch.Tensor, EncDecCache]:
        """Encode ``batch["src_frames"]``, project the cross K/V, run the
        target prefix ``batch["tokens"]``; last logits ``(B, 1, vocab)``.
        Reads ``cache.length`` on the host once, to tell a fresh prefill."""
        fresh = not bool(cache.length.any())
        enc_out = self.encode(batch["src_frames"])
        h = self._embed(batch["tokens"])
        start = cache.length
        qpos = self._qpos(start, h.shape[1])
        cross = [], []
        for layer in range(self.cfg.dec_layers):
            lp = self._lp("dec", layer)
            ck, cv = self._cross_kv(enc_out, lp)
            cross[0].append(ck)
            cross[1].append(cv)
            h = self._self_attend_cached(h, lp, cache, layer, start, qpos,
                                         fresh)
            h = self._dec_tail(h, lp, ck, cv)
        if cache.cross_k.shape[2] == enc_out.shape[1]:
            cache.cross_k.copy_(torch.stack(cross[0]))
            cache.cross_v.copy_(torch.stack(cross[1]))
            cross_k, cross_v = cache.cross_k, cache.cross_v
        else:
            cross_k, cross_v = torch.stack(cross[0]), torch.stack(cross[1])
        h = layer_norm(h[:, -1:], self.ln_f, self.ln_fb)
        return self._logits(h)[..., :self.cfg.vocab], cache._replace(
            cross_k=cross_k, cross_v=cross_v, length=start + qpos.shape[1])

    @torch.inference_mode()
    def decode_step(self, cache: EncDecCache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, EncDecCache]:
        """Append ``tokens (B, 1)``; logits ``(B, 1, vocab)``."""
        h = self._embed(tokens)
        start = cache.length
        qpos = self._qpos(start, h.shape[1])
        for layer in range(self.cfg.dec_layers):
            lp = self._lp("dec", layer)
            h = self._self_attend_cached(h, lp, cache, layer, start, qpos,
                                         False)
            h = self._dec_tail(h, lp, cache.cross_k[layer],
                               cache.cross_v[layer], decode=True)
        h = layer_norm(h[:, -1:], self.ln_f, self.ln_fb)
        return self._logits(h)[..., :self.cfg.vocab], cache._replace(
            length=start + qpos.shape[1])
