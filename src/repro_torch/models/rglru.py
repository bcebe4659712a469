"""Griffin-style hybrid LM (RecurrentGemma): RG-LRU recurrent blocks and
local attention in the paper's (rec, rec, attn) pattern (arXiv:2402.19427).

Port of ``repro.models.rglru``. The pattern repeats over ``n_sup``
super-blocks whose weights are stacked with a leading ``sup`` dim
(``sup.slot{i}.*``); layers the pattern does not cover are the unstacked
``tail{t}.*`` (38 = 12 * 3 + 2 for the 9b config). The RG-LRU:

    r_t, i_t = sigmoid(W_g x_t)
    log a_t  = -c * softplus(Lambda) * r_t          (c = 8)
    h_t      = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

runs over a sequence as a log-depth scan (Hillis-Steele doubling over the
(a, b) pairs of the linear recurrence: ceil(log2 S) steps, as the
reference's associative scan is log-depth) and one step at a time in
decode. Temporal mixing is ``W_out(GeLU(W_gate x) * RG-LRU(conv4(W_x x)))``;
the MLP is GeGLU; attention is local (``cfg.window``), MQA at 9b.

Serving keeps a window-bounded cache: ``make_caches`` sizes the attention
cache ``min(s_max, window)`` slots, written modulo its length with each
slot's absolute position. A prefill attends over the in-flight K/V (its
mid-sequence queries need keys the wrapped cache has dropped): under
``attention_impl="pallas"`` that is the CUDA flash kernel with
``window=cfg.window``, one launch per attention layer (the masks depend on
``qp - kp`` only, so the kernel's implicit positions are exact for any
start). Decode attends over the wrapped cache with ``attend_xla``, its
positions and ``kv_valid``. As in the reference, a prefill starts the
recurrence and the conv from zeros, and only ``"rec"`` tail layers are
served.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .attention import attend, kv_cache_layer_update, kv_cache_slot_positions
from .common import (ParamFactory, apply_rope, at_least,
                     causal_depthwise_conv, conv_step, maybe_remat, rms_norm,
                     rope_frequencies)
from .family import FamilyLM

__all__ = ["GriffinLM", "GriffinCache", "param_shapes"]

RGLRU_C = 8.0


class GriffinCache(NamedTuple):
    """Serving state; the tensors are written in place by a step."""

    rec_h: torch.Tensor  # (NSUP, n_rec, B, W_) fp32 recurrent states
    rec_conv: torch.Tensor  # (NSUP, n_rec, B, w-1, W_)
    attn_k: torch.Tensor  # (NSUP, n_attn, B, S_cache, KVH, dh)
    attn_v: torch.Tensor
    attn_pos: torch.Tensor  # (NSUP, n_attn, B, S_cache), -1 empty
    tail_h: torch.Tensor  # (n_tail_rec, B, W_)
    tail_conv: torch.Tensor  # (n_tail_rec, B, w-1, W_)
    length: torch.Tensor  # (B,) int32


def _layout(cfg: ModelConfig):
    """(pattern, tail, n_sup) of a hybrid config."""
    pattern = cfg.block_pattern or ("rec", "rec", "attn")
    tail = cfg.pattern_tail
    covered = cfg.n_layers - len(tail)
    if covered % len(pattern):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers minus the tail "
                         f"{tail} is no whole number of {pattern}")
    return pattern, tail, covered // len(pattern)


def _leaf_shapes(cfg: ModelConfig, kind: str, lead: tuple
                 ) -> dict[str, tuple[int, ...]]:
    D, W_, w, F_ = (cfg.d_model, cfg.rnn_state_dim or cfg.d_model,
                    cfg.conv_width, cfg.d_ff)
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    if kind == "rec":
        mix = {"ln": (D,), "w_x": (D, W_), "w_gate": (D, W_),
               "conv": (w, W_), "w_g2": (W_, 2 * W_), "lam": (W_,),
               "w_out": (W_, D)}
    else:
        mix = {"ln": (D,), "wq": (D, H * dh), "wk": (D, KVH * dh),
               "wv": (D, KVH * dh), "wo": (H * dh, D)}
    mlp = {"ln2": (D,), "gg_gate": (D, F_), "gg_up": (D, F_),
           "gg_down": (F_, D)}
    return {k: (*lead, *v) for k, v in {**mix, **mlp}.items()}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """State-dict name -> shape of a hybrid model's weights."""
    pattern, tail, n_sup = _layout(cfg)
    shapes = {}
    for slot, kind in enumerate(pattern):
        for k, v in _leaf_shapes(cfg, kind, (n_sup,)).items():
            shapes[f"sup.slot{slot}.{k}"] = v
    shapes["embed"] = (cfg.padded_vocab, cfg.d_model)
    shapes["ln_f"] = (cfg.d_model,)
    for t, kind in enumerate(tail):
        for k, v in _leaf_shapes(cfg, kind, ()).items():
            shapes[f"tail{t}.{k}"] = v
    return shapes


def _rglru_gates(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
                 lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a^2) * (i * x)) of the recurrence, fp32."""
    a = torch.exp(-RGLRU_C * F.softplus(lam) * r)
    return a, torch.sqrt(at_least(1.0 - a * a, 1e-12)) * (i * x)


def _rglru_parallel(x, r, i, lam):
    """x, r, i: (B, S, W_) fp32; lam (W_,). Returns (h (B, S, W_), h_last).

    Inclusive scan of h_t = a_t h_{t-1} + b_t by doubling: after the step
    of offset d, (a_t, b_t) composes the 2d steps ending at t."""
    a, b = _rglru_gates(r, i, x, lam)
    S = a.shape[1]
    for step in range(math.ceil(math.log2(S)) if S > 1 else 0):
        d = 1 << step
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b, b[:, -1]


def _rglru_step(x, r, i, lam, h_prev):
    a, b = _rglru_gates(r, i, x, lam)
    return a * h_prev + b


class GriffinLM(FamilyLM):
    """RecurrentGemma-style hybrid LM."""

    FAMILIES = ("hybrid",)
    FP32_LEAVES = frozenset({"lam"})
    param_shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, **kw):
        self.pattern, self.tail, self.n_sup = _layout(cfg)
        self.n_rec = self.pattern.count("rec")
        self.n_attn = self.pattern.count("attn")
        self.rnn_w = cfg.rnn_state_dim or cfg.d_model
        super().__init__(cfg, **kw)

    def _init_leaf(self, f: ParamFactory, name: str, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        base = name.split(".")[-1]
        if base in ("ln", "ln2", "ln_f"):
            return f.ones(shape, dtype=dtype)
        if base == "lam":
            if f.device.type == "meta":
                return torch.empty(shape, dtype=dtype, device=f.device)
            return torch.linspace(0.5, 2.0, shape[-1], dtype=torch.float32,
                                  device=f.device).expand(shape).to(dtype)
        scale = {"embed": 0.02, "conv": 0.5}.get(base)
        return f.dense(shape, scale=scale, dtype=dtype)

    def _place(self, dev: torch.device) -> None:
        inv_freq, self.rot = rope_frequencies(self.cfg.dh,
                                              base=self.cfg.rope_base)
        self.register_buffer("inv_freq", inv_freq.to(dev), persistent=False)

    def _layer(self, slot_or_tail: str, sup: int | None) -> dict:
        """One layer's weights: ``sup.slot{i}`` at super-block ``sup``, or a
        tail layer."""
        group = getattr(self, slot_or_tail) if sup is None \
            else getattr(self.sup, slot_or_tail)
        return {k: v if sup is None else v[sup] for k, v in group.items()}

    def _layers(self):
        """(kind, weights, sup index, index within kind) in layer order,
        super-blocks first, then the tail."""
        for s in range(self.n_sup):
            ri = ai = 0
            for slot, kind in enumerate(self.pattern):
                idx = ri if kind == "rec" else ai
                yield kind, self._layer(f"slot{slot}", s), s, idx
                if kind == "rec":
                    ri += 1
                else:
                    ai += 1

    # ------------------------------------------------------------ sub-blocks
    def _rec_mix(self, hn, lp, h0=None, conv_tail=None, single=False):
        """Temporal mixing by the RG-LRU; ``hn (B, S, D)`` or ``(B, 1, D)``
        when ``single``. Returns (mix, last state, conv tail)."""
        gate = F.gelu(hn @ lp["w_gate"], approximate="tanh")
        xb = hn @ lp["w_x"]
        lam = lp["lam"].float()
        if single:
            xc, conv_tail = conv_step(xb[:, 0], conv_tail, lp["conv"])
            g2 = xc.float() @ lp["w_g2"].float()
            r, i = torch.sigmoid(g2).chunk(2, dim=-1)
            h1 = _rglru_step(xc.float(), r, i, lam, h0)
            y = (h1.to(hn.dtype) * gate[:, 0])[:, None]
            return y @ lp["w_out"], h1, conv_tail
        xc = causal_depthwise_conv(xb, lp["conv"])
        g2 = xc.float() @ lp["w_g2"].float()
        r, i = torch.sigmoid(g2).chunk(2, dim=-1)
        h, h_last = _rglru_parallel(xc.float(), r, i, lam)
        y = h.to(hn.dtype) * gate
        tail = xb[:, -(self.cfg.conv_width - 1):, :]
        return y @ lp["w_out"], h_last, tail

    def _qkv(self, hn, lp, positions):
        cfg = self.cfg
        B, S, _ = hn.shape
        q = (hn @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.dh)
        k = (hn @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.dh)
        v = (hn @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.dh)
        q = apply_rope(q, positions, self.inv_freq, self.rot)
        k = apply_rope(k, positions, self.inv_freq, self.rot)
        return q, k, v

    def _attend_fresh(self, q, k, v, positions):
        """Windowed causal attention over the in-flight K/V: the flash
        kernel under ``"pallas"``, else ``attend_xla``."""
        cfg = self.cfg
        if cfg.attention_impl == "pallas":
            return attend(q, k, v, impl="pallas", causal=True,
                          window=cfg.window or None)
        return attend(q, k, v, impl=cfg.attention_impl, causal=True,
                      q_positions=positions, kv_positions=positions,
                      window=cfg.window or None)

    def _attn_mix_train(self, hn, lp, positions):
        q, k, v = self._qkv(hn, lp, positions)
        o = self._attend_fresh(q, k, v, positions)
        return o.reshape(o.shape[0], o.shape[1], -1) @ lp["wo"]

    def _mlp(self, h, lp):
        hn = rms_norm(h, lp["ln2"])
        g = F.gelu(hn @ lp["gg_gate"], approximate="tanh")
        return h + (g * (hn @ lp["gg_up"])) @ lp["gg_down"]

    def _block_train(self, h, lp, kind, positions):
        hn = rms_norm(h, lp["ln"])
        if kind == "rec":
            mix = self._rec_mix(hn, lp)[0]
        else:
            mix = self._attn_mix_train(hn, lp, positions)
        return self._mlp(h + mix, lp)

    # ----------------------------------------------------------------- train
    def _sup_train(self, h, s, positions):
        """Super-block ``s``: its pattern's layers in order."""
        for slot, kind in enumerate(self.pattern):
            h = self._block_train(h, self._layer(f"slot{slot}", s), kind,
                                  positions)
        return h

    def _forward(self, batch: dict, *, last: bool = False) -> torch.Tensor:
        """Logits ``(B, S, V)`` of the whole sequence, or of the last
        position alone when ``last``. Each super-block is remat'd per
        ``cfg.remat_policy`` (the tail layers are not), as in the
        reference."""
        h = self._embed(batch["tokens"])
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
        sup = maybe_remat(self._sup_train, self.cfg.remat_policy)
        for s in range(self.n_sup):
            h = sup(h, s, positions)
        for t, kind in enumerate(self.tail):
            h = self._block_train(h, self._layer(f"tail{t}", None), kind,
                                  positions)
        if last:
            h = h[:, -1:]
        return self._masked_logits(rms_norm(h, self.ln_f), self.embed)

    # ----------------------------------------------------------------- serve
    def make_caches(self, batch: int, s_max: int) -> GriffinCache:
        cfg = self.cfg
        s_cache = max(min(s_max, cfg.window) if cfg.window else s_max, 1)
        NS, w, W_ = self.n_sup, cfg.conv_width, self.rnn_w
        n_tail_rec = self.tail.count("rec")
        dev, dt = self.device, cfg.dtype

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        kv = (NS, self.n_attn, batch, s_cache, cfg.n_kv_heads, cfg.dh)
        return GriffinCache(
            rec_h=zeros((NS, self.n_rec, batch, W_), torch.float32),
            rec_conv=zeros((NS, self.n_rec, batch, w - 1, W_), dt),
            attn_k=zeros(kv, dt), attn_v=zeros(kv, dt),
            attn_pos=torch.full((NS, self.n_attn, batch, s_cache), -1,
                                dtype=torch.int32, device=dev),
            tail_h=zeros((n_tail_rec, batch, W_), torch.float32),
            tail_conv=zeros((n_tail_rec, batch, w - 1, W_), dt),
            length=zeros((batch,), torch.int32))

    def _attn_mix_cached(self, hn, lp, cache, s, ai, start, qpos, single):
        """Attention of one layer; writes its K/V and positions into
        ``cache`` at super-block ``s``, attention slot ``ai``."""
        cfg = self.cfg
        B, Sq, _ = hn.shape
        q, k, v = self._qkv(hn, lp, qpos)
        kv_cache_layer_update(cache.attn_k[s, ai], cache.attn_v[s, ai], k, v,
                              start)
        cpos = kv_cache_slot_positions(cache.attn_pos[s, ai], qpos, start)
        cache.attn_pos[s, ai] = cpos
        if single:  # decode: over the bounded, wrapped window cache
            o = attend(q, cache.attn_k[s, ai], cache.attn_v[s, ai],
                       impl="xla", causal=True, q_positions=qpos,
                       kv_positions=cpos, window=cfg.window or None,
                       kv_valid=cpos >= 0)
        else:  # prefill: over the in-flight keys
            o = self._attend_fresh(q, k, v, qpos)
        return o.reshape(B, Sq, -1) @ lp["wo"]

    @torch.inference_mode()
    def _step(self, cache: GriffinCache, tokens: torch.Tensor, single: bool
              ) -> tuple[torch.Tensor, GriffinCache]:
        cfg = self.cfg
        h = self._embed(tokens)
        B, Sq, _ = h.shape
        start = cache.length
        qpos = (start[:, None]
                + torch.arange(Sq, dtype=torch.int32, device=h.device)[None])
        for kind, lp, s, idx in self._layers():
            hn = rms_norm(h, lp["ln"])
            if kind == "rec":
                if single:
                    mix, h1, tail = self._rec_mix(
                        hn, lp, cache.rec_h[s, idx], cache.rec_conv[s, idx],
                        single=True)
                else:
                    mix, h1, tail = self._rec_mix(hn, lp)
                cache.rec_h[s, idx] = h1
                cache.rec_conv[s, idx] = tail
            else:
                mix = self._attn_mix_cached(hn, lp, cache, s, idx, start,
                                            qpos, single)
            h = self._mlp(h + mix, lp)
        ti = 0
        for t, kind in enumerate(self.tail):
            if kind != "rec":  # the reference serves only recurrent tails
                continue
            lp = self._layer(f"tail{t}", None)
            hn = rms_norm(h, lp["ln"])
            if single:
                mix, h1, tl = self._rec_mix(hn, lp, cache.tail_h[ti],
                                            cache.tail_conv[ti], single=True)
            else:
                mix, h1, tl = self._rec_mix(hn, lp)
            cache.tail_h[ti] = h1
            cache.tail_conv[ti] = tl
            ti += 1
            h = self._mlp(h + mix, lp)
        logits = rms_norm(h[:, -1:], self.ln_f) @ self.embed.T
        return logits[..., :cfg.vocab], cache._replace(length=start + Sq)

    def prefill(self, cache: GriffinCache, batch: dict
                ) -> tuple[torch.Tensor, GriffinCache]:
        """Run the prompt ``batch["tokens"]``; last logits ``(B, 1, V)``."""
        return self._step(cache, batch["tokens"], single=False)

    def decode_step(self, cache: GriffinCache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, GriffinCache]:
        """Append ``tokens (B, 1)``; logits ``(B, 1, V)``."""
        return self._step(cache, tokens, single=True)
