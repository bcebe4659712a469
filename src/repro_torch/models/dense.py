"""Dense decoder-only transformer LM (llama/qwen/stablelm-style, GQA).

Port of ``repro.models.dense``: tinyllama-1.1b, qwen1.5-{0.5b,4b} (QKV
bias), stablelm-1.6b (partial RoPE, LayerNorm) and the internvl2-76b LM
backbone (family ``"vlm"``: ``n_prefix_tokens`` precomputed patch
embeddings ``prefix_embeds (B, P, D)`` are put before the token embeddings
in the forward pass and the prefill, and their positions are dropped from
the forward pass's logits; the ViT itself is a stub, as in the reference).

``DenseLM`` is an ``nn.Module`` that holds the reference's stacked weights
in the reference's layout: ``blocks.wq (L, D, H*Dh)`` multiplies as
``"bsd,df->bsf"``, ``embed``/``unembed (V, D)``. Its state dict names are
the reference's tree paths (``embed``, ``blocks.wq``, ``ln_f``, ...), so
``models.weights.params_from_jax`` carries weights across as copies. The
layers run as a Python loop over the leading ``layers`` dim.

Attention under ``attention_impl="pallas"``: a fresh prefill (the cache is
empty) attends over the in-flight K/V through the CUDA flash-attention
kernel, one launch per layer, as the reference does for its ``"chunked"``
impl. Cached calls (decode, or a prefill into a non-empty cache) go to
``attend_xla`` with the cache's positions and ``kv_valid``. The reference
sends those cached calls to its flash kernel, whose wrapper drops the
positions and ``kv_valid`` and attends a decode query as if it stood at
position 0; the port does not copy that fault (ROADMAP queue 3).

``batch`` dict keys: ``tokens (B, S)`` int, ``labels (B, S)`` for ``loss``
(-1 = masked), and ``prefix_embeds (B, P, D)`` for the vlm family.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .attention import (KVCache, attend, kv_cache_init, kv_cache_layer_update,
                        kv_cache_slot_positions)
from .common import (ParamFactory, apply_rope, constrain, in_layer,
                     layer_norm, layer_scope, layer_weight, matmul,
                     maybe_remat, rms_norm, rope_frequencies, serve_mode)
from .family import ACT3, FamilyLM

ACT_Q = ("batch", None, "heads", None)
ACT_KV = ("batch", None, "kv_heads", None)

__all__ = ["DenseLM", "param_shapes", "param_axes"]


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """State-dict name -> shape of a dense (or vlm) model's weights."""
    L, D, H, KVH, Dh, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.dh, cfg.d_ff)
    V = cfg.padded_vocab
    shapes = {
        "embed": (V, D),
        "blocks.wq": (L, D, H * Dh),
        "blocks.wk": (L, D, KVH * Dh),
        "blocks.wv": (L, D, KVH * Dh),
        "blocks.wo": (L, H * Dh, D),
        "blocks.ln1": (L, D),
        "blocks.ln2": (L, D),
        "blocks.w_gate": (L, D, Fd),
        "blocks.w_up": (L, D, Fd),
        "blocks.w_down": (L, Fd, D),
    }
    if cfg.qkv_bias:
        shapes.update({"blocks.bq": (L, H * Dh), "blocks.bk": (L, KVH * Dh),
                       "blocks.bv": (L, KVH * Dh)})
    if cfg.norm == "layer":
        shapes.update({"blocks.ln1b": (L, D), "blocks.ln2b": (L, D)})
    shapes["ln_f"] = (D,)
    if cfg.norm == "layer":
        shapes["ln_fb"] = (D,)
    if not cfg.tie_embeddings:
        shapes["unembed"] = (V, D)
    return shapes


def _heads(x: torch.Tensor, n: int, dh: int, names: tuple) -> torch.Tensor:
    """``(B, S, n*dh) -> (B, S, n, dh)``, pinned to ``names``. Sharded, the
    flat tensor first takes the heads' shards (dims 0 and 2 of both): a
    shard of the flat dim that splits a head cannot be reshaped."""
    shape = (*x.shape[:2], n, dh)
    return constrain(constrain(x, names, shape=shape).reshape(shape), names)


#: Logical axes of each weight, as the reference's ``init`` names them.
_AXES = {
    "embed": ("vocab", "embed"),
    "unembed": ("vocab", "embed"),
    "ln_f": ("embed",),
    "ln_fb": ("embed",),
    "blocks.wq": ("layers", "embed", "heads_flat"),
    "blocks.wk": ("layers", "embed", "kv_flat"),
    "blocks.wv": ("layers", "embed", "kv_flat"),
    "blocks.wo": ("layers", "heads_flat", "embed"),
    "blocks.bq": ("layers", "heads_flat"),
    "blocks.bk": ("layers", "kv_flat"),
    "blocks.bv": ("layers", "kv_flat"),
    "blocks.ln1": ("layers", "embed"),
    "blocks.ln2": ("layers", "embed"),
    "blocks.ln1b": ("layers", "embed"),
    "blocks.ln2b": ("layers", "embed"),
    "blocks.w_gate": ("layers", "embed", "mlp"),
    "blocks.w_up": ("layers", "embed", "mlp"),
    "blocks.w_down": ("layers", "mlp", "embed"),
}


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """State-dict name -> logical axes of a dense (or vlm) model's weights
    (what the sharding planner reads)."""
    return {name: _AXES[name] for name in param_shapes(cfg)}


class DenseLM(FamilyLM):
    """Dense LM (see :class:`family.FamilyLM` for ``device``, ``generator``
    and ``from_state``)."""

    FAMILIES = ("dense", "vlm")
    param_shapes = staticmethod(param_shapes)
    param_axes = staticmethod(param_axes)

    def _init_leaf(self, f: ParamFactory, name: str, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        base = name.split(".")[-1]
        if base in ("ln1", "ln2", "ln_f"):
            return f.ones(shape, dtype=dtype)
        if base in ("bq", "bk", "bv", "ln1b", "ln2b", "ln_fb"):
            return f.zeros(shape, dtype=dtype)
        # the reference draws the embedding at scale 0.02
        return f.dense(shape, scale=0.02 if name == "embed" else None,
                       dtype=dtype)

    def _place(self, dev: torch.device) -> None:
        inv_freq, self.rot = rope_frequencies(
            self.cfg.dh, base=self.cfg.rope_base,
            fraction=self.cfg.rope_fraction)
        self.register_buffer("inv_freq", inv_freq.to(dev), persistent=False)

    # ------------------------------------------------------------- internals
    def _w(self, name: str, layer: int) -> torch.Tensor:
        return layer_weight(self.blocks[name][layer])

    def _norm(self, x: torch.Tensor, layer: int | None, which: str
              ) -> torch.Tensor:
        """``which`` is ``ln1``/``ln2`` of ``layer``, or ``ln_f``."""
        if layer is None:
            g, b = self.ln_f, getattr(self, "ln_fb", None)
        else:
            g = self._w(which, layer)
            b = self._w(which + "b", layer) if self.cfg.norm == "layer" \
                else None
        if self.cfg.norm == "layer":
            return layer_norm(x, g, b)
        return rms_norm(x, g)

    def _qkv(self, h: torch.Tensor, layer: int):
        cfg = self.cfg
        B, S, _ = h.shape
        q = matmul(h, self._w("wq", layer))
        k = matmul(h, self._w("wk", layer))
        v = matmul(h, self._w("wv", layer))
        if cfg.qkv_bias:
            q = q + self._w("bq", layer)
            k = k + self._w("bk", layer)
            v = v + self._w("bv", layer)
        return (_heads(q, cfg.n_heads, cfg.dh, ACT_Q),
                _heads(k, cfg.n_kv_heads, cfg.dh, ACT_KV),
                _heads(v, cfg.n_kv_heads, cfg.dh, ACT_KV))

    def _mlp(self, hn: torch.Tensor, layer: int) -> torch.Tensor:
        g = F.silu(matmul(hn, self._w("w_gate", layer)))
        u = matmul(hn, self._w("w_up", layer))
        return matmul(constrain(g * u, ("batch", None, "mlp")),
                      self._w("w_down", layer))

    def _attn_out(self, o: torch.Tensor, layer: int) -> torch.Tensor:
        o = constrain(o, ACT_Q)
        return matmul(o.reshape(o.shape[0], o.shape[1], -1),
                      self._w("wo", layer))

    def _block_train(self, h: torch.Tensor, layer: int,
                     positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = constrain(h, ACT3)
        hn = self._norm(h, layer, "ln1")
        q, k, v = self._qkv(hn, layer)
        q = apply_rope(q, positions, self.inv_freq, self.rot)
        k = apply_rope(k, positions, self.inv_freq, self.rot)
        if cfg.attention_impl == "pallas":  # positions are 0..S-1 here
            o = attend(q, k, v, impl="pallas", causal=True,
                       window=cfg.window or None)
        else:
            o = attend(q, k, v, impl=cfg.attention_impl, causal=True,
                       q_positions=positions, kv_positions=positions,
                       window=cfg.window or None)
        h = h + self._attn_out(o, layer)
        # pinned at the end too, so that a layer's partial sums are reduced
        # inside the layer (its collectives are then the same in each)
        return constrain(h + self._mlp(self._norm(h, layer, "ln2"), layer),
                         ACT3)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return self._masked_logits(
            h, self.embed if cfg.tie_embeddings else self.unembed)

    def _with_prefix(self, h: torch.Tensor,
                     prefix_embeds: torch.Tensor | None) -> torch.Tensor:
        """The prefix embeddings ``(B, P, D)`` before the token embeddings."""
        if prefix_embeds is None:
            return h
        return torch.cat([prefix_embeds.to(h.device, self.cfg.dtype), h],
                         dim=1)

    def _forward(self, batch: dict, *, last: bool = False) -> torch.Tensor:
        """Logits ``(B, S, V)`` of the whole sequence; with a vision prefix,
        of the text positions only. ``last=True`` gives the last position's
        ``(B, 1, V)`` alone. Each layer is remat'd per
        ``cfg.remat_policy``."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        if cfg.n_prefix_tokens:
            h = self._with_prefix(h, batch["prefix_embeds"])
        h = constrain(h, ACT3)
        B, S, _ = h.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
        block = maybe_remat(self._block_train, cfg.remat_policy)
        for layer in range(cfg.n_layers):
            h = in_layer(layer, block, h, layer, positions)
        if cfg.n_prefix_tokens:
            h = h[:, cfg.n_prefix_tokens:]
        return self._logits(self._norm(h[:, -1:] if last else h, None,
                                       "ln_f"))

    # ----------------------------------------------------------------- serve
    def make_caches(self, batch: int, s_max: int) -> KVCache:
        cfg = self.cfg
        return kv_cache_init(cfg.n_layers, batch, s_max, cfg.n_kv_heads,
                             cfg.dh, cfg.dtype, device=self.device)

    def cache_axes(self) -> KVCache:
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return KVCache(k=kv, v=kv, length=("batch",),
                       positions=("batch", "seq"))

    def _step(self, cache: KVCache, tokens: torch.Tensor, fresh: bool,
              prefix_embeds: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, KVCache]:
        with serve_mode(cache.k):
            return self._step_body(cache, tokens, fresh, prefix_embeds)

    def _step_body(self, cache: KVCache, tokens: torch.Tensor, fresh: bool,
                   prefix_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, KVCache]:
        """Shared prefill/decode: append ``Sq`` tokens (after the prefix
        embeddings, if given) to the cache (in place) and return the last
        position's logits ``(B, 1, V)``.

        ``fresh`` (the cache is empty) lets ``attention_impl="pallas"``
        attend over the in-flight K/V with the flash kernel; every other
        call attends over the cache with ``attend_xla``.
        """
        cfg = self.cfg
        h = self._with_prefix(self._embed(tokens), prefix_embeds)
        B, Sq, _ = h.shape
        start = cache.length
        qpos = (start[:, None]
                + torch.arange(Sq, dtype=torch.int32, device=h.device)[None, :])
        new_pos = kv_cache_slot_positions(cache.positions, qpos, start)
        kv_valid = new_pos >= 0
        for layer in range(cfg.n_layers):
            with layer_scope(layer):
                h = self._serve_layer(h, cache, layer, qpos, new_pos,
                                      kv_valid, start, fresh)
        logits = self._logits(self._norm(h[:, -1:], None, "ln_f"))
        return logits, KVCache(k=cache.k, v=cache.v, length=start + Sq,
                               positions=new_pos)

    def _serve_layer(self, h, cache: KVCache, layer: int, qpos, new_pos,
                     kv_valid, start, fresh: bool) -> torch.Tensor:
        cfg = self.cfg
        window = cfg.window or None
        h = constrain(h, ACT3)
        hn = self._norm(h, layer, "ln1")
        q, k, v = self._qkv(hn, layer)
        q = apply_rope(q, qpos, self.inv_freq, self.rot)
        k = apply_rope(k, qpos, self.inv_freq, self.rot)
        ck, cv = kv_cache_layer_update(cache.k[layer], cache.v[layer], k, v,
                                       start)
        if fresh and cfg.attention_impl == "pallas":
            o = attend(q, k, v, impl="pallas", causal=True, window=window)
        else:
            o = attend(q, ck, cv, impl="xla", causal=True,
                       q_positions=qpos, kv_positions=new_pos,
                       window=window, kv_valid=kv_valid)
        h = h + self._attn_out(o, layer)
        return constrain(h + self._mlp(self._norm(h, layer, "ln2"), layer),
                         ACT3)

    def prefill(self, cache: KVCache, batch: dict, *,
                fresh: bool | None = None
                ) -> tuple[torch.Tensor, KVCache]:
        """Append the prompt ``batch["tokens"]`` (after
        ``batch["prefix_embeds"]``, if given); last logits ``(B, 1, V)``.

        Reads ``cache.length`` on the host once, to tell a fresh prefill
        (the flash kernel's case) from one into a non-empty cache, unless
        ``fresh`` says (a trace on ``meta`` tensors cannot read it).
        """
        if fresh is None:
            fresh = not bool(cache.length.any())
        return self._step(cache, batch["tokens"], fresh,
                          batch.get("prefix_embeds"))

    def decode_step(self, cache: KVCache, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, KVCache]:
        """Append ``tokens (B, 1)``; logits ``(B, 1, V)``."""
        return self._step(cache, tokens, False)
