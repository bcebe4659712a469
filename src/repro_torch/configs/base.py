"""Config substrate: shape specs and arch specs.

Port of ``repro.configs.base``: ``ShapeSpec`` and ``SHAPES`` (what
``analysis.roofline.model_flops`` reads), ``ArchSpec``, and the dry run's
stand-ins for every input of a cell: ``input_specs`` and ``cache_specs``
return ``meta`` tensors (shape and dtype, no storage) where the reference
returns ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.api import ModelConfig, build_model

__all__ = ["ShapeSpec", "ArchSpec", "SHAPES", "input_specs", "cache_specs"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig  # the full assigned configuration
    smoke: ModelConfig  # reduced same-family config for CPU tests
    source: str  # provenance

    def supports(self, shape: ShapeSpec) -> tuple[bool, str]:
        """(runnable, reason-if-skipped) for an assigned cell."""
        if shape.name == "long_500k" and self.config.full_attention:
            return False, ("SKIP(full-attention): 500k dense-attention decode "
                           "is outside the design envelope")
        return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for the *batch* inputs of one cell.

    train  -> {tokens, labels, [prefix_embeds | src_frames]}
    prefill-> {tokens, [prefix_embeds | src_frames]}
    decode -> {tokens (B,1)}
    """
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind == "train":
        out = {"tokens": _meta((B, S), tok), "labels": _meta((B, S), tok)}
        if cfg.family == "vlm":
            out["prefix_embeds"] = _meta((B, cfg.n_prefix_tokens,
                                          cfg.d_model), cfg.dtype)
        if cfg.family == "audio":
            out["src_frames"] = _meta((B, S, cfg.d_model), cfg.dtype)
        return out
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), tok)}
        if cfg.family == "vlm":
            out["prefix_embeds"] = _meta((B, cfg.n_prefix_tokens,
                                          cfg.d_model), cfg.dtype)
        if cfg.family == "audio":
            out["src_frames"] = _meta((B, max(S // 8, 1), cfg.d_model),
                                      cfg.dtype)
        return out
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), tok)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The ``meta`` cache of a serve-shape cell (prefill/decode)."""
    model = build_model(cfg, device="meta")
    B, S = shape.global_batch, shape.seq_len
    kw = {}
    if cfg.family == "audio":
        kw["s_src"] = max(S // 8, 1)
    return model.make_caches(B, S + cfg.n_prefix_tokens, **kw)
