"""Config substrate: shape specs and arch specs.

Port of ``repro.configs.base``: ``ShapeSpec`` and ``SHAPES`` (what
``analysis.roofline.model_flops`` reads), ``ArchSpec``. ``input_specs`` and
``cache_specs`` (the dry run's abstract stand-ins) wait for
``launch/dryrun.py`` (ROADMAP queue 1, item 9.5).
"""
from __future__ import annotations

import dataclasses

from ..models.api import ModelConfig

__all__ = ["ShapeSpec", "ArchSpec", "SHAPES"]


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
