"""Architecture registry of the port: the four dense configs.

Port of ``repro.configs.registry`` for the dense family. The reference's
other architectures (internvl2-76b, xlstm-1.3b, phi3.5-moe-42b-a6.6b,
qwen3-moe-235b-a22b, recurrentgemma-9b, seamless-m4t-large-v2) wait for their
families (ROADMAP queue 1, item 9); ``get_arch`` says so.
"""
from __future__ import annotations

from . import qwen15_0_5b, qwen15_4b, stablelm_1_6b, tinyllama_1_1b
from .base import ArchSpec

__all__ = ["ARCHS", "get_arch"]

ARCHS: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in (
    qwen15_4b, qwen15_0_5b, tinyllama_1_1b, stablelm_1_6b)}

_WAITING = ("internvl2-76b", "xlstm-1.3b", "phi3.5-moe-42b-a6.6b",
            "qwen3-moe-235b-a22b", "recurrentgemma-9b",
            "seamless-m4t-large-v2")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in ARCHS:
        return ARCHS[arch_id]
    if arch_id in _WAITING:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: its family comes with "
            f"ROADMAP queue 1, item 9")
    raise KeyError(f"unknown arch {arch_id!r}; one of {sorted(ARCHS)}")
