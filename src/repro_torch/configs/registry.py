"""Architecture registry of the port: the reference's ten configs.

Port of ``repro.configs.registry``; ``ARCHS`` lists the architectures in
the reference's order, and ``all_cells`` every (arch x shape) cell with its
skip status.
"""
from __future__ import annotations

from . import (internvl2_76b, phi35_moe_42b, qwen3_moe_235b, qwen15_0_5b,
               qwen15_4b, recurrentgemma_9b, seamless_m4t_large_v2,
               stablelm_1_6b, tinyllama_1_1b, xlstm_1_3b)
from .base import SHAPES, ArchSpec

__all__ = ["ARCHS", "get_arch", "all_cells"]

_MODULES = (internvl2_76b, xlstm_1_3b, phi35_moe_42b, qwen3_moe_235b,
            qwen15_4b, qwen15_0_5b, tinyllama_1_1b, stablelm_1_6b,
            recurrentgemma_9b, seamless_m4t_large_v2)

ARCHS: dict[str, ArchSpec] = {m.ARCH.arch_id: m.ARCH for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; one of {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every assigned (arch x shape) cell with its skip status."""
    for aid, arch in ARCHS.items():
        for sname, shape in SHAPES.items():
            ok, reason = arch.supports(shape)
            yield aid, sname, ok, reason
