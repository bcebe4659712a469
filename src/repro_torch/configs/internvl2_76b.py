"""internvl2-76b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The vision frontend
is a stub per the assignment: ``input_specs`` supplies 256 precomputed patch
embeddings prepended to the token stream.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="internvl2-76b",
    config=ModelConfig(
        name="internvl2-76b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256, rope_base=1_000_000.0,
        n_prefix_tokens=256, frontend="vision",
    ),
    smoke=ModelConfig(
        name="internvl2-76b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=512, n_prefix_tokens=8, frontend="vision",
    ),
    source="arXiv:2404.16821; unverified",
)
