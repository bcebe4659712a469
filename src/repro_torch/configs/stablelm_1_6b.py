"""stablelm-1.6b [dense] [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352. LayerNorm and
partial rotary embeddings (25% of head dim), per the stablelm-2 family.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="stablelm-1.6b",
    config=ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, norm="layer", rope_fraction=0.25,
    ),
    smoke=ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=512, norm="layer", rope_fraction=0.25,
    ),
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
