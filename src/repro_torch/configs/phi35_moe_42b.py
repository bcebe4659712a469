"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 per expert, vocab=32064.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b",
    config=ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, n_experts=16, top_k=2,
    ),
    smoke=ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, n_experts=4, top_k=2,
    ),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
