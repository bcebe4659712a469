"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4, head_dim=128) d_ff=1536 per expert,
vocab=151936. The richest coflow structure of the zoo: 94 all-to-all
phases per step.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="qwen3-moe-235b-a22b",
    config=ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936, n_experts=128, top_k=8,
        rope_base=1_000_000.0,
    ),
    smoke=ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab=512, n_experts=8, top_k=2,
    ),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
