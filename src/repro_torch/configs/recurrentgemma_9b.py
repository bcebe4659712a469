"""recurrentgemma-9b [hybrid]: RG-LRU + local attention 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, window 2048.
Pattern (rec, rec, attn) x 12 super-blocks + 2 trailing rec layers = 38.
Bounded window + recurrent state => long_500k runs.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="recurrentgemma-9b",
    config=ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, window=2048,
        block_pattern=("rec", "rec", "attn"), pattern_tail=("rec", "rec"),
        rnn_state_dim=4096,
    ),
    smoke=ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=160, vocab=512, window=8,
        block_pattern=("rec", "rec", "attn"), pattern_tail=("rec", "rec"),
        rnn_state_dim=64,
    ),
    source="arXiv:2402.19427; unverified",
)
