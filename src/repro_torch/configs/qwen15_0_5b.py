"""qwen1.5-0.5b [dense]: QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (MHA kv=16) d_ff=2816 vocab=151936.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="qwen1.5-0.5b",
    config=ModelConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab=151936, qkv_bias=True,
    ),
    smoke=ModelConfig(
        name="qwen1.5-0.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=512, qkv_bias=True,
    ),
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
