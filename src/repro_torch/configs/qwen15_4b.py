"""qwen1.5-4b [dense]: QKV bias [hf:Qwen/Qwen1.5-4B].

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="qwen1.5-4b",
    config=ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab=151936, qkv_bias=True,
    ),
    smoke=ModelConfig(
        name="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=60, n_heads=5, n_kv_heads=5,
        d_ff=128, vocab=512, qkv_bias=True,
    ),
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
