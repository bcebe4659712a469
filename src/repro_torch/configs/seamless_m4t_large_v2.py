"""seamless-m4t-large-v2 [audio]: enc-dec, multimodal [arXiv:2308.11596].

24L (24 encoder + 24 decoder, per the real model's per-stack depth)
d_model=1024 16H (MHA kv=16) d_ff=8192 vocab=256206 (padded to 256256 for
clean 16-way vocab TP; padding rows are masked out of the logits).
The speech frontend is a stub: ``input_specs`` provides precomputed frame
embeddings.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="seamless-m4t-large-v2",
    config=ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206, vocab_pad_to=256256, norm="layer",
        enc_layers=24, dec_layers=24, frontend="audio",
    ),
    smoke=ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=509, vocab_pad_to=512, norm="layer",
        enc_layers=2, dec_layers=2, frontend="audio",
    ),
    source="arXiv:2308.11596; hf",
)
