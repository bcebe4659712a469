"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 (block-internal projections) vocab=50304.
One sLSTM block per 8 layers (6 super-blocks of 7 mLSTM + 1 sLSTM).
Sub-quadratic (chunkwise mLSTM + recurrent state) => long_500k runs.
"""
from ..models.api import ModelConfig
from .base import ArchSpec

ARCH = ArchSpec(
    arch_id="xlstm-1.3b",
    config=ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, slstm_period=8, mlstm_proj_factor=2.0,
    ),
    smoke=ModelConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=512, slstm_period=2,
    ),
    source="arXiv:2405.04517; unverified",
)
