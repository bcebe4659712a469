"""Model zoo public API: the config dataclass and ``build_model``.

Port of ``repro.models.api``. ``ModelConfig`` has the reference's fields and
defaults; ``dtype`` is a ``torch.dtype``. A model is an ``nn.Module`` that
holds its weights and offers::

  loss(batch)                    -> scalar fp32 mean CE, differentiable
  prefill(cache, batch)          -> (last_logits, cache)
  decode_step(cache, tokens)     -> (logits, cache)
  make_caches(batch, s_max)      -> cache

Every family of the reference is ported: dense and vlm (``DenseLM``), moe
(``MoELM``), hybrid (``GriffinLM``), audio (``EncDecLM``) and ssm
(``XLSTMLM``). ``loss`` trains under ``attention_impl="xla"`` or
``"chunked"``; ``"pallas"`` (the forward-only flash kernel) raises under
autograd, and serving runs it under ``torch.inference_mode``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "build_model", "model_class"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0
    rope_base: float = 10000.0
    norm: str = "rms"  # rms | layer
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_ep: bool = True
    # --- hybrid / recurrent ---
    block_pattern: tuple[str, ...] = ()
    pattern_tail: tuple[str, ...] = ()
    window: int = 0  # local attention window (0 = full)
    conv_width: int = 4
    rnn_state_dim: int = 0
    # --- xlstm ---
    slstm_period: int = 0
    mlstm_proj_factor: float = 2.0
    # --- enc-dec ---
    enc_layers: int = 0
    dec_layers: int = 0
    # --- modality frontends ---
    n_prefix_tokens: int = 0
    frontend: str = ""
    # --- execution ---
    attention_impl: str = "xla"  # "xla" | "chunked" | "pallas" (CUDA flash)
    vocab_pad_to: int = 0  # pad embedding rows (logits of the pad masked)
    scan_layers: bool = True  # read by the reference only; the port loops
    remat_policy: str = "none"  # "none" | "full" | "dots", per layer
    dtype: torch.dtype = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return max(self.vocab, self.vocab_pad_to)

    @property
    def full_attention(self) -> bool:
        """True when every token attends over the entire unbounded context."""
        return self.family not in ("ssm", "hybrid")


def model_class(family: str):
    """The ``nn.Module`` class that implements ``family``."""
    if family in ("dense", "vlm"):
        from .dense import DenseLM

        return DenseLM
    if family == "moe":
        from .moe import MoELM

        return MoELM
    if family == "ssm":
        from .xlstm import XLSTMLM

        return XLSTMLM
    if family == "hybrid":
        from .rglru import GriffinLM

        return GriffinLM
    if family == "audio":
        from .encdec import EncDecLM

        return EncDecLM
    raise ValueError(f"unknown family {family!r}")


def build_model(cfg: ModelConfig, *, device=None,
                generator: torch.Generator | None = None):
    """Instantiate the family implementation for a config.

    ``device`` and ``generator`` go to the model's constructor (weights are
    drawn from ``generator``; see ``family.FamilyLM``).
    """
    return model_class(cfg.family)(cfg, device=device, generator=generator)
