"""The model zoo's dense family for serving, in PyTorch.

Port of ``repro.models`` (dense family): ``api`` (``ModelConfig``,
``build_model``), ``common`` (norms, RoPE, SwiGLU, loss, seeded
initialisation), ``attention`` (``attend_xla``, ``attend`` with the CUDA
flash-attention kernel behind ``impl="pallas"``, the KV cache), ``dense``
(``DenseLM``) and ``weights`` (``params_from_jax``).
"""
from .api import ModelConfig, build_model  # noqa: F401
from .dense import DenseLM  # noqa: F401

__all__ = ["ModelConfig", "build_model", "DenseLM"]
