"""The model zoo, in PyTorch: every family of the reference, served and
trained.

Port of ``repro.models``: ``api`` (``ModelConfig``, ``build_model``,
``model_class``), ``common`` (norms, RoPE, SwiGLU, GeLU MLP, the causal
conv, loss, seeded initialisation, the parameter tree), ``attention``
(``attend_xla``, ``attend`` with the CUDA flash-attention kernel behind
``impl="pallas"`` and ``attend_chunked`` with its custom VJP, the KV
cache), ``family`` (``FamilyLM``, what the
families share), ``dense`` (``DenseLM``: dense and vlm), ``moe``
(``MoELM``), ``rglru`` (``GriffinLM``: hybrid), ``encdec`` (``EncDecLM``:
audio), ``xlstm`` (``XLSTMLM``: ssm) and ``weights`` (``params_from_jax``).
"""
from .api import ModelConfig, build_model, model_class  # noqa: F401
from .dense import DenseLM  # noqa: F401

__all__ = ["ModelConfig", "build_model", "model_class", "DenseLM"]
