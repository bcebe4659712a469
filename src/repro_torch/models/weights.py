"""Weights from the JAX package's parameter tree into the port's models.

The reference's ``model.init(key)[0]`` is a nested dict (for the dense
family ``embed``, ``blocks.{wq, wk, wv, wo, ...}``, ``ln_f``, ...; for the
hybrid one ``sup.slot0.{w_x, ...}``, ``tail0.*``, ...). Every family of the
port keeps the same names and layouts (its ``param_shapes``), so each leaf
is one copy with no transpose. The tree is taken as numpy arrays
(``np.asarray`` of each leaf), so this module needs no JAX. bfloat16 has no
numpy dtype of its own: a leaf of the ``ml_dtypes`` bfloat16 type is
widened to float32 first, which is exact.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .api import ModelConfig, model_class

__all__ = ["params_from_jax"]

_NUMPY_FLOATS = (np.float16, np.float32, np.float64)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def params_from_jax(tree: Mapping, cfg: ModelConfig, *, device=None,
                    dtype: torch.dtype | None = None
                    ) -> dict[str, torch.Tensor]:
    """The port's state dict of ``cfg``'s family from the reference's tree.

    Every leaf lands on ``device`` (``None``: CUDA, and ``RuntimeError``
    without it; ``"cpu"`` only when asked for) in ``dtype`` (default:
    ``cfg.dtype``), except the leaves the family keeps in float32 (its
    ``FP32_LEAVES``: the MoE router, the RG-LRU's ``lam``, the xLSTM gate
    biases), which stay float32 as in the reference. Raises ``ValueError``
    when the tree's names or shapes are not those of ``cfg``. Build the
    model with ``model_class(cfg.family).from_state``.
    """
    flat = _flatten(tree)
    cls = model_class(cfg.family)
    want = cls.param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if got != want:
        raise ValueError(f"the tree does not match {cfg.name}: expected "
                         f"{want}, got {got}")
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    state = {}
    for name in want:
        arr = flat[name]
        if arr.dtype.type not in _NUMPY_FLOATS:
            arr = arr.astype(np.float32)
        leaf_dtype = torch.float32 if name.rsplit(".", 1)[-1] in \
            cls.FP32_LEAVES else dtype
        state[name] = torch.from_numpy(np.array(arr)).to(  # a copy
            device=dev, dtype=leaf_dtype)
    return state
