"""Shared neural building blocks of the model zoo, in PyTorch.

Port of ``repro.models.common``. Conventions kept from the reference:

  - weights of a layer stack are stacked with a leading ``layers`` dim and
    stored in the reference's layout (``(L, D, F)`` for ``"bsd,df->bsf"``),
    so weights carry across as copies with no transpose;
  - compute dtype and weights bf16 by default; norm statistics, softmax and
    the loss in fp32.

``constrain`` is the identity (no mesh yet). ``maybe_remat`` is the
reference's per-layer activation checkpointing, in ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamFactory", "rms_norm", "layer_norm", "rope_frequencies",
           "apply_rope", "swiglu", "gelu_mlp", "causal_depthwise_conv",
           "conv_step", "softmax_cross_entropy", "param_count", "tree_bytes",
           "constrain", "register_tree", "maybe_remat", "at_least"]

#: Elements above which ``ParamFactory.dense`` draws a leaf slice by slice
#: along its leading dims (4 GiB as one fp32 temporary). Every leaf of the
#: dense configs is smaller, so their draws are one call each.
DRAW_SLICE = 1 << 30


class ParamFactory:
    """Seeded initialisation of the port's weights.

    ``dense`` draws the reference's truncated normal (``N(0, 1)`` cut to
    ``[-2, 2]``, times ``scale`` or ``1/sqrt(fan_in)``, in fp32, then cast)
    from ``generator``. The numbers differ from ``jax.random``'s for the same
    seed; tests that compare the two frameworks carry weights across instead
    (``models.weights.params_from_jax``). A leaf of more than
    :data:`DRAW_SLICE` elements is drawn one leading-dim slice at a time
    (an MoE expert stack at full width would need a 27 GB fp32 temporary).
    On the ``meta`` device every method allocates nothing and draws nothing.
    """

    def __init__(self, generator: torch.Generator | None, *,
                 dtype: torch.dtype, device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def dense(self, shape: tuple[int, ...], *, scale: float | None = None,
              dtype: torch.dtype | None = None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        self._fill(out, std)
        return out

    def _fill(self, out: torch.Tensor, std: float) -> None:
        if out.numel() > DRAW_SLICE and out.ndim > 1:
            for part in out:
                self._fill(part, std)
            return
        w = torch.empty(out.shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=self.generator)
        out.copy_(w * std)

    def zeros(self, shape: tuple[int, ...], *,
              dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape: tuple[int, ...], *,
             dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a module, a (nested) dict or a list."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def param_count(tree) -> int:
    """Elements of every tensor in a module, a (nested) dict or a list."""
    return sum(t.numel() for t in _leaves(tree))


def constrain(x: torch.Tensor, names: tuple) -> torch.Tensor:
    """Sharding constraint of the reference; the identity without a mesh."""
    return x


def register_tree(module: torch.nn.Module,
                  tensors: Mapping[str, torch.Tensor]) -> None:
    """Register ``tensors`` (dotted names, the reference's tree paths) on
    ``module`` as frozen parameters, so that its state dict has those names.

    A name without a dot is a parameter of ``module``; a group whose members
    are all leaves becomes an ``nn.ParameterDict`` (``module.blocks["wq"]``),
    any other group an ``nn.Module`` holding its subgroups.
    """
    tree: dict = {}
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def build(node: dict) -> torch.nn.Module:
        if all(isinstance(v, torch.Tensor) for v in node.values()):
            return torch.nn.ParameterDict(
                {k: torch.nn.Parameter(v, requires_grad=False)
                 for k, v in node.items()})
        mod = torch.nn.Module()
        attach(mod, node)
        return mod

    def attach(mod: torch.nn.Module, node: dict) -> None:
        for key, val in node.items():
            if isinstance(val, torch.Tensor):
                mod.register_parameter(
                    key, torch.nn.Parameter(val, requires_grad=False))
            else:
                mod.add_module(key, build(val))

    attach(module, tree)


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` with JAX's gradient: where ``x == lo`` each
    side takes half (``clamp`` would give ``x`` all of it; the sLSTM's
    normaliser is exactly 1 at its first step)."""
    return torch.maximum(x, torch.full_like(x, lo))


# ---------------------------------------------------------------------------
# Remat (activation checkpointing), one layer at a time
# ---------------------------------------------------------------------------

#: The products that ``"dots"`` keeps: plain matmuls, without batch dims,
#: as the reference's ``dots_with_no_batch_dims_saveable``.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(body: Callable, policy: str) -> Callable:
    """``body`` (one layer) wrapped per the config's remat policy.

    ``"none"``: as it is. ``"full"``: ``torch.utils.checkpoint`` keeps the
    layer's inputs and recomputes the rest in the backward. ``"dots"``: a
    selective checkpoint that keeps the matmul outputs and recomputes the
    rest. Remat changes memory, never the values; without autograd (serving)
    every policy runs ``body`` as it is.
    """
    if policy == "none":
        return body
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {} if policy == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Normalization: statistics in fp32, result in the input's dtype
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full or partial)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, *, base: float = 10000.0,
                     fraction: float = 1.0) -> tuple[torch.Tensor, int]:
    """Inverse frequencies (fp32, on the CPU) of the rotated prefix of the
    head dim, and its width. Computed in float64 numpy, then cast, as the
    reference does."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (base ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.from_numpy(inv.astype(np.float32)), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, rot: int) -> torch.Tensor:
    """Rotate the first ``rot`` dims of each head of ``x (..., S, H, Dh)``
    at ``positions (..., S)``; pass the rest through.

    ``x`` times the fp32 cos/sin promotes to fp32, as in JAX; the rotated
    part is cast back to ``x.dtype``.
    """
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freq  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLP and loss
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: ``down(silu(x @ gate) * (x @ up))``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """GeLU (tanh approximation) MLP with biases."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def causal_depthwise_conv(x: torch.Tensor, kernel: torch.Tensor
                          ) -> torch.Tensor:
    """Causal depthwise conv of ``x (B, S, C)`` with ``kernel (w, C)``, the
    same length out: ``w`` shifted multiply-adds in ``x.dtype``, as the
    reference computes it (a sequence that starts from zeros)."""
    w = kernel.shape[0]
    kf = kernel.to(x.dtype)
    out = x * kf[w - 1]
    for t in range(1, w):
        shifted = F.pad(x[:, :-t, :], (0, 0, t, 0))
        out = out + shifted * kf[w - 1 - t]
    return out


def conv_step(x_t: torch.Tensor, tail: torch.Tensor, kernel: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of the causal conv: ``x_t (B, C)`` after ``tail (B, w-1,
    C)``, summed in fp32; returns ``(out (B, C) in x_t.dtype, new tail)``."""
    window = torch.cat([tail, x_t[:, None, :]], dim=1)  # (B, w, C)
    out = torch.einsum("bwc,wc->bc", window.float(), kernel.float())
    return out.to(x_t.dtype), window[:, 1:, :]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over unmasked positions, computed in fp32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
