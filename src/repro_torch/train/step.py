"""Training step builder: loss -> grads -> AdamW, with microbatch gradient
accumulation, remat (selected by the model's config) and mixed precision
(bf16 parameters and activations, fp32 master weights and moments).

Port of ``repro.train.step``. The model is the ``nn.Module`` of
``models.api.build_model``; its parameters are the leaves the gradients
are taken of, and the step marks them ``requires_grad``. The parameter
tree the step takes and returns is a dict of tensors by state-dict name,
which may hold another dtype than the model (``apply_updates`` returns
bf16 by default): the step writes it into the model's parameters (a cast
up is exact) and gives each gradient in its leaf's dtype, as
``jax.grad`` gives the gradient of a bf16 leaf in bf16. Sharded, the
parameters, the optimizer state and the batch are DTensors
(``launch.train.train_loop(mesh=)``); the int8 cross-pod compression of
``distributed.compression`` takes each pod's gradients from
:func:`batch_grads` on the pod's sub-mesh.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from ..models.common import is_sharded
from .optimizer import OptimizerConfig, apply_updates

__all__ = ["build_train_step", "batch_grads", "loss_and_grads"]


def _load(model: torch.nn.Module, params: Mapping[str, torch.Tensor]
          ) -> dict[str, torch.nn.Parameter]:
    """Write ``params`` into the model's parameters (sharing storage where
    the dtypes agree) and make them trainable; returns them by name."""
    leaves = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError("params do not match the model's parameters: "
                         f"{sorted(set(leaves) ^ set(params))}")
    with torch.no_grad():
        for name, p in leaves.items():
            t = params[name]
            # a DTensor parameter's ``.data = t`` leaves its local tensor as
            # it was: a sharded leaf is always copied into
            if t.dtype == p.dtype and t.device == p.device \
                    and not is_sharded(p):
                p.data = t
            elif t is not p:
                p.data.copy_(t)
            p.requires_grad_(True)
    return leaves


def loss_and_grads(model: torch.nn.Module,
                   loss_fn: Callable[[], torch.Tensor]
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mark ``model``'s parameters trainable and take the gradient of
    ``loss_fn()`` with respect to each: ``(loss, {name: gradient})``, the
    loss detached, zeros where the loss does not reach a parameter. The
    gradient of a sharded parameter (a DTensor) comes back on the
    parameter's placements (the reduce-scatter of a data-parallel
    gradient), as ``jax.grad`` of a sharded leaf has the leaf's sharding."""
    leaves = dict(model.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    out = {}
    for (k, p), g in zip(leaves.items(), grads):
        if g is None:
            g = torch.zeros_like(p)
        elif is_sharded(p):
            g = g.redistribute(p.device_mesh, p.placements)
        out[k] = g
    return loss.detach(), out


def batch_grads(model, params: Mapping[str, torch.Tensor], batch: dict, *,
                microbatches: int = 1
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Write ``params`` into ``model`` and take ``(loss, {name: gradient})``
    of ``model.loss`` over ``batch``, each gradient in its leaf's dtype.

    ``microbatches > 1`` splits every batch tensor into that many equal
    slices along its first dim and accumulates the gradients in fp32 over
    them (one slice's activations alive at a time), averaging the loss, as
    the reference's scan does; ``microbatches == 1`` leaves each gradient
    in its parameter's dtype.
    """
    leaves = _load(model, params)

    def value_and_grad(mb):
        loss, grads = loss_and_grads(model, lambda: model.loss(mb))
        return loss, {k: g.to(params[k].dtype) for k, g in grads.items()}

    if microbatches == 1:
        return value_and_grad(batch)
    b = next(iter(batch.values())).shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} does not split into {microbatches} "
                         "microbatches")
    n = b // microbatches
    dev = next(iter(leaves.values())).device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    acc = {k: torch.zeros_like(t, dtype=torch.float32)
           for k, t in leaves.items()}
    for i in range(microbatches):
        loss_i, g_i = value_and_grad(
            {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        loss = loss + loss_i
        for k, g in g_i.items():
            acc[k] += g.float()
        del g_i
    inv = 1.0 / microbatches
    return loss * inv, {k: g * inv for k, g in acc.items()}


def build_train_step(model, opt_cfg: OptimizerConfig, *,
                     microbatches: int = 1,
                     grad_transform: Callable[[dict], dict] | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: :func:`batch_grads` over ``microbatches``, then
    AdamW. ``grad_transform`` processes the gradients after accumulation.
    ``metrics`` are 0-d tensors: ``loss``, ``grad_norm``, ``lr`` and
    ``param_norm``.
    """

    def train_step(params, opt_state, batch):
        loss, grads = batch_grads(model, params, batch,
                                  microbatches=microbatches)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, opt_state, metrics = apply_updates(opt_cfg, grads,
                                                       opt_state)
        return new_params, opt_state, dict(metrics, loss=loss)

    return train_step
