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
``jax.grad`` gives the gradient of a bf16 leaf in bf16. The reference's
int8 cross-pod compression waits for ``distributed/`` (ROADMAP queue 1,
item 11).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from .optimizer import OptimizerConfig, apply_updates

__all__ = ["build_train_step", "loss_and_grads"]


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
            if t.dtype == p.dtype and t.device == p.device:
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
    loss detached, zeros where the loss does not reach a parameter."""
    leaves = dict(model.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def build_train_step(model, opt_cfg: OptimizerConfig, *,
                     microbatches: int = 1,
                     grad_transform: Callable[[dict], dict] | None = None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.

    ``microbatches > 1`` splits every batch tensor into that many equal
    slices along its first dim and accumulates the gradients in fp32 over
    them (one slice's activations alive at a time), averaging the loss, as
    the reference's scan does; ``microbatches == 1`` leaves each gradient
    in its parameter's dtype. ``grad_transform`` processes the gradients
    after accumulation. ``metrics`` are 0-d tensors: ``loss``,
    ``grad_norm``, ``lr`` and ``param_norm``.
    """

    def grads_of(leaves, params, batch):
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
        acc = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
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

    def train_step(params, opt_state, batch):
        leaves = _load(model, params)
        loss, grads = grads_of(leaves, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_params, opt_state, metrics = apply_updates(opt_cfg, grads,
                                                       opt_state)
        return new_params, opt_state, dict(metrics, loss=loss)

    return train_step
