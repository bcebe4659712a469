"""AdamW from scratch: fp32 master weights, global-norm clipping, linear
warm-up and cosine decay.

Port of ``repro.train.optimizer``. A parameter tree is a dict of tensors
keyed by the model's state-dict names (the reference's tree paths, dotted:
``blocks.wq``). The reference's arithmetic is kept where its last bits
show:

  - ``lr_at`` and the bias corrections ``b ** step`` run in fp32, as the
    reference's ``step.astype(float32)`` does (Python floats give other
    last bits). ``lr_at`` reads the step on the host and computes with
    numpy fp32 scalars and the C library's ``cosf``, which is the cosine
    of the reference's CPU backend (torch's vectorised ``cos`` differs
    from it in the last bit at some steps);
  - ``global_norm`` sums the per-leaf fp32 sums of squares in the
    reference's leaf order (its tree's, which sorts the dict keys at each
    level);
  - ``apply_updates`` returns the new parameters in ``param_dtype``, bf16
    by default whatever the model's dtype: an fp32 model comes out of its
    first step with bf16 parameters, as in the reference (ROADMAP queue 3).

The moments and the master weights are updated in place (the state dict
that comes back is the one given, with a new ``step``), which halves the
optimizer's peak memory at full width; the values are the reference's.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

__all__ = ["OptimizerConfig", "init_opt_state", "apply_updates", "lr_at",
           "global_norm", "leaf_order"]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.cosf.restype = ctypes.c_float
_libm.cosf.argtypes = [ctypes.c_float]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor) as a 0-d fp32
    tensor on its device, computed in fp32 on the host."""
    f = np.float32
    s = f(int(step))
    warm = min(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = min(max((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0.0)),
               f(1.0))
    cos = f(0.5) * (f(1.0) + f(_libm.cosf(f(math.pi) * prog)))
    lr = f(cfg.lr) * warm * (f(cfg.min_lr_ratio)
                             + f(1 - cfg.min_lr_ratio) * cos)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def leaf_order(tree: Mapping[str, torch.Tensor]) -> list[str]:
    """The names of ``tree`` in the reference's leaf order: its nested
    dicts' keys sorted at each level."""
    return sorted(tree, key=lambda name: name.split("."))


def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    """fp32 master copies, zero moments and a 0-d int32 step."""
    dev = next(iter(params.values())).device
    return {
        "master": {k: p.detach().to(torch.float32, copy=True)
                   for k, p in params.items()},
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
              for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of the leaves' fp32 sums of squares, in leaf order."""
    total = None
    for name in leaf_order(tree):
        sq = torch.sum(tree[name].to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, grads: Mapping[str, torch.Tensor],
                  opt_state: dict, param_dtype: torch.dtype = torch.bfloat16
                  ) -> tuple[dict, dict, dict]:
    """One AdamW step. Returns ``(new_params, opt_state, metrics)``:
    ``new_params`` the master weights cast to ``param_dtype``, and the
    metrics ``grad_norm``, ``lr`` and ``param_norm`` as 0-d fp32 tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - _f32(cfg.b1, stepf) ** stepf
    bc2 = 1 - _f32(cfg.b2, stepf) ** stepf
    for name, g in grads.items():
        m, v, w = (opt_state[k][name] for k in ("m", "v", "master"))
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * w
        w.sub_(lr * upd)
    opt_state["step"] = step
    new_params = {k: w.to(param_dtype, copy=True)
                  for k, w in opt_state["master"].items()}
    metrics = {"grad_norm": gnorm, "lr": lr,
               "param_norm": global_norm(opt_state["master"])}
    return new_params, opt_state, metrics
