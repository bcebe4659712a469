"""Mixture-of-Experts decoder LM (phi3.5-moe 16e/top-2, qwen3-moe 128e/top-8).

Port of ``repro.models.moe``: ``DenseLM`` with its MLP replaced by
GShard/Switch-style capacity dispatch over small groups. Tokens are
reshaped ``(B, S, D) -> (B, G, gs, D)`` (``gs`` the largest power of two up
to 256 that divides S), routed by an fp32 router and top-k, and dispatched
within each group by one-hot einsums into ``C = min(max(ceil(gs * k * cf /
E), 1), gs)`` slots per expert, token-major (an exclusive prefix count).
Tokens over capacity pass through the residual only. The expert weights
``(L, E, D, F)`` run as ``torch.einsum`` over the dispatched
``(B, G, E, C, D)`` activations.

Capacity makes the function depend on how tokens are grouped: a prompt of
S = 2,048 routes in groups of 256, a decode token alone (gs = 1), so the
whole-sequence forward is not the cached path's function at the last
position, in the reference as here. ``constrain`` is the identity (no
mesh). ``aux_load_balance_loss`` is the reference's Switch-style
load-balance auxiliary for training (the train step does not add it, as
in the reference).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .dense import DenseLM
from .dense import param_shapes as dense_param_shapes

__all__ = ["MoELM", "param_shapes", "group_size", "capacity"]


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """State-dict name -> shape of an MoE model's weights: the dense
    model's, with ``blocks.w_router (L, D, E)`` (fp32) and the expert
    stacks ``blocks.w_gate/w_up (L, E, D, F)``, ``w_down (L, E, F, D)``."""
    L, D, Fd, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = dense_param_shapes(cfg)
    shapes.update({"blocks.w_router": (L, D, E),
                   "blocks.w_gate": (L, E, D, Fd),
                   "blocks.w_up": (L, E, D, Fd),
                   "blocks.w_down": (L, E, Fd, D)})
    return shapes


def group_size(S: int) -> int:
    """Tokens per dispatch group: the largest of 256, 128, ..., 1 that
    divides ``S`` (the reference's ``_group_size``)."""
    for gs in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if S % gs == 0:
            return gs
    return 1


def capacity(cfg: ModelConfig, gs: int) -> int:
    """Slots per expert and group."""
    c = max(int(math.ceil(gs * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts)), 1)
    return min(c, gs)


class MoELM(DenseLM):
    """MoE LM; weights, attention, cache and serving are ``DenseLM``'s."""

    FAMILIES = ("moe",)
    FP32_LEAVES = frozenset({"w_router"})
    param_shapes = staticmethod(param_shapes)

    def _mlp(self, hn: torch.Tensor, layer: int) -> torch.Tensor:
        """Capacity-based top-k MoE over grouped tokens; ``hn (B, S, D)``."""
        cfg = self.cfg
        B, S, D = hn.shape
        E, k = cfg.n_experts, cfg.top_k
        gs = group_size(S)
        G = S // gs
        x = hn.reshape(B, G, gs, D)

        # router (fp32)
        logits = torch.einsum("bgtd,de->bgte", x.float(),
                              self._w("w_router", layer).float())
        probs = torch.softmax(logits, dim=-1)
        gate, ids = torch.topk(probs, k, dim=-1)  # (B, G, gs, k)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

        # capacity and each token's slot in its expert's queue
        C = capacity(cfg, gs)
        sel = F.one_hot(ids, E).float()  # (B, G, gs, k, E)
        sel_te = sel.sum(dim=3)  # (B, G, gs, E), 0/1: top-k is distinct
        gate_te = torch.einsum("bgtk,bgtke->bgte", gate, sel)
        pos = torch.cumsum(sel_te, dim=2) - sel_te  # exclusive prefix count
        in_cap = (pos < C) & (sel_te > 0)
        pos = torch.where(in_cap, pos, 0.0).long()
        slot = F.one_hot(pos, C).float() * in_cap[..., None]  # (B,G,gs,E,C)
        combine = gate_te[..., None] * slot

        # experts
        xe = torch.einsum("bgtec,bgtd->bgecd", slot.to(hn.dtype), x)
        g1 = F.silu(torch.einsum("bgecd,edf->bgecf", xe,
                                 self._w("w_gate", layer)))
        u1 = torch.einsum("bgecd,edf->bgecf", xe, self._w("w_up", layer))
        y = torch.einsum("bgecf,efd->bgecd", g1 * u1,
                         self._w("w_down", layer))
        out = torch.einsum("bgtec,bgecd->bgtd", combine.to(hn.dtype), y)
        return out.reshape(B, S, D)

    def aux_load_balance_loss(self, batch: dict) -> torch.Tensor:
        """Switch-style load-balance auxiliary, the mean over layers of
        ``E * sum_e(frac_tokens_e * frac_probs_e)``: each layer's router
        (fp32) reads that layer's input residual (before its norm), top-1
        by ``argmax``. Differentiable through the router probabilities."""
        cfg = self.cfg
        h = self._embed(batch["tokens"])
        B, S, _ = h.shape
        E = cfg.n_experts
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device).expand(B, S)
        acc = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in range(cfg.n_layers):
            logits = torch.einsum("bsd,de->bse", h.float(),
                                  self._w("w_router", layer).float())
            probs = torch.softmax(logits, dim=-1)
            ids = torch.argmax(probs, dim=-1)
            frac_tokens = F.one_hot(ids, E).float().mean(dim=(0, 1))
            frac_probs = probs.mean(dim=(0, 1))
            acc = acc + E * torch.sum(frac_tokens * frac_probs)
            h = self._block_train(h, layer, positions)
        return acc / cfg.n_layers
