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
position, in the reference as here. Sharded (a DTensor model inside
``activation_sharding``), the experts' activations are pinned to
``("batch", None, "experts", None, None)`` as in the reference, and the
routing and the expert products run per rank through ``local_call``
(DTensor has no rule for ``topk`` and ``one_hot``).
``aux_load_balance_loss`` is the reference's Switch-style load-balance
auxiliary for training (the train step does not add it, as in the
reference).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .common import constrain, is_sharded, local_call, row_placements
from .dense import DenseLM
from .dense import param_axes as dense_param_axes
from .dense import param_shapes as dense_param_shapes

__all__ = ["MoELM", "param_shapes", "param_axes", "group_size", "capacity"]

ACT_E = ("batch", None, "experts", None, None)


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


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """State-dict name -> logical axes: the dense model's, with the router
    ``("layers", "embed", "experts_r")`` and the expert stacks' leading
    ``"experts"``."""
    axes = dense_param_axes(cfg)
    axes.update({"blocks.w_router": ("layers", "embed", "experts_r"),
                 "blocks.w_gate": ("layers", "experts", "embed", "mlp"),
                 "blocks.w_up": ("layers", "experts", "embed", "mlp"),
                 "blocks.w_down": ("layers", "experts", "mlp", "embed")})
    return axes


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


def _experts_sharded(slot, combine, x, w_gate, w_up, w_down):
    """The expert block of :meth:`MoELM._mlp` on DTensors, each product per
    rank through ``local_call``, the activations pinned to ``ACT_E`` as in
    the reference.

    Placements, per mesh dim: where ``x``'s rows (the batch) are split,
    every operand keeps its rows and the weights are gathered whole (the
    FSDP all-gather; their gradients are the rows' share, ``Partial``);
    where the weights' experts (their dim 0) are split, each rank holds its
    experts: the dispatch and combine one-hots and the expert activations
    are split along E too (``slot``/``combine`` dim 3, ``xe``/``y`` dim 2),
    ``x`` is whole and its gradient is the local experts' share, as is the
    combined output (``Partial``, reduced by the final ``constrain``). D and
    F are whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows, partial = row_placements(x)
    ex = tuple(p == Shard(0) and r != Shard(0)
               for p, r in zip(w_gate.placements, rows))

    def pick(e_pl, i):
        return tuple(r if r == Shard(0) else (e_pl if e else Replicate())
                     for r, e in zip(rows, ex)) if i else None

    act = pick(Shard(2), 1)  # xe, y: (B, G, E, C, D|F)
    hot = pick(Shard(3), 1)  # slot, combine: (B, G, gs, E, C)
    x_g = pick(Partial(), 1)
    w_in = tuple(Shard(0) if e else Replicate() for e in ex)
    w_g = tuple(Partial() if r == Shard(0) else p
                for r, p in zip(rows, w_in))
    mesh = x.device_mesh
    xe = local_call(lambda a, b: torch.einsum("bgtec,bgtd->bgecd",
                                              a.to(b.dtype), b),
                    mesh, act, (hot, rows), slot, x,
                    grad_placements=(hot, x_g))
    xe = constrain(xe, ACT_E)

    def ffn(xe, w_gate, w_up, w_down):
        g1 = F.silu(torch.einsum("bgecd,edf->bgecf", xe, w_gate))
        u1 = torch.einsum("bgecd,edf->bgecf", xe, w_up)
        return torch.einsum("bgecf,efd->bgecd", g1 * u1, w_down)

    y = local_call(ffn, mesh, act, (act, w_in, w_in, w_in), xe, w_gate,
                   w_up, w_down, grad_placements=(act, w_g, w_g, w_g))
    y = constrain(y, ACT_E)
    out = local_call(lambda c, y: torch.einsum("bgtec,bgecd->bgtd",
                                               c.to(y.dtype), y),
                     mesh, x_g, (hot, act), combine, y)
    return constrain(out, ("batch", None, None, None))


class MoELM(DenseLM):
    """MoE LM; weights, attention, cache and serving are ``DenseLM``'s."""

    FAMILIES = ("moe",)
    FP32_LEAVES = frozenset({"w_router"})
    param_shapes = staticmethod(param_shapes)
    param_axes = staticmethod(param_axes)

    def _route(self, x: torch.Tensor, w_router: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k routing of ``x (B, G, gs, D)`` by the fp32 router: the
        dispatch one-hots ``slot`` and the gate-weighted ``combine``, both
        ``(B, G, gs, E, C)`` fp32."""
        cfg = self.cfg
        E, k = cfg.n_experts, cfg.top_k
        gs = x.shape[2]
        logits = torch.einsum("bgtd,de->bgte", x.float(), w_router.float())
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
        return slot, gate_te[..., None] * slot

    def _mlp(self, hn: torch.Tensor, layer: int) -> torch.Tensor:
        """Capacity-based top-k MoE over grouped tokens; ``hn (B, S, D)``."""
        B, S, D = hn.shape
        gs = group_size(S)
        x = hn.reshape(B, S // gs, gs, D)
        w_router = self._w("w_router", layer)
        if is_sharded(x):
            from torch.distributed.tensor import Replicate

            # Placements: x keeps its batch shards (dim 0) and is whole
            # along the groups, the tokens and D; the router weight is
            # whole on every rank. The router contracts over D, and top-k
            # and the capacity prefix count run along E and a group's
            # tokens, so routing is per sequence: each rank routes its own
            # rows, and slot and combine carry x's batch shards. The
            # router's gradient is each rank's rows' share: Partial over
            # the batch shards.
            mesh = x.device_mesh
            rows, partial = row_placements(x)
            whole = (Replicate(),) * mesh.ndim
            slot, combine = local_call(self._route, mesh, (rows, rows),
                                       (rows, whole), x, w_router,
                                       grad_placements=(rows, partial))
        else:
            slot, combine = self._route(x, w_router)

        # experts (E over "model": the batch -> expert reshard is the EP
        # all-to-all of the reference)
        w_gate, w_up, w_down = (self._w(n, layer)
                                for n in ("w_gate", "w_up", "w_down"))
        if is_sharded(w_gate):
            return _experts_sharded(slot, combine, x, w_gate, w_up,
                                    w_down).reshape(B, S, D)
        xe = torch.einsum("bgtec,bgtd->bgecd", slot.to(hn.dtype), x)
        g1 = F.silu(torch.einsum("bgecd,edf->bgecf", xe, w_gate))
        u1 = torch.einsum("bgecd,edf->bgecf", xe, w_up)
        y = torch.einsum("bgecf,efd->bgecd", g1 * u1, w_down)
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
