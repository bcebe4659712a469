"""What every model family of the port shares: weights in the reference's
tree layout, drawn from a generator or taken from a state dict.

A family subclasses :class:`FamilyLM` and gives

  - ``FAMILIES``, the config families it serves;
  - ``param_shapes(cfg)``, state-dict name -> shape, the names being the
    reference's tree paths (``blocks.wq``, ``sup.slot0.w_x``, ``m.b_if``);
  - ``FP32_LEAVES``, the leaf names the reference keeps in float32 whatever
    ``cfg.dtype`` is (the MoE router, the RG-LRU's ``lam``, the xLSTM gate
    biases);
  - ``_init_leaf``, the reference's initialiser of each leaf.

Leaves are ``nn.Parameter``s registered by :func:`common.register_tree`,
so ``state_dict()`` has the reference's names and
``models.weights.params_from_jax`` copies each leaf once. They are frozen
(``requires_grad=False``) until a training step asks for their gradients
(``train.step.build_train_step``).

A family's forward is ``_forward(batch, last=False)``, differentiable:
``loss`` runs it. ``_forward_train`` is the same forward under
``torch.inference_mode``, what serving and the agreement checks call, as
the serving entry points (``prefill``, ``decode_step``) run under it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .api import ModelConfig
from .common import ParamFactory, register_tree, softmax_cross_entropy

__all__ = ["FamilyLM"]


class FamilyLM(nn.Module):
    """Weights drawn from ``generator`` on ``device``.

    ``device=None`` means CUDA (see ``resolve_device``); ``"meta"`` allocates
    nothing and draws nothing. ``generator=None`` means a generator on the
    device seeded with 0. :meth:`from_state` builds a model from a state
    dict instead.
    """

    FAMILIES: tuple[str, ...] = ()
    FP32_LEAVES: frozenset[str] = frozenset()

    @staticmethod
    def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
        raise NotImplementedError

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} takes the families "
                             f"{self.FAMILIES}, not {cfg.family!r}")
        self.cfg = cfg
        dev = torch.device("meta") if str(device) == "meta" \
            else resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        f = ParamFactory(generator, dtype=cfg.dtype, device=dev)
        register_tree(self, {
            name: self._init_leaf(f, name, shape,
                                  self.leaf_dtype(cfg, name))
            for name, shape in self.param_shapes(cfg).items()})
        self._place(dev)

    @classmethod
    def leaf_dtype(cls, cfg: ModelConfig, name: str) -> torch.dtype:
        """The dtype the reference holds leaf ``name`` in."""
        return torch.float32 if name.rsplit(".", 1)[-1] in cls.FP32_LEAVES \
            else cfg.dtype

    def _init_leaf(self, f: ParamFactory, name: str, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        raise NotImplementedError

    def _place(self, dev: torch.device) -> None:
        """Make the model's non-weight buffers on ``dev`` (RoPE tables)."""

    @classmethod
    def from_state(cls, cfg: ModelConfig, state: dict[str, torch.Tensor]):
        """A model whose weights are ``state``'s tensors (not copied), on
        their device; the names and shapes must be ``param_shapes``'."""
        want = cls.param_shapes(cfg)
        got = {k: tuple(v.shape) for k, v in state.items()}
        if got != want:
            raise ValueError(f"state does not match {cfg.name}: expected "
                             f"{want}, got {got}")
        devices = {t.device for t in state.values()}
        if len(devices) != 1:
            raise ValueError(f"state spans devices {devices}")
        model = cls(cfg, device="meta")
        model.load_state_dict(state, assign=True)
        for p in model.parameters():
            p.requires_grad_(False)
        model._place(devices.pop())
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.to(self.device).long()].to(self.cfg.dtype)

    def _forward(self, batch: dict, *, last: bool = False) -> torch.Tensor:
        raise NotImplementedError

    @torch.inference_mode()
    def _forward_train(self, batch: dict, *, last: bool = False
                       ) -> torch.Tensor:
        """:meth:`_forward` without autograd: logits of the whole sequence
        (``last=True``: of its last position alone; a full-width check
        would not hold every position's logits)."""
        return self._forward(batch, last=last)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean fp32 cross-entropy over the labels >= 0; differentiable."""
        logits = self._forward(batch)
        labels = batch["labels"].to(logits.device)
        return softmax_cross_entropy(logits, labels.clamp(min=0), labels >= 0)

    def _masked_logits(self, h: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
        """``h @ table.T`` with the padding rows' logits set to -1e9."""
        cfg = self.cfg
        logits = h @ table.T
        if cfg.padded_vocab != cfg.vocab:
            logits = logits.clone()
            logits[..., cfg.vocab:] = -1e9
        return logits
