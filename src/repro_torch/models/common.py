"""Shared neural building blocks of the model zoo, in PyTorch.

Port of ``repro.models.common``. Conventions kept from the reference:

  - weights of a layer stack are stacked with a leading ``layers`` dim and
    stored in the reference's layout (``(L, D, F)`` for ``"bsd,df->bsf"``),
    so weights carry across as copies with no transpose;
  - compute dtype and weights bf16 by default; norm statistics, softmax and
    the loss in fp32.

Sharding: a model whose weights are DTensors (``distributed.sharding.
shard_module``) runs sharded inside an :class:`activation_sharding`
context, where ``constrain`` redistributes an activation to its planned
placements, as the reference's ``with_sharding_constraint`` pins it. Outside
the context, or on a plain tensor, ``constrain`` is the identity, so every
single-device path is unchanged. Ops that DTensor has no sharding rule for
run per rank through :func:`local_call` (``torch.distributed.tensor.
experimental.local_map``) with explicit placements.
``maybe_remat`` is the reference's per-layer activation checkpointing, in
``torch.utils.checkpoint``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamFactory", "rms_norm", "layer_norm", "rope_frequencies",
           "apply_rope", "swiglu", "gelu_mlp", "causal_depthwise_conv",
           "conv_step", "softmax_cross_entropy", "param_count", "tree_bytes",
           "constrain", "activation_sharding", "is_sharded", "local_call",
           "row_placements", "matmul", "layer_weight", "serve_mode",
           "in_layer", "layer_scope", "LAYER_TAGS", "register_tree",
           "maybe_remat", "at_least"]

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


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------

_ACT_CTX: list = []


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    return type(x).__name__ == "DTensor"


class activation_sharding:
    """Context manager: route ``constrain`` through ``(mesh, rules)``.

    Inside it a plain tensor that meets a DTensor counts as replicated
    (``implicit_replication``): the RoPE table, the positions and the masks
    are the same global values on every rank.
    """

    def __init__(self, mesh, rules):
        self.pair = (mesh, rules)
        self._implicit = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication

        self._implicit = implicit_replication()
        self._implicit.__enter__()
        _ACT_CTX.append(self.pair)
        return self

    def __exit__(self, *exc):
        _ACT_CTX.pop()
        self._implicit.__exit__(*exc)
        return False


def constrain(x: torch.Tensor, names: tuple, *,
              shape: tuple | None = None) -> torch.Tensor:
    """Pin an activation to its planned sharding: a DTensor inside an
    :class:`activation_sharding` context is redistributed to the plan's
    placements (a collective when they differ); anything else passes as it
    is. ``shape`` plans for another shape of the same rank than ``x``'s (a
    flat ``(B, S, H*Dh)`` put on the shards of its ``(B, S, H, Dh)``
    reshape, which DTensor can then split)."""
    if not _ACT_CTX or not is_sharded(x):
        return x
    mesh, rules = _ACT_CTX[-1]
    from ..distributed.sharding import plan_sharding

    plan = plan_sharding(mesh, tuple(shape or x.shape), names, rules)
    if tuple(x.placements) == plan.placements:
        return x
    return x.redistribute(mesh, plan.placements)


def local_call(fn: Callable, mesh, out_placements, in_placements, *args,
               grad_placements=None):
    """``fn(*args)`` run per rank on local tensors, through ``local_map``.

    Each tensor of ``args`` is redistributed to its entry of
    ``in_placements`` first (a plain tensor counts as replicated); ``None``
    entries pass their argument as it is. ``out_placements`` describes each
    output (one tuple, or a tuple of tuples for several).
    ``grad_placements`` (default: ``in_placements``) describes each input's
    local gradient: an input whole on a mesh dim along which the outputs
    are split (a weight read by each rank's own rows) gets ``Partial()``
    there, since each rank's gradient is then its rows' share of the sum.
    The caller states why the placements are right for ``fn``: each rank's
    output must be ``fn`` of its own blocks.
    """
    from torch.distributed.tensor import DTensor, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map

    def listed(pls):
        return tuple(None if p is None else list(p) for p in pls)

    if isinstance(out_placements[0], Placement):  # one output
        out_placements = list(out_placements)
    else:
        out_placements = listed(out_placements)
    conv = []
    for a, pl in zip(args, in_placements):
        if pl is not None and isinstance(a, torch.Tensor) \
                and not is_sharded(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        conv.append(a)
    return local_map(fn, out_placements=out_placements,
                     in_placements=listed(in_placements),
                     in_grad_placements=listed(grad_placements
                                               or in_placements),
                     device_mesh=mesh, redistribute_inputs=True)(*conv)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``; a DTensor weight multiplies per rank
    through ``local_call`` (DTensor's own product strategy search takes
    seconds per new placement pair on a 3-D mesh)."""
    if not is_sharded(w):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    # Placements, per mesh dim: where x's rows (dim 0, the batch) are split,
    # w is gathered whole (the FSDP all-gather) and each rank multiplies its
    # own rows, so w's gradient is the rows' share (Partial, reduced back to
    # w's shards by the backward's reduce-scatter); where both split the
    # contraction dim K (x's last, w's first: TP's row-parallel product),
    # each rank multiplies its K block and the output is the blocks' share
    # (Partial, reduced where it is next constrained); where w's columns
    # are split (TP's column-parallel product), x is whole and each rank
    # computes its columns, so x's gradient is the columns' share
    # (Partial); elsewhere both are whole.
    k_dim = x.ndim - 1
    xin, win, out, xg, wg = [], [], [], [], []
    for px, pw in zip(x.placements if is_sharded(x) else
                      (Replicate(),) * w.device_mesh.ndim, w.placements):
        if px == Shard(0):
            xin.append(px), win.append(Replicate()), out.append(px)
            xg.append(px), wg.append(Partial())
        elif px == Shard(k_dim) and pw == Shard(0):
            xin.append(px), win.append(pw), out.append(Partial())
            xg.append(px), wg.append(pw)
        elif pw == Shard(1):
            xin.append(Replicate()), win.append(pw)
            out.append(Shard(k_dim)), xg.append(Partial()), wg.append(pw)
        else:
            for pl in (xin, win, out, xg, wg):
                pl.append(Replicate())
    return local_call(torch.matmul, w.device_mesh, tuple(out),
                      (tuple(xin), tuple(win)), x, w,
                      grad_placements=(tuple(xg), tuple(wg)))


#: ``LAYER_TAGS[0]`` is whether :func:`in_layer` tags; ``LAYER_TAGS[1]``
#: is the layer the op now running belongs to (``None``: no layer). A
#: collective trace (``analysis.collectives.analyze_step``) reads the tag to
#: fold the per-layer collectives of the Python layer loops into one op each,
#: as the reference's scanned layers give one op with a trip count.
LAYER_TAGS: list = [False, None]


class _LayerMark(torch.autograd.Function):
    """Identity whose backward sets the current layer tag: at a layer's
    output it enters the layer's backward, at its input it leaves it."""

    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        LAYER_TAGS[1] = ctx.tag
        return g, None


def in_layer(layer: int, body: Callable, h: torch.Tensor, *args):
    """``body(h, *args)``, the ops of its forward and backward tagged as
    ``layer`` while a trace asks for tags (else just the call)."""
    if not LAYER_TAGS[0]:
        return body(h, *args)
    if h.requires_grad:
        h = _LayerMark.apply(h, None)
    with layer_scope(layer):
        out = body(h, *args)
    return _LayerMark.apply(out, layer) if out.requires_grad else out


@contextlib.contextmanager
def layer_scope(layer: int):
    """Tag the forward ops inside as ``layer`` (see :func:`in_layer`)."""
    prev, LAYER_TAGS[1] = LAYER_TAGS[1], layer
    try:
        yield
    finally:
        LAYER_TAGS[1] = prev


class _ReduceGrad(torch.autograd.Function):
    """Identity on a DTensor weight whose backward reduces the gradient to
    the weight's own placements at once."""

    @staticmethod
    def forward(ctx, w):
        ctx.spec = (w.device_mesh, tuple(w.placements))
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.spec) if is_sharded(g) else g


def layer_weight(w: torch.Tensor) -> torch.Tensor:
    """One layer's slice of a stacked weight, as the layer reads it. A
    sharded slice's gradient is reduced to the slice's placements inside
    the layer's backward (the per-layer reduce-scatter of the reference's
    scanned step), not once for the whole stack after the backward."""
    return _ReduceGrad.apply(w) if is_sharded(w) else w


def serve_mode(x):
    """The grad mode a serving step runs in: ``torch.inference_mode``, or
    ``torch.no_grad`` on a DTensor cache ``x`` (DTensor does not run under
    inference mode)."""
    return torch.no_grad() if is_sharded(x) else torch.inference_mode()


def row_placements(x) -> tuple[tuple, tuple]:
    """``(rows, partial)`` of a DTensor ``x`` whose dim 0 is the batch:
    ``rows`` keeps its shards of dim 0 and is whole elsewhere; ``partial``
    is the gradient placement of a weight that each rank reads whole for
    its own rows (``Partial()`` where ``rows`` is split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return rows, tuple(Partial() if p == Shard(0) else Replicate()
                       for p in rows)


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
    if is_sharded(lf):
        # DTensor's gather has no working rule on a vocab-sharded dim: take
        # the gold logit as a masked sum instead (exact, the other terms are
        # zeros), which stays sharded with the vocab and reduces once.
        hit = labels[..., None].long() == torch.arange(lf.shape[-1],
                                                        device=lf.device)
        gold = torch.where(hit, lf, 0.0).sum(dim=-1)
    else:
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
