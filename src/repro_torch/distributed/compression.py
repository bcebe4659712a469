"""Cross-pod gradient compression: int8 quantisation with per-block scales
and error feedback, applied only to the slow inter-pod hop.

Port of ``repro.distributed.compression``. Within a pod gradients ride the
fast links; across pods they cross the OCS layer, the bandwidth the
paper's scheduler manages. Quantising the pod-axis all-reduce to int8 cuts
that hop's traffic 4x against fp32, and error feedback (a per-pod
residual) keeps the long-run update unbiased.

The reference computes the gradient inside a ``shard_map`` manual over
only the "pod" axis, so that each pod holds its own gradient. The port
takes each pod's gradient from the plain sharded step
(``train.step.batch_grads``) on the pod's sub-mesh, the mesh without
"pod": the model's parameters are moved onto it (views of the same
blocks, which are replicated over "pod"), and the pod's rows of the batch
are its batch. The hop is then the reference's, per leaf:

    work = g_pod + err_pod                  the pod's whole gradient
    q, scale = quantize_int8(work)          per-block fp32 scales
    g' = all_reduce(q * scale) / n_pods     the compressed wire hop
    err_pod' = work - q * scale             what quantisation dropped

The reference's blocks of ``BLOCK`` values run over the flattened whole
leaf, which a rank's FSDP/TP shard does not hold in whole blocks, so each
rank gathers its pod's gradient of a leaf over the sub-mesh first; the
scales are then the reference's. The residual state is one whole leaf a
pod, sharded over "pod" only (the reference's ``P("pod")``).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

from ..models.common import activation_sharding, is_sharded
from ..train.optimizer import OptimizerConfig, apply_updates
from ..train.step import batch_grads
from .sharding import TRAIN_RULES

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "init_error_state",
           "build_compressed_train_step"]

BLOCK = 2048


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as one IEEE division on every device: CUDA turns a
    division by a Python scalar into a product with its reciprocal, which
    can be one ulp off the reference's quotient."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(values int8 (nB, BLOCK), per-block scales fp32 (nB, 1)) of ``g``
    flattened and zero-padded to whole blocks; ``torch.round`` rounds half
    to even, as ``jnp.round`` does."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = _div(torch.amax(torch.abs(blocks), dim=1, keepdim=True), 127.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape)).to(dtype)


def _axis_dim(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh {names} has no {axis!r} axis")
    return names.index(axis)


def init_error_state(params_like: Mapping[str, torch.Tensor], n_pods: int,
                     *, axis: str = "pod") -> dict:
    """Per-pod residuals: fp32 zeros of shape ``(n_pods, *leaf shape)``. A
    DTensor leaf's residual is a DTensor on its mesh, split over ``axis``
    on dim 0 and whole on the other mesh dims (each rank holds its pod's
    whole residual); a plain leaf's is a plain tensor on its device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = {}
    for k, p in params_like.items():
        shape = (n_pods, *p.shape)
        if not is_sharded(p):
            out[k] = torch.zeros(shape, dtype=torch.float32, device=p.device)
            continue
        mesh = p.device_mesh
        d = _axis_dim(mesh, axis)
        local = torch.zeros((n_pods // mesh.size(d), *p.shape),
                            dtype=torch.float32, device=p.to_local().device)
        place = [Replicate()] * mesh.ndim
        place[d] = Shard(0)
        out[k] = DTensor.from_local(
            local, mesh, place, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def _without(placements, d: int) -> tuple:
    return tuple(p for i, p in enumerate(placements) if i != d)


def build_compressed_train_step(model, opt_cfg: OptimizerConfig, mesh,
                                axis: str = "pod", *, microbatches: int = 1):
    """``train_step(params, opt_state, err, batch) -> (params, opt_state,
    err, metrics)`` with the pod-hop gradient all-reduce quantised to int8
    with error feedback.

    ``mesh`` is a ``DeviceMesh`` with ``axis`` and at least one more dim;
    ``model`` is sharded on it (``shard_module``, parameters replicated over
    ``axis``), and its parameters move onto the sub-mesh without ``axis``
    when the step is built. ``params`` and ``opt_state`` are DTensors on
    ``mesh`` (as ``train_loop(mesh=)`` keeps them), ``err`` is
    :func:`init_error_state`'s, ``batch`` holds DTensors split over
    ``axis`` on dim 0 (``batch_spec``). ``microbatches`` accumulates each
    pod's gradient as ``batch_grads`` does (the reference has none: one
    pod's whole batch at once). The loss is the mean of the pods' losses;
    the gradients and new parameters come back on ``params``' placements.
    ``train_step.grads_fn(params, batch, err) -> (loss, grads, err)`` is
    the gradient half alone (the reference's inner ``grads_fn``), and
    ``train_step.pod_grads(params, batch) -> (loss, grads)`` each pod's
    own loss and gradient before the hop, on the sub-mesh.
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    d = _axis_dim(mesh, axis)
    rest = tuple(n for n in mesh.mesh_dim_names if n != axis)
    if not rest:
        raise ValueError(f"the mesh has no axis besides {axis!r}")
    n_pods = mesh.size(d)
    sub = mesh[rest]
    group = mesh.get_group(d)

    def to_sub(t: torch.Tensor, what: str) -> torch.Tensor:
        if not is_sharded(t) or t.device_mesh != mesh \
                or t.placements[d] != Replicate():
            raise ValueError(f"{what} must be a DTensor on the mesh, "
                             f"replicated over {axis!r}")
        return DTensor.from_local(t.to_local(), sub, _without(t.placements, d),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        owner.register_parameter(leaf, torch.nn.Parameter(
            to_sub(p.detach(), name), requires_grad=False))

    def pod_rows(t: torch.Tensor, key: str) -> torch.Tensor:
        from torch.distributed.tensor import Shard

        if not is_sharded(t) or t.placements[d] != Shard(0):
            raise ValueError(f"batch[{key!r}] must be split over {axis!r} "
                             "on dim 0")
        shape = (t.shape[0] // n_pods, *t.shape[1:])
        return DTensor.from_local(t.to_local(), sub, _without(t.placements, d),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    def whole(t: torch.Tensor) -> torch.Tensor:
        return t.full_tensor() if is_sharded(t) else t

    def pod_grads(params, batch):
        with activation_sharding(sub, TRAIN_RULES):
            return batch_grads(
                model, {k: to_sub(v, k) for k, v in params.items()},
                {k: pod_rows(v, k) for k, v in batch.items()},
                microbatches=microbatches)

    def grads_fn(params, batch, err):
        loss, grads = pod_grads(params, batch)
        out, new_err = {}, {}
        with torch.no_grad():
            for k, g in grads.items():
                work = whole(g).float() + err[k].to_local()[0]
                q, scale = quantize_int8(work)
                wire = q.float() * scale  # what goes on the wire
                n = work.numel()
                residual = work - wire.reshape(-1)[:n].reshape(work.shape)
                new_err[k] = DTensor.from_local(
                    residual[None], mesh, err[k].placements, run_check=False,
                    shape=err[k].shape, stride=err[k].stride())
                dist.all_reduce(wire, group=group)
                g_red = _div(wire, n_pods).reshape(-1)[:n].reshape(
                    work.shape)
                p = params[k]
                out[k] = DTensor.from_local(
                    g_red.to(g.dtype), mesh, [Replicate()] * mesh.ndim,
                    run_check=False).redistribute(mesh, p.placements)
            loss = whole(loss).detach().clone()
            dist.all_reduce(loss, group=group)
        return _div(loss, n_pods), out, new_err

    def train_step(params, opt_state, err, batch):
        loss, grads, new_err = grads_fn(params, batch, err)
        new_params, new_opt, metrics = apply_updates(opt_cfg, grads,
                                                     opt_state)
        return new_params, new_opt, new_err, dict(metrics, loss=loss)

    train_step.grads_fn = grads_fn
    train_step.pod_grads = pod_grads
    return train_step
