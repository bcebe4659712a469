"""Training launcher: data pipeline -> train loop, with async
checkpointing, the straggler watchdog and exact resume.

Port of ``repro.launch.train``: on one device (CUDA unless the caller asks
for the CPU), or sharded over a ``DeviceMesh`` (``mesh=``: one process per
rank, on the process group the caller started), with checkpoints that a
sharded run writes whole and restores onto its own shardings, and, on a
mesh with a "pod" axis, int8 cross-pod gradient compression
(``compress_pods=True``, ``distributed.compression``).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 200 \
      --d-model 512 --layers 8 --global-batch 8 --seq-len 256
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_arch
from ..data.pipeline import PackedLoader, SyntheticCorpus
from ..device import resolve_device
from ..distributed.checkpoint import (AsyncCheckpointer, latest_step,
                                      restore_checkpoint)
from ..distributed.compression import (build_compressed_train_step,
                                       init_error_state)
from ..distributed.fault import StepWatchdog
from ..distributed.sharding import (TRAIN_RULES, NamedSharding, batch_spec,
                                    mesh_axes, plan_tree, shard_module,
                                    shard_tensor)
from ..models.api import build_model
from ..models.common import activation_sharding, is_sharded
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.step import build_train_step

__all__ = ["TrainRun", "train_loop", "elastic_build", "main"]


@dataclasses.dataclass
class TrainRun:
    model: object
    params: dict
    opt_state: dict
    history: list
    steps_done: int
    step_s: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)
    ckpt_timings: list = dataclasses.field(default_factory=list)


def _model_on(cfg, mesh, device, seed: int):
    """``(model, device, shardings)``: ``cfg``'s model with weights drawn
    from ``seed``, on ``device`` or sharded on ``mesh`` by ``TRAIN_RULES``
    (its device then the mesh's); ``shardings`` is the restore target's
    tree of a ``{"params", "opt"}`` state (``None`` without a mesh)."""
    if mesh is None:
        dev = resolve_device(device)
    elif mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    if mesh is None:
        return model, dev, None
    params = {k: p.detach() for k, p in model.named_parameters()}
    plan = plan_tree(mesh, params, model.param_axes(cfg), TRAIN_RULES)
    shard_module(model, mesh, plan)
    named = {k: NamedSharding(mesh, p) for k, p in plan.items()}
    return model, dev, {"params": named, "opt": {
        "master": named, "m": named, "v": named, "step": None}}


def _put_batch(arrays: dict, dev, mesh) -> dict:
    """A loader's host batch on ``dev``, split by ``batch_spec`` on
    ``mesh`` (every rank holds the same global batch)."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    if mesh is None:
        return batch
    return {k: shard_tensor(v, mesh, batch_spec(mesh, v.ndim, v.shape[0]))
            for k, v in batch.items()}


def _host_metrics(metrics: dict) -> dict:
    """A step's 0-d metric tensors (DTensors gathered) as floats."""
    return {k: float(v.full_tensor() if is_sharded(v) else v)
            for k, v in metrics.items()}


def elastic_build(cfg, opt_cfg: OptimizerConfig, *, seed: int = 0,
                  microbatches: int = 1):
    """``build(mesh) -> (step_fn, make_state, shardings_of)`` of
    ``distributed.fault.ElasticTrainer`` for ``cfg``: on each mesh, the
    model of ``train_loop(mesh=)`` (weights from ``seed``, sharded by
    ``TRAIN_RULES``), a state ``{"params", "opt"}`` as that loop keeps it,
    and a step that takes a loader's host batch (``PackedLoader``), puts
    it on the mesh by ``batch_spec`` and returns the metrics as floats."""

    def build(mesh):
        model, dev, shardings = _model_on(cfg, mesh, None, seed)
        inner = build_train_step(model, opt_cfg, microbatches=microbatches)
        init = {k: p.detach().clone() for k, p in model.named_parameters()}

        def step_fn(state, arrays):
            with activation_sharding(mesh, TRAIN_RULES):
                params, opt, metrics = inner(state["params"], state["opt"],
                                             _put_batch(arrays, dev, mesh))
            return {"params": params, "opt": opt}, _host_metrics(metrics)

        def make_state():  # the seed's weights, whatever the steps did
            params = {k: p.clone() for k, p in init.items()}
            return {"params": params, "opt": init_opt_state(params)}

        return step_fn, make_state, lambda state: shardings

    return build


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               opt_cfg: OptimizerConfig | None = None, mesh=None,
               microbatches: int = 1, compress_pods: bool = False,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               log_every: int = 10, seed: int = 0, data_seed: int = 0,
               device=None) -> TrainRun:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` sequences of
    ``seq_len`` tokens from ``SyntheticCorpus(cfg.vocab, seed=data_seed)``.

    The weights are drawn from a generator seeded with ``seed`` on
    ``device`` (``None``: CUDA). With ``ckpt_dir`` a checkpoint is written every
    ``ckpt_every`` steps on a writer thread, and a run resumes from the
    latest one there: parameters, optimizer state and the data stream.
    Each step's time is read once its metrics are on the host, so the
    watchdog sees the device's time. ``history`` holds each step's metrics
    as floats, ``step_s`` each step's seconds (what the watchdog saw),
    ``stragglers`` the watchdog's ``(step, seconds, median)`` flags and
    ``ckpt_timings`` the checkpointer's (``AsyncCheckpointer.timings``).

    With ``mesh`` (a ``DeviceMesh`` of this process group, on the mesh's
    device type; ``device`` is then not read) every rank draws the same
    weights and reads the same batches, and shards the parameters, the
    optimizer state and each batch by ``TRAIN_RULES`` and ``batch_spec``
    (``DTensor.from_local`` of its own blocks); the step runs under
    ``activation_sharding``. ``params`` and ``opt_state`` come back as
    DTensors, ``history`` as the global values. A sharded run's checkpoint
    holds each leaf whole (the mesh's first rank writes it) and resumes
    onto the run's own shardings, each rank reading its blocks.

    ``compress_pods=True`` (a mesh with a "pod" axis) takes each step from
    ``build_compressed_train_step``: every pod's gradient on its own rows,
    then the int8 hop over "pod" with error feedback; the residuals start
    at zero, also on a resume (they are not checkpointed, as in the
    reference).
    """
    if compress_pods and (mesh is None
                          or "pod" not in (mesh.mesh_dim_names or ())):
        raise ValueError("compress_pods=True needs a mesh with a 'pod' axis")
    model, dev, shardings = _model_on(cfg, mesh, device, seed)
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps,
                                         warmup_steps=max(steps // 20, 1))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = init_opt_state(params)
    watchdog = StepWatchdog()

    corpus = SyntheticCorpus(cfg.vocab, seed=data_seed)
    loader = PackedLoader(corpus, global_batch=global_batch, seq_len=seq_len)
    err = None
    if compress_pods:
        step_fn = build_compressed_train_step(model, opt_cfg, mesh,
                                              microbatches=microbatches)
        err = init_error_state(params, mesh_axes(mesh)["pod"])
    else:
        step_fn = build_train_step(model, opt_cfg, microbatches=microbatches)

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last:
            restored = restore_checkpoint(
                ckpt_dir, last, {"params": params, "opt": opt_state},
                shardings)
            params, opt_state = restored["params"], restored["opt"]
            start = last
            loader.step = last

    history, step_s = [], []
    it = iter(loader)
    sharded = (contextlib.nullcontext() if mesh is None
               else activation_sharding(mesh, TRAIN_RULES))
    try:
        for step in range(start, steps):
            batch = _put_batch(next(it), dev, mesh)
            t0 = time.perf_counter()
            with sharded:
                if compress_pods:
                    params, opt_state, err, metrics = step_fn(
                        params, opt_state, err, batch)
                else:
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
            metrics = _host_metrics(metrics)
            step_s.append(time.perf_counter() - t0)
            watchdog.observe(step, step_s[-1])
            history.append(metrics)
            if log_every and (step + 1) % log_every == 0:
                print(f"step {step+1:5d} loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} "
                      f"lr={metrics['lr']:.2e}", flush=True)
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        loader.close()
        if ckpt:
            ckpt.wait(mesh)
    return TrainRun(model=model, params=params, opt_state=opt_state,
                    history=history, steps_done=steps, step_s=step_s,
                    stragglers=list(watchdog.stragglers),
                    ckpt_timings=list(ckpt.timings) if ckpt else [])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' only when "
                         "asked for)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.config
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    run = train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     opt_cfg=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                             warmup_steps=max(args.steps // 20, 1)),
                     microbatches=args.microbatches, device=args.device)
    first = np.mean([h["loss"] for h in run.history[:10]])
    last = np.mean([h["loss"] for h in run.history[-10:]])
    print(json.dumps({"first10_loss": float(first), "last10_loss": float(last),
                      "stragglers": len(run.stragglers)}))


if __name__ == "__main__":
    main()
