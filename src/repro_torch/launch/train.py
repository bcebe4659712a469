"""Training launcher: data pipeline -> train loop on one device, with async
checkpointing, the straggler watchdog and exact resume.

Port of ``repro.launch.train``, on one device (CUDA unless the caller asks
for the CPU). The reference's ``mesh=`` (sharded training) and
``compress_pods=True`` (int8 cross-pod gradients) wait for
``distributed/`` (ROADMAP queue 1, item 11) and raise here.

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 200 \
      --d-model 512 --layers 8 --global-batch 8 --seq-len 256
"""
from __future__ import annotations

import argparse
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
from ..distributed.fault import StepWatchdog
from ..models.api import build_model
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.step import build_train_step

__all__ = ["TrainRun", "train_loop", "main"]


@dataclasses.dataclass
class TrainRun:
    model: object
    params: dict
    opt_state: dict
    history: list
    steps_done: int
    step_s: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)


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
    as floats, ``step_s`` each step's seconds (what the watchdog saw) and
    ``stragglers`` the watchdog's ``(step, seconds, median)`` flags.
    """
    if mesh is not None or compress_pods:
        raise NotImplementedError(
            "sharded training (mesh=) and int8 cross-pod compression "
            "(compress_pods=True) wait for distributed/: ROADMAP queue 1, "
            "item 11")
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    opt_cfg = opt_cfg or OptimizerConfig(total_steps=steps,
                                         warmup_steps=max(steps // 20, 1))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = init_opt_state(params)
    watchdog = StepWatchdog()

    corpus = SyntheticCorpus(cfg.vocab, seed=data_seed)
    loader = PackedLoader(corpus, global_batch=global_batch, seq_len=seq_len)
    step_fn = build_train_step(model, opt_cfg, microbatches=microbatches)

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last:
            restored = restore_checkpoint(
                ckpt_dir, last, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            start = last
            loader.step = last

    history, step_s = [], []
    it = iter(loader)
    try:
        for step in range(start, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(it).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
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
            ckpt.wait()
    return TrainRun(model=model, params=params, opt_state=opt_state,
                    history=history, steps_done=steps, step_s=step_s,
                    stragglers=list(watchdog.stragglers))


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
