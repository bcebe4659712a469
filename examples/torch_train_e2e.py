"""End-to-end driver on the port: train a ~100M-parameter llama-family model
for a few hundred steps on the synthetic corpus, with checkpointing and the
straggler watchdog.

  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300] [--small] \\
      [--ckpt-dir DIR] [--device cpu]

The port of ``examples/train_e2e.py``: the same configs (the default is
12L x 640d with a 32k vocab, 8 x 512 tokens a step; ``--small`` trims to
6L x 256d, 4 x 256 tokens and at most 100 steps for quick CPU runs), a
checkpoint every 50 steps (a run resumes from the latest one in
``--ckpt-dir``), on CUDA unless ``--device cpu``. The last line is the
reference's JSON summary.
"""
import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.train import train_loop
from repro_torch.models.api import build_model
from repro_torch.models.common import param_count
from repro_torch.train.optimizer import OptimizerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    base = get_arch("tinyllama-1.1b").config
    if args.small:
        cfg = dataclasses.replace(base, n_layers=6, d_model=256, n_heads=8,
                                  n_kv_heads=4, d_ff=768, vocab=8192)
        gb, sl = 4, 256
        steps = min(args.steps, 100)
    else:
        # ~100M params: 12L x 640d, 32k vocab
        cfg = dataclasses.replace(base, n_layers=12, d_model=640, n_heads=10,
                                  n_kv_heads=5, d_ff=1792, vocab=32000)
        gb, sl = 8, 512
        steps = args.steps

    n_params = param_count(build_model(cfg, device="meta"))
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"-> {n_params/1e6:.1f}M params; {steps} steps of "
          f"{gb}x{sl} tokens")

    run = train_loop(
        cfg, steps=steps, global_batch=gb, seq_len=sl,
        opt_cfg=OptimizerConfig(lr=6e-4, total_steps=steps,
                                warmup_steps=max(steps // 20, 5)),
        ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10, device=dev)

    losses = [h["loss"] for h in run.history]
    summary = {
        "params_m": round(n_params / 1e6, 1),
        "first10_loss": float(np.mean(losses[:10])),
        "last10_loss": float(np.mean(losses[-10:])),
        "steps": run.steps_done,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
