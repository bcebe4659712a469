#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 16 alone: a sharded training step's collectives
as coflows on the OCS fabric.

Trains TinyLlama-1.1B for 2 steps unsharded as phase 15(a) does (its
config, batch, microbatches and seed; ``remat_policy="full"`` so that it
fits without 15a's fallbacks) for 16(c)'s reference losses, then runs
``chip_smoke.comm_phases``: the dry runs of TinyLlama-1.1B and phi3.5-moe at
``train_4k`` on the 2x16x16 mesh of a fake world of 512 ranks (each in a
process of its own), their coflows planned on the card, and
``train_loop(mesh=...)`` on a 1x1 NCCL mesh against the unsharded losses.
About two minutes on the card with the assignment kernels' build. Run from
the root of the repository on a machine with an H100:

    python3 scripts/chip_phase16.py

It prints the phase's lines and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase16: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # puts src/ on the path
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.train import train_loop
    from repro_torch.train.optimizer import OptimizerConfig

    for name in ("coflow_assign_sm90", "coflow_assign_lanes_sm90"):
        _build.load(name)  # built before the phase, as in chip_smoke.py
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").config,
                              attention_impl="chunked", remat_policy="full")
    run = train_loop(cfg, steps=2, global_batch=chip_smoke.TRAIN_B,
                     seq_len=chip_smoke.TRAIN_S,
                     microbatches=chip_smoke.TRAIN_MB,
                     opt_cfg=OptimizerConfig(
                         lr=1e-3, warmup_steps=1,
                         total_steps=chip_smoke.TRAIN_STEPS),
                     log_every=0, device="cuda", seed=0)
    ref = {"cfg": cfg, "B": chip_smoke.TRAIN_B,
           "losses": [h["loss"] for h in run.history]}
    del run
    torch.cuda.empty_cache()
    chip_smoke.comm_phases(torch, torch.device("cuda"), ref)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
