#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 17 alone: sharded checkpoints and their restore,
the int8 cross-pod step and the elastic trainer with the fabric.

Trains TinyLlama-1.1B for 4 steps unsharded as phase 15(a) does (its
config, batch, microbatches and seed) for 17's reference losses (the first
two, and steps 3-4 as the uninterrupted run 17(b)'s resume must equal) and
peak memory (``max_memory_allocated``), then runs
``chip_smoke.elastic_phases``:
17(a) the dry run's peak estimate of that step in a process of its own,
17(b) a full-width sharded checkpoint, its restore and a resume on a 1x1
NCCL mesh, 17(c) the compressed step on a (1, 1, 1) mesh, 17(d)
``ElasticTrainer`` at 15(c)'s mid size with a CUDA ``FabricManager``. About
three minutes on the card. Run from the root of the repository on a
machine with an H100:

    python3 scripts/chip_phase17.py

It prints the phase's lines and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase17: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # puts src/ on the path
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train_loop
    from repro_torch.train.optimizer import OptimizerConfig

    full = dataclasses.replace(get_arch("tinyllama-1.1b").config,
                               attention_impl="chunked")
    torch.cuda.reset_peak_memory_stats()
    run = train_loop(full, steps=4, global_batch=chip_smoke.TRAIN_B,
                     seq_len=chip_smoke.TRAIN_S,
                     microbatches=chip_smoke.TRAIN_MB,
                     opt_cfg=OptimizerConfig(
                         lr=1e-3, warmup_steps=1,
                         total_steps=chip_smoke.TRAIN_STEPS),
                     log_every=0, device="cuda", seed=0)
    ref = {"cfg": full, "B": chip_smoke.TRAIN_B,
           "losses": [h["loss"] for h in run.history[:2]],
           "later_losses": [h["loss"] for h in run.history[2:4]],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "step_s": run.step_s[-1],
           "mid": dataclasses.replace(full, name="tinyllama-mid",
                                      d_model=512, n_heads=8, n_kv_heads=4,
                                      d_ff=1408, n_layers=4)}
    print(f"[15a] 4 steps: losses {ref['losses'] + ref['later_losses']!r}, "
          f"step times "
          f"{[round(t, 3) for t in run.step_s]} s, peak max_memory_allocated "
          f"{ref['peak_bytes'] / 2 ** 30:.2f} GiB", flush=True)
    del run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chip_smoke.elastic_phases(torch, torch.device("cuda"), ref)
    print(f"phase 17 alone: {time.perf_counter() - t0:.1f} s")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
