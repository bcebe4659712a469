#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14 alone: the other model families at full width.

Runs ``chip_smoke.family_phases`` (recurrentgemma-9b, seamless-m4t-large-v2,
phi3.5-moe, qwen3-moe, internvl2-76b and xlstm-1.3b, one at a time; see
``chip_smoke.py``'s docstring) with the same checks, helpers and limits: a
few minutes on the card instead of the whole script's thirteen. Run from the
root of the repository on a machine with an H100:

    python3 scripts/chip_phase14.py

It prints the phase's lines, the kernel rows of its shapes as JSON, and the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase14: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # puts src/ on the path
    from repro_torch.kernels import _build

    for name in ("flash_attention_sm90", "flash_attention"):
        _build.load(name)  # built before the phase, as in chip_smoke.py
    _, rows = chip_smoke.family_phases(torch, torch.device("cuda"))
    print(json.dumps({"kernels": rows}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
