#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone: the port's linter over the port's
tree, then the seven ``examples/torch_*.py`` on the card, each in a process
of its own, all started together (``chip_smoke.example_phases``). Under a
minute on the card. Run from the root of the repository on a machine with
an H100:

    python3 scripts/chip_phase18.py

It prints the phase's lines and the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase18: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # puts src/ on the path

    torch.zeros(1, device="cuda")  # the parent holds a context, as in the script
    chip_smoke.example_phases(torch)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
