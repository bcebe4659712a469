"""CLI entry point: ``python -m repro_torch.analysis.lint PATHS``."""
from __future__ import annotations

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
