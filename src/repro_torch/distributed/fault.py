"""Fault tolerance of the training loop: ``DeviceLoss`` and the step
watchdog.

Port of the single-process half of ``repro.distributed.fault``.
``StepWatchdog`` flags straggler steps, a step slower than ``factor`` x the
rolling median of the recent ones. ``ElasticTrainer`` (re-meshing on
device loss, with the fabric wiring) waits for ROADMAP queue 1, item 11b.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np

__all__ = ["DeviceLoss", "StepWatchdog"]


class DeviceLoss(RuntimeError):
    """Raised (or injected) when devices drop out of the cluster."""

    def __init__(self, lost: int = 1):
        super().__init__(f"lost {lost} device(s)")
        self.lost = lost


@dataclasses.dataclass
class StepWatchdog:
    """Flags straggler steps: wall time > factor x rolling median."""

    factor: float = 3.0
    window: int = 32
    min_samples: int = 5
    on_straggler: Callable[[int, float, float], None] | None = None
    _times: deque = dataclasses.field(default_factory=lambda: deque(maxlen=32))
    stragglers: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        is_straggler = False
        if len(self._times) >= self.min_samples:
            med = float(np.median(self._times))
            if seconds > self.factor * med:
                is_straggler = True
                self.stragglers.append((step, seconds, med))
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        self._times.append(seconds)
        return is_straggler
