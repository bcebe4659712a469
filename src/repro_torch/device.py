"""Where the port's tensors live: CUDA by default, the CPU only on request."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda``. A CUDA device that is not available raises
    instead of falling back to the CPU: a run that silently left the card
    would report CPU numbers as device numbers. ``"cpu"`` is honoured only
    when asked for (the tests do), and then every kernel wrapper runs its
    plain PyTorch version.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
