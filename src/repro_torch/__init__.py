"""PyTorch/CUDA port of the multi-core OCS coflow scheduler (``repro``).

The port runs Algorithm 1's offline path on an NVIDIA H100: demand tensors,
WSPT ordering and flow extraction on the device, the tau-aware cross-core
assignment as a hand-written CUDA kernel (``kernels/csrc/coflow_assign.cu``),
the circuit event loop on the host, and the feasibility referee and CCT
metrics back on the device.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; there
is no silent fallback (see :func:`resolve_device`). On the CPU every kernel
wrapper runs its plain PyTorch version. The package imports ``torch`` and
``numpy`` only: nothing of ``jax`` and nothing of the ``repro`` reference
package.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
