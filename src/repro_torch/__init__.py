"""PyTorch/CUDA port of the multi-core OCS coflow scheduler (``repro``).

The port runs Algorithm 1 on an NVIDIA H100, offline, online and as a
streaming fabric manager (``core``, ``service``, ``obs``): demand tensors,
WSPT ordering and flow extraction on the device, the cross-core assignment
on the fp64 host backend or (opt-in) as a hand-written CUDA kernel
(``kernels/csrc/coflow_assign_sm90.cu``), the circuit event loops on the
host, and the feasibility referee and CCT metrics back on the device. The
model zoo (``models``, ``configs``) serves every family (``serve``), its
prefill attention through a hand-written flash-attention kernel, and
trains on one device or sharded over a ``DeviceMesh`` (``launch.train``:
``data``, ``train``, the checkpointer, watchdog and sharding planner of
``distributed``). ``launch.dryrun`` traces a sharded step on a production
mesh without allocating (``analysis`` counts its collectives and FLOPs
against the H100's peaks), and ``comm`` turns the step's cross-block
collectives into coflows that Algorithm 1 plans on the fabric.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; there
is no silent fallback (see :func:`resolve_device`). On the CPU every kernel
wrapper runs its plain PyTorch version. The package imports ``torch`` and
``numpy`` only: nothing of ``jax`` and nothing of the ``repro`` reference
package.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
