"""Production meshes, as ``DeviceMesh``es.

Port of ``repro.launch.mesh``. Importing this module touches no process
group; meshes are built by functions only, on the process group the caller
started (NCCL or gloo for a run, :func:`fake_world` for the dry run).

Single pod : (16, 16)    -> ("data", "model")         = 256 ranks
Multi pod  : (2, 16, 16) -> ("pod", "data", "model")  = 512 ranks
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_mesh", "fake_world"]


def make_mesh(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    default process group, in C order (e.g. ``(2, 2, 2)`` on a fake world of
    8, ``(2, 2)`` on 4 gloo ranks with ``device_type="cpu"``; the single-pod
    mesh on a fake world of 512 takes ranks 0-255)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def fake_world(n: int, *, rank: int = 0) -> None:
    """Start the default process group as torch's ``fake`` backend of ``n``
    ranks, seen from ``rank``: collectives return at once and move nothing,
    which is what a trace on ``meta`` tensors needs.

    Raises if a process group already exists, so a process that holds one
    (an NCCL group, say) cannot silently trace on it; the fake group and a
    real one cannot share a process.
    """
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} ranks already exists; the fake world "
            "runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
