"""Sharded checkpointing with a manifest and content hashes, async writes,
and restore onto other shardings.

Port of ``repro.distributed.checkpoint``, with the reference's layout on
disk, so that a checkpoint written by either package restores in the
other:

  <dir>/step_<N:08d>/
    manifest.json            step, time, extra, and per leaf its file,
                             shape, logical dtype and sha256
    arrays/<leaf-key>.npy    one file per leaf (the whole tensor), the key's
                             "/" written "__"

A tree is a nested dict of tensors (or numpy arrays); a leaf's key joins
the dict keys with "/", and a dotted state-dict name counts as a path, so
``{"params": {"blocks.wq": t}}`` is ``params/blocks/wq``, the reference's
key of the same leaf. bf16 is stored as its ``uint16`` bits (numpy has no
bf16) and the manifest keeps the logical dtype; the hash is of the stored
bytes. Writes are atomic (a ``.tmp`` directory, then a rename) and, through
``AsyncCheckpointer``, run on a writer thread.

Sharded trees (one process per rank): a DTensor leaf is written whole, so
every rank of its mesh takes part in its ``full_tensor()`` gather, and
the mesh's first rank (``writer_rank``) alone writes, renames and deletes
old steps. The save ends in a barrier over the mesh, so no rank reads a
step that is still ``.tmp``. On restore
(``shardings=``) each rank reads only its block of each file (``np.load``
memory-mapped, then the slice of ``distributed.sharding.local_slices``)
and builds the leaf with ``DTensor.from_local``, as ``shard_tensor`` does.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from ..models.common import is_sharded
from ..train.optimizer import leaf_order
from .sharding import local_slices, mesh_axes

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer",
           "latest_step", "writer_rank"]

Tree = Any


def _flatten_with_keys(tree: Tree, prefix: tuple = ()) -> dict[str, Any]:
    """Leaves by "/"-joined key, in the reference's order (dict keys sorted
    at each level, a dotted name split into its parts)."""
    if not isinstance(tree, Mapping):
        return {"/".join(prefix): tree}
    out = {}
    for key in leaf_order(tree):
        out.update(_flatten_with_keys(tree[key],
                                      prefix + tuple(key.split("."))))
    return out


def _unflatten_like(target: Tree, leaves: dict[str, Any],
                    prefix: tuple = ()) -> Tree:
    if not isinstance(target, Mapping):
        return leaves["/".join(prefix)]
    return {k: _unflatten_like(v, leaves, prefix + tuple(str(k).split(".")))
            for k, v in target.items()}


def writer_rank(mesh) -> int:
    """The global rank that writes a sharded tree on ``mesh``: its first."""
    return int(mesh.mesh.flatten()[0])


def _is_writer(mesh) -> bool:
    """Whether this process writes a tree on ``mesh``: always for a tree
    without DTensors, else where it is the mesh's ``writer_rank``."""
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == writer_rank(mesh)


def _mesh_of(tree: Tree):
    """The mesh of the tree's first DTensor leaf (``None``: no DTensor)."""
    for leaf in _flatten_with_keys(tree).values():
        if is_sharded(leaf):
            return leaf.device_mesh
    return None


def _barrier(mesh) -> None:
    """Wait for every rank of ``mesh``: a barrier on each of its dims in
    turn (after the last one, every rank of the mesh has reached the
    first)."""
    import torch.distributed as dist

    if mesh is None:
        return
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d))


def _snapshot(tree: Tree, keep: bool = True) -> Tree:
    """Host copies of every leaf, taken now, a DTensor gathered whole
    (every rank of its mesh takes part); ``None`` where not ``keep``."""
    if isinstance(tree, Mapping):
        out = {k: _snapshot(v, keep) for k, v in tree.items()}
        return out if keep else None
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if is_sharded(tree) else tree
        return t.detach().to("cpu", copy=True) if keep else None
    return np.array(tree) if keep else None


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(stored array, logical dtype) of a host tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write(directory: str, step: int, tree: Tree, extra: dict | None
           ) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    manifest = {"step": step, "created": time.time(), "extra": extra or {},
                "leaves": {}}
    for key, leaf in _flatten_with_keys(tree).items():
        arr, logical = _to_host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, "arrays", fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": logical,
            "sha256": _sha256(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _sha256(arr: np.ndarray) -> str:
    """The hash of ``arr.tobytes()``, read in place (a memory-mapped file
    is not copied)."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    return hashlib.sha256(flat.view(np.uint8)).hexdigest()


def save_checkpoint(directory: str, step: int, tree: Tree, *,
                    extra: dict | None = None) -> str:
    """Write a checkpoint synchronously; returns the final path. Every rank
    of a sharded tree's mesh calls it; the mesh's first rank writes."""
    mesh = _mesh_of(tree)
    host = _snapshot(tree, keep=_is_writer(mesh))
    final = os.path.join(directory, f"step_{step:08d}")
    if host is not None:
        final = _write(directory, step, host, extra)
    _barrier(mesh)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _global_stride(shape: tuple) -> tuple:
    return torch.empty(shape, device="meta").stride()


def restore_checkpoint(directory: str, step: int, target: Tree,
                       shardings: Tree | None = None, *,
                       verify: bool = True) -> Tree:
    """Restore onto ``target``'s structure (a nested dict of tensors).

    Without a sharding a leaf comes back whole, a tensor of the target
    leaf's dtype on its device. ``shardings`` is a tree of the same keys
    whose leaves are ``sharding.NamedSharding(mesh, plan)`` (a
    ``DeviceMesh`` and a ``ShardPlan`` of ``plan_tree``) or ``None``; a
    missing key counts as ``None``. Such a leaf comes back as a DTensor on
    ``mesh`` with ``plan``'s placements, of the target leaf's dtype, built
    from this rank's block alone, whatever mesh wrote the checkpoint;
    this rank must belong to ``mesh``. Raises ``KeyError`` for a missing
    leaf, ``IOError`` for a content hash (of the whole stored array) that
    does not match (``verify``) and ``ValueError`` for a shape that
    differs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    sh_leaves = _flatten_with_keys(shardings) if shardings is not None \
        else {}
    out = {}
    for key, tgt in _flatten_with_keys(target).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, "arrays", meta["file"]),
                      mmap_mode="r")
        if verify and _sha256(arr) != meta["sha256"]:
            raise IOError(f"hash mismatch for {key!r}: corrupt checkpoint")
        shape = tuple(arr.shape)
        if shape != tuple(tgt.shape):
            raise ValueError(f"{key}: shape {arr.shape} != target "
                             f"{tuple(tgt.shape)}")
        sh = sh_leaves.get(key)
        if sh is not None:
            mesh, plan = sh
            coord = mesh.get_coordinate()
            if coord is None:
                raise ValueError(f"{key}: this rank is not in the mesh it "
                                 "is restored onto")
            sizes = mesh_axes(mesh)
            arr = arr[local_slices(shape, sizes, dict(zip(sizes, coord)),
                                   plan.spec)]
        t = torch.from_numpy(np.array(arr))  # writable, and 0-d stays 0-d
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        if sh is None:
            out[key] = t.to(device=tgt.device, dtype=tgt.dtype)
            continue
        from torch.distributed.tensor import DTensor

        dev = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        out[key] = DTensor.from_local(
            t.to(device=dev, dtype=tgt.dtype), mesh, plan.placements,
            run_check=False, shape=torch.Size(shape),
            stride=_global_stride(shape))
    return _unflatten_like(target, out)


class AsyncCheckpointer:
    """Background-thread checkpoint writer: ``save`` copies the tree to the
    host and returns; ``flush`` waits for the writes queued so far,
    ``wait`` also ends the writer; both then wait for every rank of the
    mesh they are given (the ranks that read the checkpoints next, with
    the writer) and raise the writer's first error. After each write the
    oldest steps beyond ``keep`` are deleted. Sharded, every rank of the
    mesh saves (each takes part in the gathers) and the mesh's first rank
    (``writer_rank``) alone queues and writes. ``timings`` holds one dict a save:
    ``step``, ``snapshot_s`` (the gathers and the host copy, in ``save``)
    and, where this rank writes, ``write_s`` (the files and their hashes,
    on the writer thread)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self.timings: list[dict] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host_tree, extra, timing = item
                t0 = time.perf_counter()
                _write(self.directory, step, host_tree, extra)
                timing["write_s"] = time.perf_counter() - t0
                self._gc()
            except BaseException as e:  # surfaced on flush() and wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Tree, *, extra: dict | None = None):
        # the host copy is taken now: the step after this one replaces the
        # parameters and updates the optimizer state in place
        mesh = _mesh_of(tree)
        t0 = time.perf_counter()
        host = _snapshot(tree, keep=_is_writer(mesh))
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        if host is not None:
            self._q.put((step, host, extra, timing))

    def _done(self, mesh):
        _barrier(mesh)
        if self._err:
            raise self._err[0]

    def flush(self, mesh=None):
        """Wait for the queued writes, then for every rank of ``mesh`` (a
        ``DeviceMesh``; ``None``: for no other rank)."""
        self._q.join()
        self._done(mesh)

    def wait(self, mesh=None):
        """End the writer, then wait for every rank of ``mesh`` (as
        ``flush``)."""
        self._q.put(None)
        self._thread.join()
        self._done(mesh)
