"""Checkpointing with a manifest and content hashes, and async writes.

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
``AsyncCheckpointer``, run on a writer thread. The reference's resharding
on restore (``shardings=``) waits for ROADMAP queue 1, item 11b: a leaf is
restored onto the target leaf's dtype and device.
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

from ..train.optimizer import leaf_order

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer",
           "latest_step"]

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


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(stored array, logical dtype) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree: Tree) -> Tree:
    """Host copies of every leaf, taken now."""
    if isinstance(tree, Mapping):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


def save_checkpoint(directory: str, step: int, tree: Tree, *,
                    extra: dict | None = None) -> str:
    """Write a checkpoint synchronously; returns the final path."""
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
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, target: Tree, *,
                       verify: bool = True) -> Tree:
    """Restore onto ``target``'s structure (a nested dict of tensors): each
    leaf a tensor of the target leaf's dtype on its device. Raises ``KeyError`` for a missing
    leaf, ``IOError`` for a content hash that does not match (``verify``)
    and ``ValueError`` for a shape that differs."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    out = {}
    for key, tgt in _flatten_with_keys(target).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, "arrays", meta["file"]))
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"hash mismatch for {key!r}: corrupt checkpoint")
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: shape {arr.shape} != target "
                             f"{tuple(tgt.shape)}")
        t = torch.from_numpy(arr.copy())  # writable, and 0-d stays 0-d
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        out[key] = t.to(device=tgt.device, dtype=tgt.dtype)
    return _unflatten_like(target, out)


class AsyncCheckpointer:
    """Background-thread checkpoint writer: ``save`` copies the tree to the
    host and returns; ``wait`` joins the writer and raises its first error.
    After each write the oldest steps beyond ``keep`` are deleted."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._err.append(e)

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Tree, *, extra: dict | None = None):
        # the host copy is taken now: the step after this one replaces the
        # parameters and updates the optimizer state in place
        self._q.put((step, _snapshot(tree), extra))

    def wait(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err[0]
