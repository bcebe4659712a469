"""Fault tolerance and elasticity of the training loop.

Port of ``repro.distributed.fault``. Production model (1000+ nodes):
hardware failures are routine; the loop must (a) checkpoint continuously
(async, see ``checkpoint``), (b) detect stragglers and hangs, and (c) on
device loss rebuild the mesh from the survivors and continue from the last
checkpoint with resharded state (elastic shrink), or grow back when
capacity returns. Failures are injected here (``DeviceLoss`` raised by a
hook); the supervisor logic (watchdog, re-mesh, restore) is the code a
deployment runs.

Components:
  StepWatchdog      wall-clock watchdog; flags steps slower than
                    ``factor`` x rolling median (straggler mitigation).
  ElasticTrainer    drives train steps; on ``DeviceLoss`` drops to the next
                    mesh of a fallback chain, replans shardings, restores
                    the last checkpoint onto it and resumes. ``grow()``
                    does the inverse. With a fabric, the OCS cores of the
                    dropped mesh go down with it.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

__all__ = ["DeviceLoss", "StepWatchdog", "ElasticTrainer"]


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


def _device_mesh(mesh):
    """``mesh`` if it is a ``DeviceMesh`` (a mesh of the caller's process
    group), else ``None``."""
    return mesh if hasattr(mesh, "get_coordinate") else None


class ElasticTrainer:
    """Train-loop supervisor with checkpoint/restart and elastic re-meshing.

    ``build`` is a callback ``(mesh) -> (step_fn, make_state,
    shardings_of)`` so the trainer can re-plan for any surviving mesh:

      step_fn(state, batch) -> (state, metrics)
      make_state()          -> fresh state tree (on that mesh)
      shardings_of(state)   -> the matching tree of ``NamedSharding``
                               leaves (``restore_checkpoint``'s)

    (``launch.train.elastic_build`` makes one for a model config.)
    ``meshes`` is the fallback chain, largest first.

    Fabric wiring (one-story device loss): pass ``fabric`` (a
    ``service.FabricManager``) and ``mesh_cores``: ``mesh_cores[i]`` is the
    set of OCS core ids serving ``meshes[i]``. When a ``DeviceLoss``
    shrinks the mesh, the cores that only the larger mesh used are reported
    down to the fabric (``report_fault(CoreDown(...))``, at the fabric
    stream's current time): in-flight circuits on them are aborted and
    re-queued over the survivors, affected program-cache entries are
    purged, and the next fabric tick re-derives the tentative schedule.
    ``grow()`` reports the cores back up.

    One process a rank: the meshes are ``DeviceMesh``es that every rank
    made before the trainer (a mesh makes its process groups with every
    rank of the default group), and all share their first rank, which
    writes the checkpoints (``checkpoint.writer_rank``), so that the
    writes a dropped rank's mesh queued are done before a survivor reads
    them. ``build`` runs only on the ranks of the current mesh.
    ``DeviceLoss`` strikes every rank of the mesh at the same step (as a
    failure detector tells every survivor). A rank that the smaller mesh
    drops ends its checkpointer (it queues no write: the writer stays) and
    leaves ``run`` at once, returning ``(None, step, history)``: no
    state, the step the loss struck at, and the metrics of the steps it
    took; its ``events`` end with the shrink. Each survivor waits for the
    checkpoint writes queued so far and for the other survivors
    (``AsyncCheckpointer.flush`` over the new mesh), so that all restore
    the same step; call ``ckpt.wait(mesh)`` when done. A mesh that is not
    a ``DeviceMesh`` (an object with a ``shape`` mapping) holds every
    caller.
    """

    def __init__(self, build: Callable, meshes: list, ckpt_dir: str,
                 *, ckpt_every: int = 10, watchdog: StepWatchdog | None = None,
                 fabric=None, mesh_cores: list | None = None):
        from .checkpoint import AsyncCheckpointer, writer_rank

        if (fabric is None) != (mesh_cores is None):
            raise ValueError("fabric and mesh_cores go together")
        if mesh_cores is not None:
            if len(mesh_cores) != len(meshes):
                raise ValueError(
                    f"mesh_cores must map every mesh: got {len(mesh_cores)} "
                    f"entries for {len(meshes)} meshes")
            # the fallback chain must be nested: shrinking may only take
            # cores DOWN (a non-subset chain would report a core "up" that
            # never went down, mid-recovery, and kill the recovery itself)
            for i in range(len(mesh_cores) - 1):
                extra = set(mesh_cores[i + 1]) - set(mesh_cores[i])
                if extra:
                    raise ValueError(
                        f"mesh_cores must be a nested fallback chain; "
                        f"entry {i + 1} adds cores {sorted(extra)} not in "
                        f"entry {i}")
        writers = {i: writer_rank(m) for i, m in
                   enumerate(map(_device_mesh, meshes)) if m is not None}
        for i, r in writers.items():
            if r != writers[0]:
                raise ValueError(
                    f"mesh {i} starts with rank {r}, not rank {writers[0]}, "
                    "the first rank of mesh 0, which writes the checkpoints")
        self.build = build
        self.meshes = meshes  # ordered largest -> smallest fallback chain
        self.mesh_idx = 0
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.watchdog = watchdog or StepWatchdog()
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.fabric = fabric
        self.mesh_cores = mesh_cores
        self.events: list[dict] = []
        self._setup()

    @property
    def mesh(self):
        return self.meshes[self.mesh_idx]

    @property
    def member(self) -> bool:
        """Whether this rank belongs to the current mesh."""
        m = _device_mesh(self.mesh)
        return m is None or m.get_coordinate() is not None

    def _setup(self):
        if self.member:
            self.step_fn, self.make_state, self.shardings_of = \
                self.build(self.mesh)
        else:
            self.step_fn = self.make_state = self.shardings_of = None

    def _sync_fabric(self, prev_idx: int):
        """Shrink/grow the circuit plane to match the new mesh's core set."""
        if self.fabric is None or prev_idx == self.mesh_idx:
            return
        from ..core.fault import CoreDown, CoreUp

        t = float(self.fabric.state.t_now)
        prev = set(self.mesh_cores[prev_idx])
        cur = set(self.mesh_cores[self.mesh_idx])
        for k in sorted(prev - cur):
            rep = self.fabric.report_fault(CoreDown(t=t, core=k))
            self.events.append({"event": "fabric-core-down", "core": k,
                                "aborted": rep.aborted,
                                "requeued": rep.requeued})
        for k in sorted(cur - prev):
            self.fabric.report_fault(CoreUp(t=t, core=k))
            self.events.append({"event": "fabric-core-up", "core": k})

    def _restore_or_init(self):
        from .checkpoint import latest_step, restore_checkpoint

        state = self.make_state()
        last = latest_step(self.ckpt_dir)
        if last is None:
            return state, 0
        state = restore_checkpoint(self.ckpt_dir, last, state,
                                   self.shardings_of(state))
        return state, last

    def _shape(self) -> dict:
        from .sharding import mesh_axes

        return mesh_axes(self.mesh)

    def shrink(self):
        """Drop to the next-smaller mesh in the fallback chain (and shrink
        the circuit plane with it when a fabric is wired)."""
        if self.mesh_idx + 1 >= len(self.meshes):
            raise RuntimeError("no smaller mesh available — cluster lost")
        prev = self.mesh_idx
        self.mesh_idx += 1
        self.events.append({"event": "shrink", "to": self._shape()})
        self._sync_fabric(prev)
        self._setup()

    def grow(self):
        if self.mesh_idx > 0:
            prev = self.mesh_idx
            self.mesh_idx -= 1
            self.events.append({"event": "grow", "to": self._shape()})
            self._sync_fabric(prev)
            self._setup()

    def run(self, batches, *, start_state=None, max_steps: int | None = None,
            inject: Callable[[int], None] | None = None):
        """Drive steps over ``batches`` (an iterable of batches). Returns
        ``(final_state, step, metrics_history)``; a rank outside the
        current mesh returns ``(None, step, history)`` at once.
        ``inject(step)`` may raise ``DeviceLoss`` to simulate failures.
        """
        step, history = 0, []
        if not self.member:
            return None, step, history
        if start_state is None:
            state, step = self._restore_or_init()
        else:
            state = start_state
        it = iter(batches)
        while True:
            if max_steps is not None and step >= max_steps:
                break
            try:
                batch = next(it)
            except StopIteration:
                break
            try:
                if inject is not None:
                    inject(step)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                dt = time.time() - t0
                self.watchdog.observe(step, dt)
                step += 1
                history.append({k: float(v) for k, v in metrics.items()})
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except DeviceLoss as e:
                self.events.append({"event": "device-loss", "step": step,
                                    "lost": e.lost})
                self.shrink()
                if not self.member:
                    self.ckpt.wait()  # a dropped rank queues no write
                    return None, step, history
                self.ckpt.flush(_device_mesh(self.mesh))
                state, step = self._restore_or_init()
        return state, step, history
