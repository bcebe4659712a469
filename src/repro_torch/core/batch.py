"""The sweep API: a whole parameter grid through the engine.

Port of ``repro.core.batch``. ``run_batch`` maps instances x algorithms x
scheduling policies (x seeds) to one ``SweepRow`` of metrics each, in grid
order. An instance may be an ``OnlineInstance`` (or ``releases=`` may give
its release times), and then its points run the online engine.

``workers > 1`` runs the points in a pool of worker processes started by
``spawn`` (a forked child of a process that holds a CUDA context cannot
use it). Only host data crosses to a worker: each point's instance as numpy
arrays and the name of its device, where the worker rebuilds it. Each
worker returns its row with the assignment kernels' launches it made, and
the parent adds those to ``kernels.coflow_assign``'s counters.
``check="oracle"`` holds every point to the reference's oracles through
``engine.cross_check`` / ``cross_check_online``, as the reference does.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing as mp
import time
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

from .coflow import Instance, OnlineInstance, instance_from_arrays
from .engine import (BACKENDS, cross_check, cross_check_online, run_fast,
                     run_fast_metrics, run_fast_online)
from .scheduler import ALGORITHMS, tail_quantile, weighted_sum
from .simulator import validate

__all__ = ["SweepRow", "ResultTable", "run_batch", "row_from_ccts"]

_SUNFLOW_ALGS = ("sunflow-core", "rand-sunflow")


@dataclasses.dataclass(frozen=True)
class SweepRow:
    """Metrics of one (instance, algorithm, scheduling, seed) grid point."""

    instance: int          # index into the `instances` argument
    algorithm: str
    scheduling: str        # "sunflow" for the sunflow baselines
    seed: int
    weighted_cct: float
    total_cct: float
    p95: float
    p99: float
    makespan: float
    n_flows: int
    wall_s: float          # host wall time of the run, ending in a sync

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ResultTable:
    """A list of ``SweepRow``s with pandas-free slicing helpers."""

    def __init__(self, rows: Sequence[SweepRow]) -> None:
        self.rows = list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[SweepRow]:
        return iter(self.rows)

    def filter(self, **where: Any) -> "ResultTable":
        """Rows matching all given column=value constraints."""
        return ResultTable([
            r for r in self.rows
            if all(getattr(r, k) == v for k, v in where.items())])

    def column(self, name: str, **where: Any) -> np.ndarray:
        """Column values of the rows matching ``where``; raises
        ``ValueError`` when the filter matches no rows."""
        rows = self.filter(**where).rows
        if not rows:
            raise ValueError(
                f"no rows match filter {where!r} (table has {len(self.rows)} rows)")
        return np.array([getattr(r, name) for r in rows])

    def mean(self, name: str, **where: Any) -> float:
        return float(self.column(name, **where).mean())

    def to_dicts(self) -> list[dict]:
        return [r.as_dict() for r in self.rows]

    def __repr__(self) -> str:
        return f"ResultTable({len(self.rows)} rows)"


def row_from_ccts(idx: int, alg: str, sched: str, seed: int,
                  weights: torch.Tensor, ccts: torch.Tensor, n_flows: int,
                  wall: float) -> SweepRow:
    """``SweepRow`` straight from per-coflow CCTs; an empty instance (M == 0)
    gives an all-zero row. Sums and tails are numpy's, on one host copy of
    the CCTs, so they equal the reference's bit for bit."""
    ccts_h = ccts.detach().cpu().numpy()
    return SweepRow(
        instance=idx,
        algorithm=alg,
        scheduling=sched,
        seed=seed,
        weighted_cct=weighted_sum(weights, ccts_h),
        total_cct=float(ccts_h.sum()),
        p95=tail_quantile(ccts_h, 0.95),
        p99=tail_quantile(ccts_h, 0.99),
        makespan=float(ccts_h.max()) if ccts_h.size else 0.0,
        n_flows=n_flows,
        wall_s=wall,
    )


def _synced_wall(dev: torch.device, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _run_one(idx: int, inst: Instance, rel: torch.Tensor | None, alg: str,
             sched: str, seed: int, check: str, backend: str,
             materialize: str) -> SweepRow:
    """One grid point -> ``SweepRow``."""
    if materialize == "metrics":
        t0 = time.perf_counter()
        ccts, n_flows = run_fast_metrics(inst, alg, seed=seed,
                                         scheduling=sched, backend=backend,
                                         releases=rel)
        wall = _synced_wall(inst.device, t0)
        return row_from_ccts(idx, alg, sched, seed, inst.weights, ccts,
                             n_flows, wall)
    t0 = time.perf_counter()
    if rel is None:
        s = run_fast(inst, alg, seed=seed, scheduling=sched, backend=backend)
    else:
        oinst = OnlineInstance(inst=inst, releases=rel)
        s = run_fast_online(oinst, alg, seed=seed, scheduling=sched,
                            backend=backend)
    wall = _synced_wall(inst.device, t0)
    if check == "oracle":
        if rel is None:
            cross_check(inst, alg, seed=seed, scheduling=sched, fast=s,
                        backend=backend)
        else:
            cross_check_online(oinst, alg, seed=seed, scheduling=sched,
                               fast=s, backend=backend)
    elif check == "validate":
        validate(s, releases=rel)
    return row_from_ccts(idx, alg, sched, seed, inst.weights, s.ccts,
                         s.n_flows, wall)


def _host_point(idx: int, inst: Instance, rel: torch.Tensor | None,
                *rest) -> tuple:
    """A grid point with its instance as host arrays and its device name:
    what a worker process is sent."""
    host = tuple(t.detach().cpu().numpy()
                 for t in (inst.demand, inst.weights, inst.cids, inst.rates))
    return (idx, host, inst.delta, str(inst.device),
            None if rel is None else rel.detach().cpu().numpy(), *rest)


def _init_worker() -> None:
    # one thread each: the pool is the parallelism
    torch.set_num_threads(1)


def _run_point(point: tuple) -> tuple[SweepRow, dict[str, int]]:
    """A worker's grid point: the instance rebuilt on its device, the row,
    and the assignment kernels' launches of this point by kernel."""
    from ..kernels import coflow_assign as ca

    idx, host, delta, device, rel, *rest = point
    inst = instance_from_arrays(*host, delta, device=device)
    rel_t = None if rel is None else torch.as_tensor(
        rel, dtype=torch.float64, device=inst.device)
    before = dict(ca.launches_by_kernel)
    row = _run_one(idx, inst, rel_t, *rest)
    return row, {k: n - before.get(k, 0)
                 for k, n in ca.launches_by_kernel.items()}


def _run_pool(grid: list[tuple], workers: int) -> list[SweepRow]:
    """The points through a spawn pool, rows in grid order; the workers'
    kernel launches are added to this process's counters."""
    from ..kernels import coflow_assign as ca

    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                                initializer=_init_worker) as ex:
        out = list(ex.map(_run_point, [_host_point(*p) for p in grid],
                          chunksize=max(1, len(grid) // (4 * workers))))
    for _, launches in out:
        for name, n in launches.items():
            ca.launches += n
            ca.launches_by_kernel[name] += n
    return [row for row, _ in out]


def run_batch(
    instances: Sequence[Instance | OnlineInstance],
    algorithms: Iterable[str] = ALGORITHMS,
    *,
    seeds: Sequence[int] = (0,),
    schedulings: Iterable[str] = ("work-conserving",),
    pair_seeds: bool = False,
    check: str = "validate",
    workers: int | None = None,
    releases: Sequence[torch.Tensor | np.ndarray | None] | None = None,
    backend: str = "numpy",
    materialize: str = "full",
) -> ResultTable:
    """Run a whole sweep grid through the engine; rows in grid order.

    ``instances x algorithms x schedulings x seeds`` is the grid; with
    ``pair_seeds=True``, ``seeds`` aligns with ``instances`` and seed
    ``seeds[i]`` serves instance ``i`` only. The sunflow baselines ignore
    ``schedulings`` and run once per (instance, seed) with scheduling
    ``"sunflow"``.

    Online points: an entry of ``instances`` may be an ``OnlineInstance``,
    and ``releases`` may give a per-instance release vector (aligned with
    ``instances``; a ``None`` entry keeps the instance's own, a non-``None``
    one overrides an ``OnlineInstance``'s). Those points run
    :func:`engine.run_fast_online`.

    ``check``: ``"validate"`` (default) runs the referee on every schedule
    (release-respecting for online points), ``"oracle"`` also holds it to
    the reference's oracles (``engine.cross_check`` /
    ``cross_check_online``, given the point's schedule, so a kernel point
    launches the kernel once), ``"none"`` skips both. ``backend`` is the assignment backend of
    every point (:data:`engine.BACKENDS`). ``materialize="metrics"`` stops
    each point at its CCTs, with no ``Schedule``, and requires
    ``check="none"``.

    ``workers``: 0, 1 or ``None`` runs the points serially, in this
    process; ``workers > 1`` runs them in a pool of that many spawned
    processes (see the module docstring). Rows come back in grid order
    either way, and equal, but for ``wall_s``. ``None`` stays serial, where
    the reference picks a pool for grids of four points or more: every
    worker imports torch and, on the card, makes its own CUDA context,
    seconds of start-up that a small grid does not repay. That is a
    difference in speed only.
    """
    algorithms = tuple(algorithms)
    schedulings = tuple(schedulings)
    seeds = tuple(seeds)
    unknown = set(algorithms) - set(ALGORITHMS)
    if unknown:
        raise ValueError(f"unknown algorithms {sorted(unknown)}")
    if check not in ("none", "validate", "oracle"):
        raise ValueError(f"unknown check {check!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if materialize not in ("full", "metrics"):
        raise ValueError(f"unknown materialize {materialize!r}")
    if materialize == "metrics" and check != "none":
        raise ValueError(
            'materialize="metrics" skips schedule objects, so it requires '
            f'check="none" (got check={check!r})')
    if pair_seeds and len(seeds) != len(instances):
        raise ValueError(
            f"pair_seeds=True needs len(seeds) == len(instances), "
            f"got {len(seeds)} vs {len(instances)}")
    if releases is not None and len(releases) != len(instances):
        raise ValueError(
            f"releases must align with instances: "
            f"got {len(releases)} vs {len(instances)}")

    grid = []
    for idx, inst in enumerate(instances):
        rel = None
        if isinstance(inst, OnlineInstance):
            inst, rel = inst.inst, inst.releases
        if releases is not None and releases[idx] is not None:
            rel = torch.as_tensor(releases[idx], dtype=torch.float64,
                                  device=inst.device)
        for seed in ((seeds[idx],) if pair_seeds else seeds):
            for alg in algorithms:
                scheds = ("sunflow",) if alg in _SUNFLOW_ALGS else schedulings
                for sched in scheds:
                    grid.append((idx, inst, rel, alg, sched, seed, check,
                                 backend, materialize))
    if workers and workers > 1 and len(grid) > 1:
        return ResultTable(_run_pool(grid, workers))
    return ResultTable([_run_one(*p) for p in grid])
