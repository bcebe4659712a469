"""Facebook-trace-style workload generation (Section V-A).

Port of ``repro.core.trace``'s samplers and trace parser. The samplers draw
from numpy's PCG64 (``np.random.default_rng``) in exactly the reference's
order, so one seed gives the reference's trace and instance bit for bit: a
torch generator cannot reproduce that stream. The sampled demand (and the
release times of an online instance) then move to the device in one copy.

``synth_fb_trace`` is a calibrated surrogate of the FB-2010 coflow benchmark
(526 coflows from a 150-rack MapReduce cluster; most coflows narrow and small,
the widest ~10% carrying most bytes). ``sample_instance`` applies the paper's
procedure: receiver-level bytes split pseudo-uniformly across the coflow's
senders with a +-20% perturbation, machines mapped onto N ports, M coflows
sampled.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from .coflow import Coflow, Instance, OnlineInstance, instance_from_arrays

__all__ = ["TraceCoflow", "synth_fb_trace", "load_fb_trace", "sample_instance",
           "sample_online_instance", "arrival_stream"]

N_RACKS = 150


@dataclasses.dataclass(frozen=True)
class TraceCoflow:
    cid: int
    arrival_ms: float
    mappers: tuple[int, ...]              # rack ids of senders
    reducers: tuple[int, ...]             # rack ids of receivers
    reducer_mb: tuple[float, ...]         # bytes received per reducer (MB)


def synth_fb_trace(n_coflows: int = 526, seed: int = 2026) -> list[TraceCoflow]:
    """Calibrated surrogate of the FB-2010 coflow benchmark.

    ~60% of coflows are narrow (<= 4x4) with MB-scale reducers, ~30% medium,
    ~10% wide (up to all 150 racks) with GB-scale reducers. Arrival times
    are sorted uniforms over one hour.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0, 3_600_000, n_coflows))
    out: list[TraceCoflow] = []
    for cid in range(n_coflows):
        u = rng.random()
        if u < 0.60:       # narrow & small
            n_map = int(rng.integers(1, 5))
            n_red = int(rng.integers(1, 5))
            scale_mb = rng.lognormal(mean=0.0, sigma=1.2)
        elif u < 0.90:     # medium
            n_map = int(rng.integers(5, 31))
            n_red = int(rng.integers(5, 31))
            scale_mb = rng.lognormal(mean=2.5, sigma=1.2)
        else:              # wide & heavy
            n_map = int(rng.integers(30, N_RACKS + 1))
            n_red = int(rng.integers(30, N_RACKS + 1))
            scale_mb = rng.lognormal(mean=5.5, sigma=1.0)
        mappers = tuple(int(x) for x in rng.choice(N_RACKS, size=n_map, replace=False))
        reducers = tuple(int(x) for x in rng.choice(N_RACKS, size=n_red, replace=False))
        red_mb = tuple(float(scale_mb * rng.lognormal(0.0, 0.75)) for _ in range(n_red))
        out.append(TraceCoflow(cid=cid, arrival_ms=float(arrivals[cid]),
                               mappers=mappers, reducers=reducers,
                               reducer_mb=red_mb))
    return out


def load_fb_trace(path: str) -> list[TraceCoflow]:
    """Parse the real ``FB2010-1Hr-150-0.txt`` benchmark format: an optional
    ``<machines> <coflows>`` header, then per coflow ``cid arrival_ms n_map
    mappers... n_red reducer:mb...``."""
    out: list[TraceCoflow] = []
    with open(path) as fh:
        lines = [ln.split() for ln in fh if ln.strip()]
    if len(lines[0]) == 2:
        lines = lines[1:]
    for toks in lines:
        n_map = int(toks[2])
        mappers = tuple(int(x) for x in toks[3:3 + n_map])
        n_red = int(toks[3 + n_map])
        reducers, red_mb = [], []
        for rt in toks[4 + n_map:4 + n_map + n_red]:
            r, mb = rt.split(":")
            reducers.append(int(r))
            red_mb.append(float(mb))
        out.append(TraceCoflow(cid=int(toks[0]), arrival_ms=float(toks[1]),
                               mappers=mappers, reducers=tuple(reducers),
                               reducer_mb=tuple(red_mb)))
    return out


def sample_instance(
    trace: list[TraceCoflow],
    *,
    N: int,
    M: int,
    rates: Sequence[float],
    delta: float,
    seed: int = 0,
    weight_mode: str = "uniform-int",
    weight_params: tuple[float, float] = (1, 10),
    machine_map: str = "restrict",
    return_pick: bool = False,
    device: str | torch.device | None = None,
) -> Instance | tuple[Instance, np.ndarray]:
    """Build an N-port, M-coflow instance on ``device`` per Section V-A.

    ``machine_map="restrict"``: N of the 150 racks become the ports and only
    traffic between them survives (sparse demands, the regime delta=8
    targets). ``"fold"``: all racks are folded onto the N ports by a random
    grouping. ``weight_mode`` is ``"uniform-int"`` (integers in
    ``weight_params``), ``"unit"`` or ``"normal"`` (mean, sigma; truncated
    at 1e-3). ``return_pick=True`` also returns the picked trace indices
    (int64 numpy, aligned with the coflows), from which
    :func:`sample_online_instance` reads the arrival stamps.
    """
    rng = np.random.default_rng(seed)

    if machine_map == "restrict":
        selected = rng.choice(N_RACKS, size=N, replace=False)
        port_of = {int(r): p for p, r in enumerate(selected)}
    elif machine_map == "fold":
        perm = rng.permutation(N_RACKS) % N
        port_of = {r: int(perm[r]) for r in range(N_RACKS)}
    else:
        raise ValueError(f"unknown machine_map {machine_map!r}")

    def build_demand(tc: TraceCoflow) -> np.ndarray:
        D = np.zeros((N, N))
        n_map = len(tc.mappers)
        for r_rack, mb in zip(tc.reducers, tc.reducer_mb):
            shares = rng.uniform(0.8, 1.2, size=n_map)
            shares = shares / shares.sum() * mb
            for s_rack, share in zip(tc.mappers, shares):
                if s_rack in port_of and r_rack in port_of:
                    D[port_of[s_rack], port_of[r_rack]] += share
        return D

    demands = [build_demand(tc) for tc in trace]
    nonempty = [idx for idx, D in enumerate(demands) if D.any()]
    if not nonempty:
        raise ValueError("no coflow has traffic between the selected machines")
    pick = rng.choice(nonempty, size=M, replace=len(nonempty) < M)

    if weight_mode == "uniform-int":
        lo, hi = weight_params
        weights = rng.integers(int(lo), int(hi) + 1, size=M).astype(np.float64)
    elif weight_mode == "unit":
        weights = np.ones(M)
    elif weight_mode == "normal":
        mu, sigma = weight_params
        weights = np.maximum(rng.normal(mu, sigma, size=M), 1e-3)
    else:
        raise ValueError(f"unknown weight_mode {weight_mode!r}")

    demand = (np.stack([demands[int(t)] for t in pick]) if M
              else np.zeros((0, N, N)))
    inst = instance_from_arrays(demand, weights, np.arange(M), rates, delta,
                                device=device)
    if return_pick:
        return inst, np.asarray(pick, dtype=np.int64)
    return inst


def sample_online_instance(
    trace: list[TraceCoflow],
    *,
    N: int,
    M: int,
    rates: Sequence[float],
    delta: float,
    span: float,
    seed: int = 0,
    device: str | torch.device | None = None,
    **kw: Any,
) -> OnlineInstance:
    """:func:`sample_instance` with release times from the trace's arrival
    stamps, mapped affinely onto ``[0, span]`` (bursts stay bursts). The map
    runs in numpy on the host, as in the reference, and the releases move to
    the device in one copy."""
    if span < 0:
        raise ValueError("span must be >= 0")
    inst, pick = sample_instance(trace, N=N, M=M, rates=rates, delta=delta,
                                 seed=seed, return_pick=True, device=device,
                                 **kw)
    if M == 0:
        return OnlineInstance(inst=inst, releases=np.zeros(0))
    arr = np.array([trace[int(t)].arrival_ms for t in pick])
    lo, hi = float(arr.min()), float(arr.max())
    rel = (np.zeros(M) if span == 0 or hi == lo
           else (arr - lo) / (hi - lo) * span)
    return OnlineInstance(inst=inst, releases=rel)


def arrival_stream(oinst: OnlineInstance) -> Iterator[tuple[Coflow, float]]:
    """Yield ``(coflow, release)`` in arrival order (stable by release): the
    event stream a fabric manager's admission queue sees
    (``service.FabricManager.submit`` takes exactly these pairs). Each
    coflow's demand is a view of the instance's demand, on its device."""
    inst = oinst.inst
    rel = oinst.releases.cpu().numpy()
    cids = inst.cids.cpu().tolist()
    weights = inst.weights.cpu().tolist()
    for m in np.argsort(rel, kind="stable").tolist():
        yield (Coflow(cid=cids[m], demand=inst.demand[m], weight=weights[m]),
               float(rel[m]))
