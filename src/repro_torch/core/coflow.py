"""Coflow demand matrices, port loads and instances, as device tensors.

Port of ``repro.core.coflow`` in the paper's Section III notation:
  - ``D_m``   : N x N demand matrix of coflow ``C_m``;
  - ``rho_m`` : max row or column sum of ``D_m``;
  - ``tau_m`` : max number of nonzero entries in any row or column of ``D_m``.

An :class:`Instance` keeps the demand of all M coflows stacked in one
``(M, N, N)`` float64 tensor on its device. Row and column sums are taken in
numpy's order (pairwise along a row, left to right down a column), so rho,
the WSPT scores and the order pi built from them are bit-identical to the
reference's.

The reference's oracle path (``scheduler.run``, ``online.run_online``, the
theory certificates) works on per-coflow host matrices and per-flow
:class:`Flow` records: :meth:`Instance.host_demand` gives coflow m's matrix
as the reference's ``inst.coflows[m].demand`` (one host copy of the stack,
made on first use), and :func:`nonzero_flows` lists a coflow's flows in the
reference's order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "Coflow",
    "Flow",
    "Instance",
    "OnlineInstance",
    "instance_from_arrays",
    "instance_from_coflows",
    "online_instance_from_arrays",
    "row_loads",
    "col_loads",
    "rho",
    "tau",
    "nonzero_flows",
    "extract_flows",
]


@dataclasses.dataclass(frozen=True)
class Coflow:
    """One coflow: an ``(N, N)`` float64 demand tensor plus a positive weight.

    The unit of the streaming plane (``fabric.FabricState``,
    ``service.FabricManager``), as in the reference. An array-like demand
    becomes a float64 tensor (on the CPU for a numpy array; a tensor keeps
    its device).
    """

    cid: int
    demand: torch.Tensor  # (N, N) float64, >= 0
    weight: float = 1.0

    def __post_init__(self) -> None:
        d = torch.as_tensor(self.demand, dtype=torch.float64)
        if d.ndim != 2 or d.shape[0] != d.shape[1]:
            raise ValueError(f"demand must be square, got {tuple(d.shape)}")
        if bool((d < 0).any()):
            raise ValueError("demand entries must be non-negative")
        if self.weight <= 0:
            raise ValueError("weight must be positive")
        object.__setattr__(self, "demand", d)

    @property
    def n_ports(self) -> int:
        return int(self.demand.shape[0])

    @property
    def tau(self) -> int:
        return tau(self.demand)

    @property
    def num_flows(self) -> int:
        return int((self.demand > 0).sum())


@dataclasses.dataclass(frozen=True)
class Flow:
    """One (sub)flow record of the oracle path's assignment and scheduling
    phases, in host scalars as the reference's."""

    coflow: int  # position in the global order pi (0-based)
    cid: int     # original coflow id
    i: int       # ingress port
    j: int       # egress port
    size: float  # bytes


@dataclasses.dataclass(frozen=True)
class Instance:
    """A scheduling problem: M coflows over a K-core OCS network.

    ``rates[k]`` is the per-port transmission rate of core ``k`` and
    ``delta`` the (not-all-stop) reconfiguration delay. ``cids[m]`` is the
    original id of coflow ``m`` (instances built from a subset keep theirs).
    """

    demand: torch.Tensor   # (M, N, N) float64, >= 0
    weights: torch.Tensor  # (M,) float64, > 0
    cids: torch.Tensor     # (M,) int64
    rates: torch.Tensor    # (K,) float64, > 0
    delta: float

    def __post_init__(self) -> None:
        d, w, c, r = self.demand, self.weights, self.cids, self.rates
        if d.dtype != torch.float64 or d.ndim != 3 or d.shape[1] != d.shape[2]:
            raise ValueError(
                f"demand must be a float64 (M, N, N) tensor, got "
                f"{d.dtype} {tuple(d.shape)}")
        m = d.shape[0]
        if w.dtype != torch.float64 or tuple(w.shape) != (m,):
            raise ValueError(f"weights must be float64 of shape ({m},)")
        if c.dtype != torch.int64 or tuple(c.shape) != (m,):
            raise ValueError(f"cids must be int64 of shape ({m},)")
        if r.dtype != torch.float64 or r.ndim != 1 or bool((r <= 0).any()):
            raise ValueError("rates must be a 1-D positive float64 vector")
        if len({t.device for t in (d, w, c, r)}) != 1:
            raise ValueError("demand, weights, cids and rates must share a device")
        if bool((d < 0).any()):
            raise ValueError("demand entries must be non-negative")
        if bool((w <= 0).any()):
            raise ValueError("weights must be positive")
        if self.delta < 0:
            raise ValueError("delta must be >= 0")

    @property
    def device(self) -> torch.device:
        return self.demand.device

    @property
    def M(self) -> int:
        return int(self.demand.shape[0])

    @property
    def K(self) -> int:
        return int(self.rates.shape[0])

    @property
    def N(self) -> int:
        return int(self.demand.shape[1])

    @property
    def R(self) -> float:
        """Aggregate per-port rate across cores (numpy's summation order)."""
        return float(self.rates.cpu().numpy().sum())

    @property
    def r_max(self) -> float:
        return float(self.rates.max())

    @property
    def tau_max(self) -> int:
        """The largest tau of any coflow (0 without coflows)."""
        if self.M == 0 or self.N == 0:
            return 0
        nz = self.demand > 0
        return int(torch.maximum(nz.sum(dim=2).amax(), nz.sum(dim=1).amax()))

    @property
    def psi(self) -> int:
        """psi = max{K, tau_max} from Theorem 1."""
        return max(self.K, self.tau_max)

    @functools.cached_property
    def _host_stack(self) -> np.ndarray:
        d = self.demand.detach().cpu().numpy().copy()
        d.setflags(write=False)
        return d

    def host_demand(self, m: int) -> np.ndarray:
        """Coflow ``m``'s ``(N, N)`` float64 demand on the host, read-only:
        the reference's ``inst.coflows[m].demand``. The whole stack crosses
        to the host once, on the first call, and is kept."""
        return self._host_stack[m]


@dataclasses.dataclass(frozen=True)
class OnlineInstance:
    """An :class:`Instance` plus per-coflow release (arrival) times.

    ``releases[m]`` is the time coflow ``m`` (original id order) becomes
    known; nothing of it may be assigned or scheduled earlier. It is kept as
    an ``(M,)`` float64 tensor on the instance's device (array-likes are
    converted).
    """

    inst: Instance
    releases: torch.Tensor  # (M,) float64, >= 0

    def __post_init__(self) -> None:
        r = torch.as_tensor(self.releases, dtype=torch.float64,
                            device=self.inst.device)
        if tuple(r.shape) != (self.inst.M,):
            raise ValueError(
                f"releases must have shape ({self.inst.M},), got "
                f"{tuple(r.shape)}")
        if bool((r < 0).any()):
            raise ValueError("release times must be >= 0")
        object.__setattr__(self, "releases", r)


def instance_from_arrays(
    demand: np.ndarray,   # (M, N, N)
    weights: np.ndarray,  # (M,)
    cids: np.ndarray,     # (M,)
    rates: np.ndarray,    # (K,)
    delta: float,
    *,
    device: str | torch.device | None = None,
) -> Instance:
    """Build an :class:`Instance` on ``device`` from host arrays.

    This is how an instance crosses from numpy (a trace sampler, or the
    arrays of a reference instance in a test) onto the device.
    """
    dev = resolve_device(device)

    def put(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)

    return Instance(demand=put(demand, torch.float64),
                    weights=put(weights, torch.float64),
                    cids=put(cids, torch.int64),
                    rates=put(rates, torch.float64),
                    delta=float(delta))


def instance_from_coflows(
    coflows: Sequence[Coflow],
    rates: torch.Tensor | np.ndarray,
    delta: float,
    *,
    n_ports: int | None = None,
    device: str | torch.device | None = None,
) -> Instance:
    """Build an :class:`Instance` on ``device`` from a sequence of
    :class:`Coflow` records (the streaming plane's batches and replays).

    Coflow ``m`` of the sequence is row ``m``: its demand, weight and cid.
    ``n_ports`` gives N when the sequence is empty.
    """
    dev = resolve_device(device)
    coflows = tuple(coflows)
    ns = {c.n_ports for c in coflows}
    if len(ns) > 1:
        raise ValueError(f"all coflows must share N, got {ns}")
    N = ns.pop() if ns else int(n_ports or 0)
    demand = (torch.stack([c.demand.to(dev) for c in coflows]) if coflows
              else torch.zeros((0, N, N), dtype=torch.float64, device=dev))
    return Instance(
        demand=demand,
        weights=torch.tensor([float(c.weight) for c in coflows],
                             dtype=torch.float64, device=dev),
        cids=torch.tensor([int(c.cid) for c in coflows], dtype=torch.int64,
                          device=dev),
        rates=torch.as_tensor(rates, dtype=torch.float64).to(dev),
        delta=float(delta))


def online_instance_from_arrays(
    demand: np.ndarray,    # (M, N, N)
    weights: np.ndarray,   # (M,)
    cids: np.ndarray,      # (M,)
    rates: np.ndarray,     # (K,)
    delta: float,
    releases: np.ndarray,  # (M,)
    *,
    device: str | torch.device | None = None,
) -> OnlineInstance:
    """Build an :class:`OnlineInstance` on ``device`` from host arrays."""
    inst = instance_from_arrays(demand, weights, cids, rates, delta,
                                device=device)
    return OnlineInstance(inst=inst, releases=np.asarray(releases,
                                                         dtype=np.float64))


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of numpy's ``pairwise_sum``.

    numpy reduces a contiguous run of n floats by: a plain left-to-right sum
    below 8 elements; eight interleaved accumulators combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))`` plus a left-to-right tail up to
    128; and above that by halves split at a multiple of 8. Following it
    step for step (vectorized over the leading axes) gives the same floats.
    """
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        body = n - n % 8
        r = x[..., :8]
        for i in range(8, body, 8):
            r = r + x[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
            + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(body, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(x[..., :n2]) + _pairwise_sum(x[..., n2:])


def row_loads(D: torch.Tensor) -> torch.Tensor:
    """d_{m,i} = sum_j d_m(i, j) for every ingress port i; ``D`` is
    ``(..., N, N)`` and the result ``(..., N)``."""
    return _pairwise_sum(D)


def col_loads(D: torch.Tensor) -> torch.Tensor:
    """d_{m,j} = sum_i d_m(i, j) for every egress port j, summed down the
    column left to right as numpy reduces a non-contiguous axis."""
    res = D[..., 0, :]
    for i in range(1, D.shape[-2]):
        res = res + D[..., i, :]
    return res


def rho(D: torch.Tensor) -> float:
    """Maximum port load of one ``(N, N)`` demand: max row or column sum."""
    if D.numel() == 0:
        return 0.0
    return float(torch.maximum(row_loads(D).max(), col_loads(D).max()))


def tau(D: torch.Tensor) -> int:
    """Max number of nonzero entries in any row or column of ``(N, N)`` D."""
    nz = D > 0
    if nz.numel() == 0:
        return 0
    return int(torch.maximum(nz.sum(dim=1).max(), nz.sum(dim=0).max()))


def _flows_of(d: np.ndarray, cid: int, order_pos: int,
              largest_first: bool = True) -> list[Flow]:
    """The nonzero flows of one host demand matrix, sorted by size
    (non-increasing by default) with an ``(i, j)`` tie-break."""
    ii, jj = np.nonzero(d)
    sizes = d[ii, jj]
    if largest_first:
        key = np.lexsort((jj, ii, -sizes))
    else:
        key = np.lexsort((jj, ii, sizes))
    return [
        Flow(coflow=order_pos, cid=cid, i=int(ii[t]), j=int(jj[t]),
             size=float(sizes[t]))
        for t in key
    ]


def nonzero_flows(c: Coflow, order_pos: int, *,
                  largest_first: bool = True) -> list[Flow]:
    """Nonzero flows of a coflow as :class:`Flow` records, sorted by size
    (non-increasing by default), ties broken by ``(i, j)``: the reference's
    order. Read from one host copy of the demand."""
    return _flows_of(c.demand.detach().cpu().numpy(), c.cid, order_pos,
                     largest_first)


def extract_flows(
    inst: Instance, pi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All nonzero flows of an instance as flat tensors, in global pi order.

    ``pi`` is a permutation of the coflows. Flows are grouped by position in
    pi; within a coflow, sizes are non-increasing with ties broken by
    ``(i, j)``: the reference's ``lexsort((jj, ii, -sizes, pos))``.
    ``torch.nonzero`` lists flows in ``(m, i, j)`` order, so two stable sorts
    (by ``-size``, then by position) give that order without gathering the
    demand into pi order first.

    Returns ``(pos, cid, fi, fj, size)``, each of shape ``(F,)`` on the
    instance's device: position in pi, original coflow id, ingress and
    egress port (int64), and size (float64).
    """
    dev = inst.device
    pi = torch.as_tensor(pi, dtype=torch.int64, device=dev)
    if inst.M == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e.clone(), e.clone(), e.clone(), torch.zeros(
            0, dtype=torch.float64, device=dev)
    pos_of = torch.empty_like(pi)
    pos_of[pi] = torch.arange(inst.M, device=dev)
    m, ii, jj = torch.nonzero(inst.demand, as_tuple=True)
    sizes = inst.demand[m, ii, jj]
    order = torch.argsort(-sizes, stable=True)
    order = order[torch.argsort(pos_of[m[order]], stable=True)]
    m = m[order]
    return pos_of[m], inst.cids[m], ii[order], jj[order], sizes[order]
