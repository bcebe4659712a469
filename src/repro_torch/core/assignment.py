"""The fp64 cross-core assignment backend (Alg. 1 lines 5-17) and its
ablated variants, over flat flow tensors.

Port of ``repro.core.assignment``'s flat front-end: ``FlatAssignState`` and
``assign_fast`` for the three policies of the paper's ablation,

  - ``tau-aware`` (the paper's rule): each flow, in global order, goes to the
    core minimising the tau-aware per-core prefix lower bound;
  - ``rho-only`` (RHO-ASSIGN): the tau-blind bound ``rho^k / r^k``;
  - ``random`` (RAND-ASSIGN): core k with probability ``r^k / R``.

This is host code over Python floats, op for op in the reference's order: the
chain of choices is sequential and every candidate is a handful of scalar
operations, so the loop reads the flows once into Python lists and keeps the
per-core state in lists (K is single digits). Its choices are bit-identical
to the reference's fp64 backend. The random policy draws from numpy's PCG64
(``np.random.default_rng``) with the reference's probability vector, so one
seed draws the same cores: a torch generator cannot reproduce that stream.

Flow tensors may live on any device; choices come back as int64 on the
device of the flows.

The reference's dataclass oracles are here too: ``assign_tau_aware``,
``assign_rho_only`` and ``assign_random`` build an :class:`Assignment` of
per-flow :class:`AssignedFlow` records through ``lower_bounds.CoreState``,
one flow at a time, as the reference's do; ``assignment_from_choices``
builds one from flat choices. They are the second, deliberately simple
implementation that ``engine.cross_check`` holds the flat backends to, and
the input of the theory certificates. Their state is host numpy; the
assignment's ``pi`` stays on the instance's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coflow import Flow, Instance, _flows_of, extract_flows
from .effects import effects
from .lower_bounds import CoreState

__all__ = ["AssignedFlow", "Assignment", "assign_tau_aware",
           "assign_rho_only", "assign_random", "ASSIGN_POLICIES",
           "FlatAssignState", "assign_fast", "assignment_from_choices"]

ASSIGN_POLICIES = ("tau-aware", "rho-only", "random")


def _host_f64(x: torch.Tensor | np.ndarray) -> np.ndarray:
    """A host float64 array of a tensor (any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class AssignedFlow:
    flow: Flow
    core: int


@dataclasses.dataclass
class Assignment:
    """The assignment phase's result for a whole instance: per coflow
    position m in ``pi`` (an ``(M,)`` int64 tensor on the instance's
    device), the coflow's :class:`AssignedFlow` records, and the final
    prefix state."""

    inst: Instance
    pi: torch.Tensor
    flows: list[list[AssignedFlow]]     # indexed by position m in pi
    state: CoreState
    # D^k_{1:_cum_upto+1}, extended by forward prefix_per_core queries
    _cum: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _cum_upto: int = dataclasses.field(
        default=-1, init=False, repr=False, compare=False)

    def per_core_demand(self, m_pos: int) -> torch.Tensor:
        """D^k_{pi(m)} for every core: ``(K, N, N)`` on the instance's
        device."""
        out = np.zeros((self.inst.K, self.inst.N, self.inst.N))
        for af in self.flows[m_pos]:
            out[af.core, af.flow.i, af.flow.j] += af.flow.size
        return torch.from_numpy(out).to(self.inst.device)

    def prefix_per_core(self, m_pos: int) -> torch.Tensor:
        """D^k_{1:m} (inclusive) for every core: ``(K, N, N)`` on the
        instance's device, a copy the caller may mutate.

        The running sum is cached, so a forward scan over all prefixes adds
        each flow once; a backward query rebuilds forward from zero, so every
        result equals a from-scratch sum bit for bit.
        """
        if self._cum is None or self._cum_upto > m_pos:
            self._cum = np.zeros((self.inst.K, self.inst.N, self.inst.N))
            self._cum_upto = -1
        while self._cum_upto < m_pos:
            self._cum_upto += 1
            for af in self.flows[self._cum_upto]:
                self._cum[af.core, af.flow.i, af.flow.j] += af.flow.size
        return torch.from_numpy(self._cum.copy()).to(self.inst.device)

    def all_flows(self) -> list[AssignedFlow]:
        return [af for per_coflow in self.flows for af in per_coflow]


def _iter_coflow_flows(inst: Instance, pi: list[int]) -> list[list[Flow]]:
    """Per position of ``pi``, its coflow's flows, largest first."""
    cids = inst.cids.tolist()
    return [_flows_of(inst.host_demand(ci), cids[ci], pos)
            for pos, ci in enumerate(pi)]


def _oracle(inst: Instance, pi: torch.Tensor, pick) -> Assignment:
    """Assign every flow, in pi order, to ``pick(state, flow)``."""
    pi = torch.as_tensor(pi, dtype=torch.int64, device=inst.device)
    state = CoreState(K=inst.K, N=inst.N, rates=inst.rates, delta=inst.delta)
    out: list[list[AssignedFlow]] = []
    for flows in _iter_coflow_flows(inst, pi.tolist()):
        placed: list[AssignedFlow] = []
        for f in flows:
            k = pick(state, f)
            state.assign(f.i, f.j, f.size, k)
            placed.append(AssignedFlow(flow=f, core=k))
        out.append(placed)
    return Assignment(inst=inst, pi=pi, flows=out, state=state)


def assign_tau_aware(inst: Instance, pi: torch.Tensor) -> Assignment:
    """The paper's greedy tau-aware assignment (Alg. 1, lines 5-17); argmin
    ties go to the lowest core."""
    return _oracle(inst, pi, lambda st, f: int(np.argmin(
        st.candidate_bounds(f.i, f.j, f.size))))


def assign_rho_only(inst: Instance, pi: torch.Tensor) -> Assignment:
    """RHO-ASSIGN: tau-blind, minimise rho^k_{1:m} / r^k after placement."""
    return _oracle(inst, pi, lambda st, f: int(np.argmin(
        st.candidate_rho_bounds(f.i, f.j, f.size))))


def assign_random(inst: Instance, pi: torch.Tensor, *,
                  seed: int = 0) -> Assignment:
    """RAND-ASSIGN: core k with probability ``r^k / R``, one PCG64 draw per
    flow (``np.random.default_rng(seed)``), as the reference."""
    rng = np.random.default_rng(seed)
    probs = _host_f64(inst.rates) / inst.R
    return _oracle(inst, pi, lambda st, f: int(rng.choice(inst.K, p=probs)))


class FlatAssignState:
    """Persistent flat assignment-phase state (chunked == one-shot).

    A stream of flow chunks fed through :meth:`assign` gives choices
    bit-identical to one call over the concatenated flows: the tau-aware and
    rho-only loops are sequential, and ``Generator.choice(size=n)`` with a
    probability vector consumes exactly ``n`` doubles of the PCG64 stream.

    ``locality`` (tau-aware only; 0.0 = off) is a batch-scoped core-affinity
    bias: within one :meth:`assign` call, once a flow has been placed, a core
    the call has not used yet pays ``locality * delta`` extra in the argmin
    comparison only, never in the state update. With ``locality > 0`` chunk
    boundaries are semantic (they delimit the affinity scope). The penalty is
    priced at the nominal delta and does not follow :meth:`set_delta`.
    """

    def __init__(self, policy: str, rates: torch.Tensor | np.ndarray,
                 delta: float, n_ports: int, *, seed: int = 0,
                 locality: float = 0.0) -> None:
        if policy not in ASSIGN_POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; one of {ASSIGN_POLICIES}")
        if locality < 0:
            raise ValueError(f"locality must be >= 0, got {locality}")
        rates = _host_f64(rates)
        self.policy = policy
        self.rates = rates
        self.delta = float(delta)
        self.n_ports = int(n_ports)
        self.n_assigned = 0
        self.locality = float(locality)
        self._lam = self.locality * self.delta
        K = rates.shape[0]
        # Per-core reconfiguration delay (DeltaDrift); the undrifted loops
        # read the scalar.
        self._delta_c = [self.delta] * K
        self._drifted = False
        if policy == "tau-aware":
            # per core: (row_load, col_load, row_tau, col_tau, nz bitmap, rate)
            self._cores = [
                ([0.0] * n_ports, [0.0] * n_ports, [0] * n_ports,
                 [0] * n_ports, bytearray(n_ports * n_ports), float(rates[k]))
                for k in range(K)
            ]
            self._bound = [0.0] * K
        elif policy == "rho-only":
            self._cores = [([0.0] * n_ports, [0.0] * n_ports, float(rates[k]))
                           for k in range(K)]
            self._rho = [0.0] * K  # running max port load per core
        else:  # random
            self._rng = np.random.default_rng(seed)
            self._p = rates / rates.sum()

    def set_delta(self, core: int, delta: float) -> None:
        """Core ``core`` prices reconfigurations at ``delta`` from now on
        (fault model ``DeltaDrift``). Only the tau-aware policy reads delta."""
        if delta < 0:
            raise ValueError("drifted delta must be >= 0")
        self._delta_c[int(core)] = float(delta)
        self._drifted = any(d != self.delta for d in self._delta_c)

    def reset_core(self, core: int) -> None:
        """Forget core ``core``'s accumulated load (fault model ``CoreUp``).

        Its drifted delay is hardware state, not load, and is kept; the
        random policy is load-blind and has nothing to reset.
        """
        k = int(core)
        if not 0 <= k < self.rates.shape[0]:
            raise ValueError(
                f"core {k} out of range for K={self.rates.shape[0]}")
        n_ports = self.n_ports
        if self.policy == "tau-aware":
            self._cores[k] = (
                [0.0] * n_ports, [0.0] * n_ports, [0] * n_ports,
                [0] * n_ports, bytearray(n_ports * n_ports),
                float(self.rates[k]))
            self._bound[k] = 0.0
        elif self.policy == "rho-only":
            self._cores[k] = ([0.0] * n_ports, [0.0] * n_ports,
                              float(self.rates[k]))
            self._rho[k] = 0.0

    @effects("rng-consume")
    def assign(self, fi: torch.Tensor, fj: torch.Tensor, sizes: torch.Tensor,
               *, up: torch.Tensor | np.ndarray | None = None) -> torch.Tensor:
        """Assign one chunk of flows (in global arrival order), mutating the
        persistent state; returns the ``(len(fi),)`` int64 core choices on
        ``fi``'s device.

        ``up`` (a ``(K,)`` bool mask; fault model) restricts choices to the
        up cores, bit-identical to a fresh state built over just those cores.
        """
        n = int(fi.shape[0])
        self.n_assigned += n
        if up is not None:
            if isinstance(up, torch.Tensor):
                up = up.cpu().numpy()
            up = np.asarray(up, dtype=bool)
            if up.shape != (self.rates.shape[0],):
                raise ValueError(
                    f"up mask must have shape ({self.rates.shape[0]},)")
            if not up.any():
                raise ValueError("cannot assign flows: no core is up")
            if up.all():
                up = None
        if self.policy == "random":
            choices = self._assign_random(n, up)
        else:
            args = (fi.tolist(), fj.tolist(), sizes.tolist())
            if self.policy == "tau-aware":
                if up is None and not self._drifted:
                    if self._lam:
                        choices = self._assign_tau_aware_local(*args)
                    else:
                        choices = self._assign_tau_aware(*args)
                else:
                    up_idx = (list(range(self.rates.shape[0])) if up is None
                              else np.nonzero(up)[0].tolist())
                    choices = self._assign_tau_aware_sub(*args, up_idx)
            elif up is None:
                choices = self._assign_rho_only(*args)
            else:
                choices = self._assign_rho_only_sub(
                    *args, np.nonzero(up)[0].tolist())
        return torch.from_numpy(choices).to(fi.device)

    def _assign_random(self, n: int, up: np.ndarray | None) -> np.ndarray:
        K = self.rates.shape[0]
        if up is None:
            return self._rng.choice(K, size=n, p=self._p).astype(np.int64)
        up_arr = np.nonzero(up)[0]
        p = self.rates[up_arr] / self.rates[up_arr].sum()
        ch = self._rng.choice(up_arr.size, size=n, p=p)
        return up_arr[ch].astype(np.int64)

    def _assign_tau_aware(self, fi: list, fj: list, sizes: list) -> np.ndarray:
        """Greedy tau-aware choices: per core,
        ``li = (row_load + d)/r + (row_tau + new)*delta``, ``lj`` likewise,
        candidate ``max(bound, li, lj)``; strict ``<`` sends ties to the
        lowest core."""
        cores, bound, delta = self._cores, self._bound, self.delta
        n_ports = self.n_ports
        choices = np.empty(len(fi), dtype=np.int64)
        inf = float("inf")
        t = 0
        for i, j, d in zip(fi, fj, sizes):
            ij = i * n_ports + j
            best = inf
            kb = 0
            k = 0
            for rl, cl, rt, ct, nzk, rk in cores:
                new = 0 if nzk[ij] else 1
                li = (rl[i] + d) / rk + (rt[i] + new) * delta
                lj = (cl[j] + d) / rk + (ct[j] + new) * delta
                b = bound[k]
                if li > b:
                    b = li
                if lj > b:
                    b = lj
                if b < best:
                    best = b
                    kb = k
                k += 1
            rl, cl, rt, ct, nzk, rk = cores[kb]
            if not nzk[ij]:
                nzk[ij] = 1
                rt[i] += 1
                ct[j] += 1
            rl[i] = rli = rl[i] + d
            cl[j] = clj = cl[j] + d
            li = rli / rk + rt[i] * delta
            lj = clj / rk + ct[j] * delta
            b = bound[kb]
            if li > b:
                b = li
            if lj > b:
                b = lj
            bound[kb] = b
            choices[t] = kb
            t += 1
        return choices

    def _assign_tau_aware_local(self, fi: list, fj: list,
                                sizes: list) -> np.ndarray:
        """The tau-aware scan with the batch-affinity penalty ``lam`` added,
        in the comparison only, to the cores this call has not used yet."""
        cores, bound, delta = self._cores, self._bound, self.delta
        lam = self._lam
        n_ports = self.n_ports
        choices = np.empty(len(fi), dtype=np.int64)
        used = [False] * len(cores)
        any_used = False
        inf = float("inf")
        t = 0
        for i, j, d in zip(fi, fj, sizes):
            ij = i * n_ports + j
            best = inf
            kb = 0
            k = 0
            for rl, cl, rt, ct, nzk, rk in cores:
                new = 0 if nzk[ij] else 1
                li = (rl[i] + d) / rk + (rt[i] + new) * delta
                lj = (cl[j] + d) / rk + (ct[j] + new) * delta
                b = bound[k]
                if li > b:
                    b = li
                if lj > b:
                    b = lj
                if any_used and not used[k]:
                    b += lam
                if b < best:
                    best = b
                    kb = k
                k += 1
            used[kb] = True
            any_used = True
            rl, cl, rt, ct, nzk, rk = cores[kb]
            if not nzk[ij]:
                nzk[ij] = 1
                rt[i] += 1
                ct[j] += 1
            rl[i] = rli = rl[i] + d
            cl[j] = clj = cl[j] + d
            li = rli / rk + rt[i] * delta
            lj = clj / rk + ct[j] * delta
            b = bound[kb]
            if li > b:
                b = li
            if lj > b:
                b = lj
            bound[kb] = b
            choices[t] = kb
            t += 1
        return choices

    def _assign_tau_aware_sub(self, fi: list, fj: list, sizes: list,
                              up_idx: list[int]) -> np.ndarray:
        """Tau-aware choices over the cores ``up_idx`` (ascending), each with
        its own delay; the same IEEE operations as the unrestricted loop."""
        cores, bound, deltas = self._cores, self._bound, self._delta_c
        lam = self._lam
        n_ports = self.n_ports
        choices = np.empty(len(fi), dtype=np.int64)
        used = [False] * len(cores)
        any_used = False
        inf = float("inf")
        t = 0
        for i, j, d in zip(fi, fj, sizes):
            ij = i * n_ports + j
            best = inf
            kb = up_idx[0]
            for k in up_idx:
                rl, cl, rt, ct, nzk, rk = cores[k]
                delta = deltas[k]
                new = 0 if nzk[ij] else 1
                li = (rl[i] + d) / rk + (rt[i] + new) * delta
                lj = (cl[j] + d) / rk + (ct[j] + new) * delta
                b = bound[k]
                if li > b:
                    b = li
                if lj > b:
                    b = lj
                if lam and any_used and not used[k]:
                    b += lam
                if b < best:
                    best = b
                    kb = k
            if lam:
                used[kb] = True
                any_used = True
            rl, cl, rt, ct, nzk, rk = cores[kb]
            delta = deltas[kb]
            if not nzk[ij]:
                nzk[ij] = 1
                rt[i] += 1
                ct[j] += 1
            rl[i] = rli = rl[i] + d
            cl[j] = clj = cl[j] + d
            li = rli / rk + rt[i] * delta
            lj = clj / rk + ct[j] * delta
            b = bound[kb]
            if li > b:
                b = li
            if lj > b:
                b = lj
            bound[kb] = b
            choices[t] = kb
            t += 1
        return choices

    def _assign_rho_only_sub(self, fi: list, fj: list, sizes: list,
                             up_idx: list[int]) -> np.ndarray:
        """RHO-ASSIGN choices over a core subset (same ops as the hot loop)."""
        cores, cur_rho = self._cores, self._rho
        choices = np.empty(len(fi), dtype=np.int64)
        inf = float("inf")
        t = 0
        for i, j, d in zip(fi, fj, sizes):
            best = inf
            kb = up_idx[0]
            for k in up_idx:
                rl, cl, rk = cores[k]
                li = rl[i] + d
                lj = cl[j] + d
                c = cur_rho[k]
                if li > c:
                    c = li
                if lj > c:
                    c = lj
                c = c / rk
                if c < best:
                    best = c
                    kb = k
            rl, cl, _rk = cores[kb]
            rl[i] = rli = rl[i] + d
            cl[j] = clj = cl[j] + d
            c = cur_rho[kb]
            if rli > c:
                c = rli
            if clj > c:
                c = clj
            cur_rho[kb] = c
            choices[t] = kb
            t += 1
        return choices

    def _assign_rho_only(self, fi: list, fj: list, sizes: list) -> np.ndarray:
        """RHO-ASSIGN choices: minimise ``max(rho^k, li, lj) / r^k``. Loads
        only grow, so a running per-core max equals the reference oracle's
        from-scratch rho (max is a selection, no rounding)."""
        cores, cur_rho = self._cores, self._rho
        choices = np.empty(len(fi), dtype=np.int64)
        inf = float("inf")
        t = 0
        for i, j, d in zip(fi, fj, sizes):
            best = inf
            kb = 0
            k = 0
            for rl, cl, rk in cores:
                li = rl[i] + d
                lj = cl[j] + d
                c = cur_rho[k]
                if li > c:
                    c = li
                if lj > c:
                    c = lj
                c = c / rk
                if c < best:
                    best = c
                    kb = k
                k += 1
            rl, cl, _rk = cores[kb]
            rl[i] = rli = rl[i] + d
            cl[j] = clj = cl[j] + d
            c = cur_rho[kb]
            if rli > c:
                c = rli
            if clj > c:
                c = clj
            cur_rho[kb] = c
            choices[t] = kb
            t += 1
        return choices


def assign_fast(
    inst: Instance,
    pi: torch.Tensor,
    policy: str = "tau-aware",
    *,
    seed: int = 0,
    flows: tuple[torch.Tensor, ...] | None = None,
    locality: float = 0.0,
) -> torch.Tensor:
    """Per-flow core choices ``(F,)`` int64 on the instance's device.

    ``flows`` is the ``(pos, cid, fi, fj, size)`` tuple of
    ``coflow.extract_flows(inst, pi)`` (recomputed when omitted), and the
    choices align with it. ``locality`` (tau-aware only) turns on the
    batch-affinity bias of :class:`FlatAssignState`.
    """
    if flows is None:
        flows = extract_flows(inst, pi)
    _pos, _cid, fi, fj, sizes = flows
    if policy == "tau-aware":
        return FlatAssignState(policy, inst.rates, inst.delta, inst.N,
                               locality=locality).assign(fi, fj, sizes)
    if policy == "rho-only":
        return FlatAssignState(policy, inst.rates, 0.0, inst.N).assign(
            fi, fj, sizes)
    if policy == "random":
        # One vectorized draw: Generator.choice(size=F) consumes the PCG64
        # stream exactly like F sequential scalar draws.
        rng = np.random.default_rng(seed)
        p = _host_f64(inst.rates) / inst.R
        core = rng.choice(inst.K, size=int(fi.shape[0]), p=p).astype(np.int64)
        return torch.from_numpy(core).to(inst.device)
    raise ValueError(f"unknown policy {policy!r}; one of {ASSIGN_POLICIES}")


def assignment_from_choices(
    inst: Instance,
    pi: torch.Tensor,
    flows: tuple[torch.Tensor, ...],
    choices: torch.Tensor,
) -> Assignment:
    """An :class:`Assignment` from flat flows and their core choices.

    ``flows`` is the ``(pos, cid, fi, fj, size)`` tuple of
    ``extract_flows(inst, pi)`` and ``choices`` aligns with it; both cross
    to the host once. ``CoreState.assign`` is replayed flow by flow, so the
    state equals the dataclass oracles' bit for bit.
    """
    pi = torch.as_tensor(pi, dtype=torch.int64, device=inst.device)
    pos, cid, fi, fj, sizes = (t.tolist() for t in flows)
    state = CoreState(K=inst.K, N=inst.N, rates=inst.rates, delta=inst.delta)
    out: list[list[AssignedFlow]] = [[] for _ in range(inst.M)]
    for p, c, i, j, d, k in zip(pos, cid, fi, fj, sizes, choices.tolist()):
        f = Flow(coflow=p, cid=c, i=i, j=j, size=d)
        state.assign(i, j, d, k)
        out[p].append(AssignedFlow(flow=f, core=k))
    return Assignment(inst=inst, pi=pi, flows=out, state=state)
