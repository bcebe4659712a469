"""Plain numpy pieces of the scheduling reference: WSPT scores, flow
extraction, the tau-aware assignment in a chosen precision, the
work-conserving circuit list scheduler and a feasibility referee.

Written from the paper's Algorithm 1 and the program's documented float
expressions, with no code of the program: given the same demand it must
give the program's order, flows, core choices and circuit times bit for
bit. Nothing here imports torch, jax or the program.
"""
from __future__ import annotations

import heapq

import numpy as np

#: Precisions the assignment can be computed in: the program's states and
#: the lower ones its controls use.
PRECISIONS = ("float64", "float32", "bfloat16")


def scores(demand: np.ndarray, weights: np.ndarray, rates: np.ndarray,
           delta: float) -> np.ndarray:
    """WSPT scores ``w_m / (delta + rho_m / R)`` (``+inf`` for an empty
    coflow), with rho the largest row or column sum of the coflow's matrix
    and R the sum of the core rates, each summed by numpy per matrix."""
    R = float(np.asarray(rates, dtype=np.float64).sum())
    out = np.empty(len(demand))
    for m, D in enumerate(demand):
        if not D.any():
            out[m] = np.inf
            continue
        rho = max(D.sum(axis=1).max(), D.sum(axis=0).max())
        out[m] = weights[m] / (delta + rho / R)
    return out


def wspt_order(sc: np.ndarray) -> np.ndarray:
    """Coflows by score, highest first; ties by index."""
    return np.argsort(-sc, kind="stable")


def coflow_flows(D: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(i, j, size)`` of one coflow's nonzero cells, largest first, ties
    by ingress then egress port."""
    ii, jj = np.nonzero(D)
    sz = D[ii, jj]
    o = np.lexsort((jj, ii, -sz))
    return ii[o], jj[o], sz[o]


def extract(demand: np.ndarray, order: np.ndarray) -> dict:
    """Every flow, coflow by coflow in ``order``: ``pos`` (rank in the
    order), ``m`` (coflow index), ``i``, ``j``, ``size`` and ``intra``
    (rank inside its coflow)."""
    cols = {k: [] for k in ("pos", "m", "i", "j", "size", "intra")}
    for p, m in enumerate(np.asarray(order).tolist()):
        i, j, s = coflow_flows(demand[m])
        cols["pos"].append(np.full(i.size, p, dtype=np.int64))
        cols["m"].append(np.full(i.size, m, dtype=np.int64))
        cols["i"].append(i.astype(np.int64))
        cols["j"].append(j.astype(np.int64))
        cols["size"].append(s)
        cols["intra"].append(np.arange(i.size, dtype=np.int64))
    out = {}
    for k, parts in cols.items():
        dt = np.float64 if k == "size" else np.int64
        out[k] = np.concatenate(parts) if parts else np.zeros(0, dt)
    return out


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), kept in
    float32."""
    x = np.asarray(x, dtype=np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


class Assigner:
    """Tau-aware greedy assignment (Alg. 1 lines 5-17), flow by flow, with
    its state carried from one call to the next.

    Per core k, with the state of the cores so far,
    ``li = (row_load[i] + d) / r_k + (row_tau[i] + new) * delta`` (``new``
    is 1 where the core has no circuit for (i, j) yet), ``lj`` likewise on
    the column, and the candidate ``max(bound_k, li, lj)``; the flow goes
    to the first core of least candidate, whose bound becomes that
    candidate.

    ``float64`` divides by the rate in Python floats. ``float32`` keeps the
    state in float32, multiplies by the float32 reciprocal of the rate and
    rounds every operation on its own (no fused multiply-add), as the
    program's kernel does. ``bfloat16`` is that with every result rounded
    to bfloat16: a control, not the program.
    """

    def __init__(self, rates, delta: float, n_ports: int,
                 precision: str) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        K = len(rates)
        self.K = K
        if precision == "float64":
            self.rl = [[0.0] * K for _ in range(n_ports)]
            self.cl = [[0.0] * K for _ in range(n_ports)]
            self.rt = [[0] * K for _ in range(n_ports)]
            self.ct = [[0] * K for _ in range(n_ports)]
            self.used: set = set()
            self.bound = [0.0] * K
            self.rk = [float(r) for r in rates]
            self.dl = float(delta)
            return
        f32 = np.float32
        self.rnd = _bf16 if precision == "bfloat16" else (lambda a: a)
        self.inv = self.rnd(np.ones(K, f32) / np.asarray(rates, dtype=f32))
        self.dl = self.rnd(np.asarray([delta], dtype=f32))[0]
        self.row_load = np.zeros((n_ports, K), f32)
        self.col_load = np.zeros((n_ports, K), f32)
        self.row_tau = np.zeros((n_ports, K), f32)
        self.col_tau = np.zeros((n_ports, K), f32)
        self.nz = np.zeros((n_ports, n_ports, K), f32)
        self.bound = np.zeros(K, f32)

    def assign(self, fi: np.ndarray, fj: np.ndarray,
               size: np.ndarray) -> np.ndarray:
        """The cores of the next flows ``(len(fi),)`` int64."""
        if self.precision == "float64":
            return self._assign64(fi, fj, size)
        rnd, inv, dl = self.rnd, self.inv, self.dl
        row_load, col_load = self.row_load, self.col_load
        row_tau, col_tau, nz, bound = (self.row_tau, self.col_tau, self.nz,
                                       self.bound)
        out = np.empty(len(fi), dtype=np.int64)
        sizes = rnd(np.asarray(size, dtype=np.float32))
        one = np.float32(1.0)
        for t, (i, j) in enumerate(zip(np.asarray(fi).tolist(),
                                       np.asarray(fj).tolist())):
            d = sizes[t]
            new = one - nz[i, j]
            li = rnd(rnd(rnd(row_load[i] + d) * inv)
                     + rnd(rnd(row_tau[i] + new) * dl))
            lj = rnd(rnd(rnd(col_load[j] + d) * inv)
                     + rnd(rnd(col_tau[j] + new) * dl))
            cand = np.maximum(bound, np.maximum(li, lj))
            k = int(np.argmin(cand))
            row_load[i, k] = rnd(row_load[i, k] + d)
            col_load[j, k] = rnd(col_load[j, k] + d)
            row_tau[i, k] += new[k]
            col_tau[j, k] += new[k]
            nz[i, j, k] = one
            bound[k] = cand[k]
            out[t] = k
        return out

    def _assign64(self, fi, fj, size) -> np.ndarray:
        rl, cl, rt, ct = self.rl, self.cl, self.rt, self.ct
        used, bound, rk, dl, K = self.used, self.bound, self.rk, self.dl, \
            self.K
        out = np.empty(len(fi), dtype=np.int64)
        for t, (i, j, d) in enumerate(zip(np.asarray(fi).tolist(),
                                          np.asarray(fj).tolist(),
                                          np.asarray(size).tolist())):
            rli, clj, rti, ctj = rl[i], cl[j], rt[i], ct[j]
            best, kb = float("inf"), 0
            for k in range(K):
                new = 0 if (k, i, j) in used else 1
                c = max(bound[k], (rli[k] + d) / rk[k] + (rti[k] + new) * dl,
                        (clj[k] + d) / rk[k] + (ctj[k] + new) * dl)
                if c < best:
                    best, kb = c, k
            if (kb, i, j) not in used:
                used.add((kb, i, j))
                rti[kb] += 1
                ctj[kb] += 1
            rli[kb] += d
            clj[kb] += d
            bound[kb] = best
            out[t] = kb
        return out


def assign(fi: np.ndarray, fj: np.ndarray, size: np.ndarray,
           rates: np.ndarray, delta: float, n_ports: int,
           precision: str) -> np.ndarray:
    """The cores of flows ``fi, fj, size`` assigned from empty cores (see
    :class:`Assigner`)."""
    return Assigner(rates, delta, n_ports, precision).assign(fi, fj, size)


def list_schedule(core: np.ndarray, fi: np.ndarray, fj: np.ndarray,
                  srv: np.ndarray, delta: float, n_ports: int, n_cores: int,
                  release: np.ndarray | None = None,
                  until: float = np.inf) -> np.ndarray:
    """The work-conserving circuit list scheduler on every core at once;
    flows are given in priority order. Returns each flow's circuit
    establishment time (``nan`` for a flow not started by ``until``).

    At every event time t (a circuit's completion ``(t_est + delta) + srv``
    or a release), the pending flows released by t are scanned in priority
    order and each one whose ingress and egress port on its core are both
    free at t starts at t, holding both until its completion. After the
    first scan, a pending flow can start at t only if a port of it was freed
    at t (a port stays busy until its circuit completes) or it was released
    at t, so only those flows are scanned.
    """
    F = len(core)
    t_est = np.full(F, np.nan)
    if F == 0:
        return t_est
    rin = np.asarray(core * n_ports + fi, dtype=np.int64)
    rout = np.asarray(core * n_ports + fj, dtype=np.int64)
    srv_l = np.asarray(srv, dtype=np.float64).tolist()
    n_res = n_cores * n_ports
    free_in = np.zeros(n_res)
    free_out = np.zeros(n_res)
    started = np.zeros(F, dtype=bool)
    by_in = _groups(rin, n_res)
    by_out = _groups(rout, n_res)
    rel = None if release is None else np.asarray(release, dtype=np.float64)
    events: list[float] = []
    ending: dict[float, list[int]] = {}
    at_release: dict[float, np.ndarray] = {}
    if rel is None:
        cand = np.arange(F)
    else:
        vals, inv = np.unique(rel, return_inverse=True)
        for v, grp in zip(vals.tolist(), _groups(inv, vals.size)):
            at_release[v] = grp
        events = vals.tolist()
        heapq.heapify(events)
        cand = np.nonzero(rel <= 0.0)[0]
    rin_l, rout_l = rin.tolist(), rout.tolist()
    t = 0.0
    left = F
    while True:
        for f in cand.tolist():
            a, b = rin_l[f], rout_l[f]
            if free_in[a] <= t and free_out[b] <= t:
                tc = (t + delta) + srv_l[f]
                free_in[a] = tc
                free_out[b] = tc
                t_est[f] = t
                started[f] = True
                left -= 1
                if tc in ending:
                    ending[tc].append(f)
                else:
                    ending[tc] = [f]
                    heapq.heappush(events, tc)
        if not left:
            break
        while events and events[0] <= t:
            heapq.heappop(events)
        if not events:
            raise RuntimeError("pending flows but no event")
        t = heapq.heappop(events)
        if t > until:
            break
        parts = []
        for f in ending.pop(t, ()):
            for lists, r, other, free_other in (
                    (by_in, rin_l[f], rout, free_out),
                    (by_out, rout_l[f], rin, free_in)):
                lst = lists[r]
                lst = lst[~started[lst]]
                lists[r] = lst
                parts.append(lst[free_other[other[lst]] <= t])
        if rel is not None:
            grp = at_release.get(t)
            if grp is not None:
                grp = grp[~started[grp]]
                parts.append(grp[(free_in[rin[grp]] <= t)
                                 & (free_out[rout[grp]] <= t)])
        cand = np.unique(np.concatenate(parts)) if parts else np.empty(0, int)
        if rel is not None:
            cand = cand[rel[cand] <= t]
    return t_est


def _groups(ids: np.ndarray, n: int) -> list[np.ndarray]:
    """Indices holding each value of ``ids`` (0 .. n-1), in index order."""
    order = np.argsort(ids, kind="stable")
    return np.split(order, np.cumsum(np.bincount(ids, minlength=n))[:-1])
