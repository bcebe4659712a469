"""The benchmark's traffic generator: FB2010-shaped coflows from a seed.

A frozen copy, in plain numpy, of the program's trace surrogate
(``synth_fb_trace``) and of its instance sampler's demand construction
(``sample_instance``, ``machine_map="restrict"``): the same draws from
numpy's PCG64 in the same order, so a seed gives the program's own demand
matrices. It is copied here so that a change to the program cannot move the
yardstick. On top of it sit the two request streams the traffic mixes ask
for: batches of distinct coflows (``RequestDeck``) and an endless arrival
stream (``arrival_stream``).
"""
from __future__ import annotations

import numpy as np

N_RACKS = 150
HOUR_MS = 3_600_000.0


def synth_fb_trace(n_coflows: int = 526, seed: int = 2026) -> list[dict]:
    """The calibrated surrogate of the FB2010-1Hr-150-0 coflow benchmark:
    ~60% narrow (<= 4x4, MB-scale reducers), ~30% medium, ~10% wide (up to
    all 150 racks, GB-scale); arrivals are sorted uniforms over one hour.
    Each coflow is a dict of ``arrival_ms``, ``mappers``, ``reducers`` and
    ``reducer_mb``."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0, HOUR_MS, n_coflows))
    out = []
    for cid in range(n_coflows):
        u = rng.random()
        if u < 0.60:
            n_map = int(rng.integers(1, 5))
            n_red = int(rng.integers(1, 5))
            scale_mb = rng.lognormal(mean=0.0, sigma=1.2)
        elif u < 0.90:
            n_map = int(rng.integers(5, 31))
            n_red = int(rng.integers(5, 31))
            scale_mb = rng.lognormal(mean=2.5, sigma=1.2)
        else:
            n_map = int(rng.integers(30, N_RACKS + 1))
            n_red = int(rng.integers(30, N_RACKS + 1))
            scale_mb = rng.lognormal(mean=5.5, sigma=1.0)
        mappers = [int(x) for x in rng.choice(N_RACKS, size=n_map,
                                               replace=False)]
        reducers = [int(x) for x in rng.choice(N_RACKS, size=n_red,
                                                replace=False)]
        red_mb = [float(scale_mb * rng.lognormal(0.0, 0.75))
                  for _ in range(n_red)]
        out.append({"cid": cid, "arrival_ms": float(arrivals[cid]),
                    "mappers": mappers, "reducers": reducers,
                    "reducer_mb": red_mb})
    return out


def demand_pool(trace: list[dict], n_ports: int, seed: int) -> np.ndarray:
    """``(len(trace), N, N)`` float64 demand of every trace coflow.

    ``n_ports`` of the 150 racks become the ports (all of them at N = 150,
    mapped one to one in a random order) and only traffic between them
    survives; each reducer's bytes are split over the coflow's mappers with
    a +-20% perturbation. The draws are ``sample_instance``'s, in its
    order, so ``pool[pick[m]]`` is its ``demand[m]`` for the same seed.
    """
    rng = np.random.default_rng(seed)
    selected = rng.choice(N_RACKS, size=n_ports, replace=False)
    port_of = np.full(N_RACKS, -1, dtype=np.int64)
    port_of[selected] = np.arange(n_ports)
    pool = np.zeros((len(trace), n_ports, n_ports))
    for m, tc in enumerate(trace):
        maps = np.asarray(tc["mappers"], dtype=np.int64)
        n_map = maps.size
        D = pool[m]
        for r_rack, mb in zip(tc["reducers"], tc["reducer_mb"]):
            shares = rng.uniform(0.8, 1.2, size=n_map)
            shares = shares / shares.sum() * mb
            pr = port_of[r_rack]
            if pr < 0:
                continue
            ps = port_of[maps]
            keep = ps >= 0
            # mappers are distinct racks, so each (sender, receiver) cell
            # gets one share: 0.0 + share, as the sampler's ``+=``
            D[ps[keep], pr] += shares[keep]
    return pool


def nonempty(pool: np.ndarray) -> np.ndarray:
    """Indices of the pool's coflows that carry traffic."""
    return np.nonzero(pool.reshape(pool.shape[0], -1).any(axis=1))[0]


def flow_counts(pool: np.ndarray) -> np.ndarray:
    """Flows (nonzero cells) of each coflow of the pool."""
    return (pool > 0).reshape(pool.shape[0], -1).sum(axis=1)


class Blocks:
    """Endless blocks of ``size`` distinct coflows, each holding one coflow
    of every size stratum.

    The coflows ``ids`` are sorted by flow count (largest first, ties by
    id) and cut into ``size`` strata of consecutive coflows. A pass
    permutes every stratum by the seed, and its block r takes member r of
    each (a stratum shorter than r + 1 gives a member drawn at random), so
    one pass deals every coflow, and every block has the same mix of
    narrow and wide coflows: every seed sends the same coflows in blocks of
    like size, grouped and ordered differently.
    """

    def __init__(self, ids: np.ndarray, flows: np.ndarray, size: int,
                 rng: np.random.Generator) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        if size > ids.size:
            raise ValueError(f"a block of {size} distinct coflows needs a "
                             f"pool of as many, got {ids.size}")
        order = ids[np.lexsort((ids, -np.asarray(flows)[ids]))]
        self.strata = np.array_split(order, int(size))
        self.per_pass = max(s.size for s in self.strata)
        self.rng = rng
        self.n = 0
        self._perms: list[np.ndarray] = []

    def next(self) -> np.ndarray:
        r = self.n % self.per_pass
        if r == 0:
            self._perms = [self.rng.permutation(s) for s in self.strata]
        self.n += 1
        return np.array([p[r] if r < p.size else p[self.rng.integers(p.size)]
                         for p in self._perms], dtype=np.int64)


class RequestDeck:
    """Offline requests: batches of ``size`` distinct coflows, one block of
    :class:`Blocks` each, so that every batch has the same mix of narrow
    and wide coflows. Weights are uniform integers in ``weights``, drawn
    from the seed and the batch's index."""

    def __init__(self, ids: np.ndarray, flows: np.ndarray, size: int,
                 seed: int, weights: tuple[int, int]) -> None:
        self.seed = int(seed)
        self.lo, self.hi = (int(w) for w in weights)
        self.blocks = Blocks(ids, flows, size,
                             np.random.default_rng([self.seed, 0]))
        self.dealt = 0

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """``(pick (size,) int64, weights (size,) float64)`` of the next
        batch."""
        pick = self.blocks.next()
        wrng = np.random.default_rng([self.seed, 1, self.dealt])
        w = wrng.integers(self.lo, self.hi + 1, size=pick.size)
        self.dealt += 1
        return pick, w.astype(np.float64)


def arrival_stream(trace: list[dict], ids: np.ndarray, flows: np.ndarray,
                   seed: int, rate: float, weights: tuple[int, int],
                   block: int, stride: int):
    """Endless ``(coflow id, release, weight)`` arrivals, in blocks of
    ``block``.

    The coflows of a block are one of each size stratum (:class:`Blocks`),
    and the coflow of stratum s (0 the widest) arrives ``s * stride %
    block``-th, ``stride`` prime to ``block``: the wide coflows come spread
    out, in the same places of every block. The gaps of every block are the
    trace's own first ``block`` inter-arrival gaps, in the trace's order
    (bursts stay bursts), scaled so that their mean is ``1 / rate`` stream
    units. So the offered work repeats its shape every block, and any
    stretch of several blocks offers the same work whatever the seed; the
    seed picks the members, their weights, the ports and the shares. The
    first arrival comes one gap after time 0. Weights are uniform integers
    in ``weights``.
    """
    if np.gcd(int(stride), int(block)) != 1:
        raise ValueError("stride must be prime to block")
    arr = np.array([tc["arrival_ms"] for tc in trace])
    gaps = np.diff(arr)
    gaps = gaps[gaps > 0][:int(block)]
    gaps = gaps / gaps.mean() / float(rate)
    rng = np.random.default_rng([int(seed), 2])
    blocks = Blocks(ids, flows, block, rng)
    place = np.arange(block) * int(stride) % int(block)
    lo, hi = (int(w) for w in weights)
    t = 0.0
    n = 0
    while True:
        cs = np.empty(block, dtype=np.int64)
        cs[place] = blocks.next()
        ws = rng.integers(lo, hi + 1, size=cs.size).astype(np.float64)
        for c, w in zip(cs.tolist(), ws.tolist()):
            t += float(gaps[n % block])
            n += 1
            yield c, t, w
