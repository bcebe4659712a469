"""The plain reference of the streaming fabric manager: one online
Algorithm 1 schedule of every coflow submitted so far, worked out from
scratch from the demand, weights and releases alone.

A circuit the service committed at a tick at time T is one whose
establishment time is at most T, and no coflow released after T can move
such a circuit; so the committed program equals this replay's circuits
that establish by the last tick.
"""
from __future__ import annotations

import numpy as np

from . import common


def replay(demand: np.ndarray, weights: np.ndarray, releases: np.ndarray,
           rates, delta: float, until: float,
           precision: str = "float64") -> dict:
    """Coflow g of ``demand`` ``(G, N, N)`` is the g-th submitted, released
    at ``releases[g]``.

    Coflows are assigned at arrival, in order of release (ties: higher WSPT
    score, then submission), each one's flows largest first; each core
    serves flows in WSPT priority order (score, submission, the flow's rank
    in its coflow), a flow eligible from its release on. Returns the flows
    (``g``, ``i``, ``j``, ``size``, ``core``, ``rel``, ``t_est``,
    ``t_comp``), ``nan`` times for a flow not established by ``until``, and
    ``ccts`` by submission index, ``nan`` for a coflow with a flow not
    established by ``until``.
    """
    rates = np.asarray(rates, dtype=np.float64)
    G, N = demand.shape[0], demand.shape[1]
    releases = np.asarray(releases, dtype=np.float64)
    sc = common.scores(demand, weights, rates, delta)
    arrival = np.lexsort((np.arange(G), -sc, releases))
    fl = common.extract(demand, arrival)
    g = fl["m"]
    fl["g"] = g
    fl["core"] = common.assign(fl["i"], fl["j"], fl["size"], rates, delta, N,
                               precision)
    fl["rel"] = releases[g]
    prio = np.lexsort((fl["intra"], g, -sc[g]))
    srv = fl["size"] / rates[fl["core"]]
    t_est = np.full(g.size, np.nan)
    t_est[prio] = common.list_schedule(
        fl["core"][prio], fl["i"][prio], fl["j"][prio], srv[prio], delta, N,
        rates.size, release=fl["rel"][prio], until=until)
    t_est[t_est > until] = np.nan
    fl["t_est"] = t_est
    fl["t_comp"] = (t_est + delta) + srv
    ccts = np.zeros(G)
    with np.errstate(invalid="ignore"):  # nan: not established by until
        np.maximum.at(ccts, g, fl["t_comp"])
    fl["ccts"] = ccts
    fl["releases"] = releases
    return fl
