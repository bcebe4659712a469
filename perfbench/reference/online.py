"""The plain reference of one online Algorithm 1 schedule (arrival order,
assignment at arrival, WSPT priority, release-gated work-conserving
circuit scheduling, CCTs), worked out from the demand, weights and
releases alone: the stream's replay of every coflow to the end, with the
arrival order and the weighted CCT that an offline answer is judged by."""
from __future__ import annotations

import numpy as np

from . import common, stream


def schedule(demand: np.ndarray, weights: np.ndarray, releases: np.ndarray,
             rates, delta: float, precision: str = "float32") -> dict:
    """The online schedule of ``demand`` ``(M, N, N)``, coflow m released
    at ``releases[m]``, over cores of ``rates`` with delay ``delta``, the
    assignment's state in ``precision``.

    Coflows arrive in order of ``(release, -score, index)`` and are
    assigned in that order; each core serves its flows in WSPT priority
    order (score, index, the flow's rank in its coflow), a flow eligible
    from its coflow's release on (``stream.replay``). Returns ``order``
    (coflow indices in arrival order), the flows in that order (``pos``,
    ``m``, ``i``, ``j``, ``size``, ``core``, ``rel``, ``t_est``,
    ``t_comp``), ``ccts`` by coflow index and ``wcct``, their sum weighted
    by ``weights``.
    """
    rates = np.asarray(rates, dtype=np.float64)
    releases = np.asarray(releases, dtype=np.float64)
    fl = stream.replay(demand, weights, releases, rates, delta, np.inf,
                       precision)
    sc = common.scores(demand, weights, rates, delta)
    fl["order"] = np.lexsort((np.arange(len(demand)), -sc, releases))
    fl["wcct"] = float((np.asarray(weights, dtype=np.float64)
                        * fl["ccts"]).sum())
    return fl
