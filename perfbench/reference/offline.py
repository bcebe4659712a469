"""The plain reference of one offline Algorithm 1 schedule (WSPT order,
flow extraction, tau-aware assignment, work-conserving circuit scheduling,
CCTs), worked out from the demand alone."""
from __future__ import annotations

import numpy as np

from . import common


def schedule(demand: np.ndarray, weights: np.ndarray, rates, delta: float,
             precision: str = "float32") -> dict:
    """The schedule of ``demand`` ``(M, N, N)`` over cores of ``rates``
    with delay ``delta``, the assignment's state in ``precision``.

    Returns ``order`` (coflow indices, WSPT), the flows in that order
    (``pos``, ``m``, ``i``, ``j``, ``size``, ``core``, ``t_est``,
    ``t_comp``), ``ccts`` by coflow index and ``wcct``, their sum weighted
    by ``weights``.
    """
    rates = np.asarray(rates, dtype=np.float64)
    M, N = demand.shape[0], demand.shape[1]
    order = common.wspt_order(common.scores(demand, weights, rates, delta))
    fl = common.extract(demand, order)
    fl["core"] = common.assign(fl["i"], fl["j"], fl["size"], rates, delta, N,
                               precision)
    srv = fl["size"] / rates[fl["core"]]
    fl["t_est"] = common.list_schedule(fl["core"], fl["i"], fl["j"], srv,
                                       delta, N, rates.size)
    fl["t_comp"] = (fl["t_est"] + delta) + srv
    ccts = np.zeros(M)
    np.maximum.at(ccts, fl["m"], fl["t_comp"])
    fl.update(order=order, ccts=ccts,
              wcct=float((np.asarray(weights, dtype=np.float64) * ccts).sum()))
    return fl
