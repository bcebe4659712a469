"""Online extension: coflows with release (arrival) times.

Port of ``repro.core.online``'s ordering, shared by every online entry point
of the engine. Coflow ``m`` becomes known at ``releases[m]``; its flows are
assigned at arrival, irrevocably, by the same greedy rule as offline, in
arrival order (ties broken by WSPT score), and each core schedules flows in
WSPT priority order, a flow eligible only at times ``t >= release``. The WSPT
score of a coflow never changes, so re-ranking the pending set at each
arrival equals one static ranking of all coflows by score; with all releases
0 the arrival order, the priority order and the offline order coincide.
"""
from __future__ import annotations

import torch

from .coflow import Instance
from .ordering import priority_scores

__all__ = ["online_orders"]


def online_orders(inst: Instance, rel: torch.Tensor,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(arrival order, priority rank)``, both ``(M,)`` int64 on the
    instance's device.

    Arrival order: coflows sorted by ``(release, -score, index)``, the
    reference's ``np.lexsort((-s, rel))``, as two stable sorts (secondary
    key first). Priority rank: ``prio_rank[m]`` is coflow ``m``'s position in
    the WSPT order of all coflows (score descending, stable by index).
    """
    s = priority_scores(inst)
    rel = torch.as_tensor(rel, dtype=torch.float64, device=inst.device)
    by_score = torch.argsort(-s, stable=True)
    arrival = by_score[torch.argsort(rel[by_score], stable=True)]
    prio_rank = torch.empty(inst.M, dtype=torch.int64, device=inst.device)
    prio_rank[by_score] = torch.arange(inst.M, device=inst.device)
    return arrival, prio_rank
