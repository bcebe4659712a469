"""Circuit planner: run Algorithm 1 (and its ablation baselines) on the
coflows of a traced step, producing the circuit schedule the fabric manager
would program plus its scheduled CCT.

Port of ``repro.comm.planner``. The planner reports, per algorithm:
  - total / weighted CCT of the step's collective phases on the OCS layer,
  - makespan (= the collective term the fabric actually delivers),
  - and the idealised wire-speed lower bound (delta + rho/R per coflow),
so a run can show "wire-speed -> +reconfiguration+contention, scheduled
well (ours) vs scheduled naively (baselines)". The instance lives on
``device`` (``None``: CUDA); ``plan_circuits`` schedules through the port's
``core.run`` (fp64 on the host), ``plan_circuits_service`` through
``service.FabricManager.schedule_instance`` and its program cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import ALGORITHMS, Schedule, global_lb, run, validate
from ..core.coflow import Coflow, instance_from_coflows
from ..core.effects import effects
from ..core.scheduler import tail_quantile

__all__ = ["OCSFabric", "PlanReport", "plan_circuits", "plan_circuits_service"]


@dataclasses.dataclass(frozen=True)
class OCSFabric:
    """The pod-interconnect: K parallel OCS cores over the aggregation blocks.

    Rates are per-port in bytes/second; delta in seconds. Defaults model a
    4-core heterogeneous Jupiter-style DCNI layer: two 200G cores and two
    400G cores per block port, 10 ms circuit reconfiguration. These are
    fabric parameters of the reference's model, not measurements.
    """

    rates: tuple = (25e9, 25e9, 50e9, 50e9)
    delta: float = 10e-3


@dataclasses.dataclass
class PlanReport:
    algorithm: str
    total_cct: float
    weighted_cct: float
    makespan: float
    p95: float
    p99: float
    ideal_lb_sum: float  # sum of per-coflow wire-speed lower bounds
    schedule: Schedule | None
    program: object | None = None  # service.CircuitProgram (service path)
    cached: bool = False           # program came from the service cache
    degraded: bool = False         # planned on a fabric with cores down

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("schedule")
        d.pop("program")
        return d


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def plan_circuits(
    coflows: list[Coflow],
    fabric: OCSFabric = OCSFabric(),
    algorithms: tuple = ALGORITHMS,
    *,
    seed: int = 0,
    device=None,
) -> dict[str, PlanReport]:
    inst = instance_from_coflows(coflows, np.asarray(fabric.rates),
                                 fabric.delta, device=device)
    lbs = [global_lb(c.demand, inst.R, inst.delta) for c in coflows]
    out: dict[str, PlanReport] = {}
    for alg in algorithms:
        s = run(inst, alg, seed=seed)
        validate(s)
        ccts = _host(s.ccts)
        out[alg] = PlanReport(
            algorithm=alg,
            total_cct=float(ccts.sum()),
            weighted_cct=s.total_weighted_cct,
            makespan=float(ccts.max()) if len(ccts) else 0.0,
            p95=tail_quantile(ccts, 0.95),
            p99=tail_quantile(ccts, 0.99),
            ideal_lb_sum=float(np.sum(lbs)),
            schedule=s,
        )
    return out


@effects("cache-read", "cache-write", "cache-rekey",
         "rng-consume", "trace-emit")
def plan_circuits_service(
    coflows: list[Coflow],
    fabric: OCSFabric = OCSFabric(),
    algorithms: tuple = ALGORITHMS,
    *,
    seed: int = 0,
    manager=None,
    device=None,
):
    """Plan a step's circuits through the fabric-manager service.

    Same report as :func:`plan_circuits` but routed through
    ``service.FabricManager.schedule_instance``: the engine fronted by the
    canonical-hash program cache, which is the production shape. A training
    job replans the *same* collective phases every step, so every step
    after the first is a cache hit and never touches the engine. Pass a
    shared ``manager`` to keep the cache warm across steps; each emitted
    program is validated by the independent referee. Returns
    ``(reports, manager)``.

    Degraded operation rides along: if the shared manager has taken a
    ``report_fault(CoreDown(...))``, the replanned step's circuits avoid the
    failed core (the manager schedules over the survivors and relabels to
    physical core ids) and the report is marked ``degraded`` (cache keys are
    fingerprinted per up-core set, so healthy and degraded programs never
    cross).
    """
    from ..service import FabricConfig, FabricManager

    inst = instance_from_coflows(coflows, np.asarray(fabric.rates),
                                 fabric.delta, device=device)
    if manager is None:
        manager = FabricManager(FabricConfig(
            rates=tuple(fabric.rates), delta=fabric.delta, N=inst.N),
            device=inst.demand.device)
    lbs = [global_lb(c.demand, inst.R, inst.delta) for c in coflows]
    out: dict[str, PlanReport] = {}
    for alg in algorithms:
        program, cached = manager.schedule_instance(inst, algorithm=alg,
                                                    seed=seed)
        program.validate()
        s = program.as_schedule()
        # The program's reconstructed instance is keyed/ordered by cid and
        # omits zero-demand coflows; recover the submitted weights through
        # the cid labels and pad the omitted coflows' 0.0 CCTs back in so
        # the quantiles match plan_circuits over the full M.
        w_of = {c.cid: c.weight for c in coflows}
        pad = len(coflows) - s.inst.M
        weights = np.array([w_of[int(c)] for c in _host(s.inst.cids)]
                           + [1.0] * pad)
        ccts = np.concatenate([_host(s.ccts), np.zeros(pad)])
        out[alg] = PlanReport(
            algorithm=alg,
            total_cct=float(ccts.sum()),
            weighted_cct=float((weights * ccts).sum()) if ccts.size else 0.0,
            makespan=float(ccts.max()) if ccts.size else 0.0,
            p95=float(np.quantile(ccts, 0.95)) if ccts.size else 0.0,
            p99=float(np.quantile(ccts, 0.99)) if ccts.size else 0.0,
            ideal_lb_sum=float(np.sum(lbs)),
            schedule=None,
            program=program,
            cached=cached,
            degraded=not bool(manager.state.core_up.all()),
        )
    return out, manager
