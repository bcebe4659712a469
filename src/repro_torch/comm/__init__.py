"""Collectives-as-coflows: take a traced step's cross-block collective
traffic, express it as coflows over the multi-core OCS pod interconnect, and
plan circuit schedules with the paper's Algorithm 1.

Port of ``repro.comm``: ``extract`` decodes the groups of a
``analysis.collectives.CollectiveOp``, ``coflows`` turns a step's
collectives into per-phase block demand matrices, ``planner`` schedules them
with the port's engine (``core.run``) or through the fabric-manager service.
"""
from .coflows import BlockMap, collective_demands, step_coflows  # noqa: F401
from .extract import decode_groups, decode_pairs  # noqa: F401
from .planner import (OCSFabric, PlanReport, plan_circuits,  # noqa: F401
                      plan_circuits_service)
