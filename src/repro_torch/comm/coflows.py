"""Map a traced training or serving step's collectives onto coflows over
the multi-core OCS pod interconnect: where the paper meets the framework.

Port of ``repro.comm.coflows``. A program cannot steer optical circuits
from inside a step; circuit scheduling is a fabric-manager (control-plane)
decision, as in Google Jupiter. So the integration is *planning*: trace a
step (``analysis.collectives.analyze_step``), read its collectives with
their groups, aggregate the traffic that crosses *aggregation-block*
boundaries into an N_block x N_block demand matrix per collective phase,
and hand those coflows to Algorithm 1, which produces the circuit schedule
the fabric manager would program, with the paper's bound.

Blocks: each (pod, data-row) slice of the production mesh is one
aggregation block with one OCS ingress and egress port per core. The
2x16x16 mesh gives 32 blocks of 16 ranks.

Traffic model per collective (per execution), the reference's:
  all-reduce       ring over group members: each device sends 2B(g-1)/g to
                   its ring successor
  all-gather       ring, (g-1)/g of the *result* bytes
  reduce-scatter   ring, (g-1)/g of the operand bytes
  all-to-all       direct pairwise, B/g per ordered pair
  collective-perm  explicit source->target bytes

Only inter-block bytes enter the demand matrix (intra-block traffic rides
the pod-internal links, not the OCS layer). The matrices are numpy fp64 on
the host, as the reference's; a coflow's demand becomes a float64 tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..analysis.collectives import CollectiveOp, HLOAnalysis
from ..core.coflow import Coflow
from .extract import decode_groups, decode_pairs

__all__ = ["BlockMap", "collective_demands", "step_coflows"]


@dataclasses.dataclass(frozen=True)
class BlockMap:
    """device id -> aggregation block id."""

    n_devices: int
    n_blocks: int
    block_of: np.ndarray  # (n_devices,) int

    @classmethod
    def from_mesh_shape(cls, mesh_shape: dict, block_axes: tuple = ("pod", "data")):
        """Blocks = the product of ``block_axes`` (mesh iterates C-order)."""
        axes = list(mesh_shape.keys())
        sizes = [mesh_shape[a] for a in axes]
        n_dev = int(np.prod(sizes))
        block_sizes = [mesh_shape[a] for a in block_axes if a in mesh_shape]
        n_blocks = int(np.prod(block_sizes)) if block_sizes else 1
        # index of each device along the block axes
        grids = np.meshgrid(*[np.arange(s) for s in sizes], indexing="ij")
        block = np.zeros(n_dev, dtype=np.int64)
        mult = 1
        for a in reversed([a for a in block_axes if a in mesh_shape]):
            ax = axes.index(a)
            block += grids[ax].reshape(-1) * mult
            mult *= sizes[ax]
        return cls(n_devices=n_dev, n_blocks=n_blocks, block_of=block)


def _ring_edges(group: list[int]) -> list[tuple[int, int]]:
    return [(group[t], group[(t + 1) % len(group)]) for t in range(len(group))]


def collective_demands(
    c: CollectiveOp, bmap: BlockMap, *, include_trips: bool = True
) -> np.ndarray:
    """N_block x N_block inter-block demand matrix (bytes) for one collective."""
    D = np.zeros((bmap.n_blocks, bmap.n_blocks))
    kind = c.kind.replace("-start", "")
    mult = c.trip_mult if include_trips else 1

    def add(u: int, v: int, bts: float):
        bu, bv = bmap.block_of[u], bmap.block_of[v]
        if bu != bv:
            D[bu, bv] += bts * mult

    if kind == "collective-permute":
        for u, v in decode_pairs(c):
            add(u, v, c.operand_bytes)
        return D

    for group in decode_groups(c, bmap.n_devices):
        g = len(group)
        if g <= 1:
            continue
        if kind == "all-to-all":
            per_pair = c.operand_bytes / g
            for u in group:
                for v in group:
                    if u != v:
                        add(u, v, per_pair)
        else:
            if kind == "all-reduce":
                per_dev = 2 * c.operand_bytes * (g - 1) / g
            elif kind == "all-gather":
                per_dev = c.result_bytes * (g - 1) / g
            else:  # reduce-scatter
                per_dev = c.operand_bytes * (g - 1) / g
            for u, v in _ring_edges(group):
                add(u, v, per_dev)
    return D


def step_coflows(
    analysis: HLOAnalysis,
    bmap: BlockMap,
    *,
    min_bytes: float = 1.0,
    unroll_trips: bool = False,
    weights: str = "unit",
) -> list[Coflow]:
    """One coflow per collective phase of the traced step.

    ``unroll_trips=False`` folds a collective executed T times (once per
    layer) into one coflow carrying T x bytes (the phases are identical);
    True emits T separate coflows (exact program order, larger instances).
    """
    out: list[Coflow] = []
    cid = 0
    for c in analysis.collectives:
        reps = c.trip_mult if unroll_trips else 1
        D = collective_demands(c, bmap, include_trips=not unroll_trips)
        if D.sum() < min_bytes:
            continue
        for _ in range(reps):
            w = 1.0 if weights == "unit" else float(D.sum())
            out.append(Coflow(cid=cid, demand=D.copy(), weight=w))
            cid += 1
    return out
