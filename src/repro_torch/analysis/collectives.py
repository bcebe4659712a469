"""The collectives and FLOPs of one traced step, per rank.

The port's counterpart of ``repro.analysis.hlo``. Torch has no HLO: the
reference reads a compiled (post-SPMD) module's text, while the port runs
the step itself, eagerly, on DTensors (usually on ``meta`` tensors under
a fake process group, so nothing is allocated and nothing is sent), and
records what reaches the dispatcher per rank:

  - the functional collectives DTensor issues when it redistributes, with
    their local operand and result bytes and their process group. Rank 0
    sees only its own group, so the group is resolved to its mesh dim and
    every group of that dim is written into ``metadata`` in the
    reference's explicit ``{{0,16,...},{1,17,...}}`` form, which
    ``comm.extract.decode_groups`` reads unchanged;
  - the matmul FLOPs of the local tensors, by ``torch.utils.flop_counter``'s
    formulas (the table ``FlopCounterMode`` counts with).

The reference's layers are a ``lax.scan``, so a per-layer collective is one
op with ``trip_mult = L``. The port's layers are a Python loop: each op is
tagged with its layer (``models.common.in_layer``, which the layer loops
call, tags the backward and the remat recompute too), and the ops equal
across layers in kind, bytes, groups and position are folded into one op
with ``trip_mult`` the layer count. Collectives re-issued by remat's
recompute are real traffic and stay.

``hbm_bytes`` is the per-rank memory traffic: the operand and result bytes
of every local compute op that reaches the dispatcher (the rank's blocks,
views and allocations excluded, collectives counted apart above). The
reference estimates HBM traffic at the surfaces of XLA's fusions; eager
PyTorch runs each op as a kernel of its own, whose operands are read from
and whose results are written to device memory, so the sum over ops is
the port's counterpart of the fusion-surface estimate: an unfused count,
an upper bound on what a fused step would move. An in-place op counts its
destination both as read and as written.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable

import torch

from ..models import common as mcommon

__all__ = ["CollectiveOp", "HLOAnalysis", "analyze_step"]


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    operand_bytes: int  # per-rank bytes entering the op
    result_bytes: int
    group_size: int
    trip_mult: int  # how many times it executes (layers folded)
    metadata: str = ""

    @property
    def total_operand_bytes(self) -> int:
        return self.operand_bytes * self.trip_mult

    @property
    def wire_bytes(self) -> int:
        """Ring-model bytes a participating rank puts on the wire."""
        g, b_in, b_out = self.group_size, self.operand_bytes, self.result_bytes
        if g <= 1:
            return 0
        kind = self.kind.replace("-start", "")
        if kind == "all-reduce":
            w = 2 * (g - 1) / g * b_in
        elif kind == "all-gather":
            w = (g - 1) / g * b_out  # result is the gathered buffer
        elif kind == "reduce-scatter":
            w = (g - 1) / g * b_in
        elif kind == "all-to-all":
            w = (g - 1) / g * b_in
        else:  # collective-permute
            w = b_in
        return int(w * self.trip_mult)


@dataclasses.dataclass
class HLOAnalysis:
    """The reference's record of a step. ``flops`` and ``hbm_bytes`` are
    per rank and count every layer; ``hbm_bytes`` is the unfused sum of
    the compute ops' operand and result bytes."""

    flops: float
    hbm_bytes: float
    collectives: list[CollectiveOp]

    @property
    def collective_operand_bytes(self) -> int:
        return sum(c.total_operand_bytes for c in self.collectives)

    @property
    def collective_wire_bytes(self) -> int:
        return sum(c.wire_bytes for c in self.collectives)

    def collective_counts(self) -> dict:
        out: dict = defaultdict(int)
        for c in self.collectives:
            out[c.kind.replace("-start", "")] += c.trip_mult
        return dict(out)


#: functional collective -> the reference's HLO opcode (the functional
#: collectives' bookkeeping ops, ``wait_tensor`` and ``_wrap_tensor_autograd``,
#: are not traffic and are not recorded)
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _mesh_groups(mesh) -> dict[str, tuple[int, str]]:
    """Process-group name -> ``(group size, metadata)`` for every dim of
    ``mesh``: all groups of the dim, explicit."""
    ranks = mesh.mesh
    out = {}
    for d in range(mesh.ndim):
        groups = ranks.movedim(d, -1).reshape(-1, ranks.shape[d]).tolist()
        meta = "{" + ",".join("{" + ",".join(map(str, g)) + "}"
                              for g in groups) + "}"
        out[mesh.get_group(d).group_name] = (ranks.shape[d], meta)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


#: ops that allocate without reading or writing data
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})


def _op_bytes(func, args, kwargs, out) -> int:
    """Operand and result bytes of one local compute op (0 for a view or
    an allocation)."""
    from torch.utils._pytree import tree_leaves

    if func.is_view or func._overloadpacket.__name__ in _ALLOCS:
        return 0
    return sum(_nbytes(t) for t in tree_leaves((args, kwargs, out))
               if isinstance(t, torch.Tensor))


class _Recorder:
    """The dispatch mode of one trace: ``records`` holds, per collective,
    ``(layer tag, kind, operand bytes, result bytes, group name)``;
    ``flops`` and ``hbm_bytes`` add up the local compute ops."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        rec = self
        self.records: list[tuple] = []
        self.flops = 0
        self.hbm_bytes = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                # let DTensor run first and desugar into local ops and
                # collectives, which come back through this mode
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                # DTensor's sharding propagation infers shapes on fake
                # tensors of the global shape: not the rank's work
                if any(isinstance(a, FakeTensor) for a in args):
                    return out
                packet = func._overloadpacket
                name = packet.__name__
                if "c10d" in func.namespace:
                    # the functional collectives and their bookkeeping
                    if name in _KINDS:
                        group = [a for a in args if isinstance(a, str)][-1]
                        rec.records.append((mcommon.LAYER_TAGS[1],
                                            _KINDS[name], _nbytes(args[0]),
                                            _nbytes(out), group))
                    return out
                if packet in flop_registry:
                    rec.flops += flop_registry[packet](*args, **kwargs,
                                                       out_val=out)
                rec.hbm_bytes += _op_bytes(func, args, kwargs, out)
                return out

        self.mode = Mode()


def _fold(records: list[tuple], groups: dict) -> list[CollectiveOp]:
    """One ``CollectiveOp`` per record, the per-layer ones folded: when
    every layer issued the same ops (kind, bytes, group) in the same order,
    layer 0's list stands for all with ``trip_mult`` the layer count, at
    the place of the first layered op; otherwise each stays as it is."""

    def op(r, trips=1):
        _, kind, b_in, b_out, group = r
        if group not in groups:
            raise ValueError(f"collective on process group {group!r}, "
                             "which is no dim of the mesh")
        size, meta = groups[group]
        return CollectiveOp(kind, b_in, b_out, size, trips, meta)

    by_layer: dict = defaultdict(list)
    for r in records:
        if r[0] is not None:
            by_layer[r[0]].append(r[1:])
    seqs = list(by_layer.values())
    same = len(seqs) > 1 and all(s == seqs[0] for s in seqs[1:])
    out, placed = [], False
    for r in records:
        if r[0] is None or not same:
            out.append(op(r))
        elif not placed:
            out.extend(op((None, *x), len(seqs)) for x in seqs[0])
            placed = True
    return out


def analyze_step(fn: Callable, *args, mesh, **kwargs) -> HLOAnalysis:
    """Run ``fn(*args, **kwargs)`` (a train, prefill or decode step on
    DTensors on ``mesh``) and return its per-rank collectives, FLOPs and
    memory traffic, the layers folded. The step's own result is
    dropped."""
    groups = _mesh_groups(mesh)
    rec = _Recorder()
    prev = mcommon.LAYER_TAGS[:]
    mcommon.LAYER_TAGS[:] = [True, None]
    try:
        with rec.mode:
            fn(*args, **kwargs)
    finally:
        mcommon.LAYER_TAGS[:] = prev
    return HLOAnalysis(flops=float(rec.flops),
                       hbm_bytes=float(rec.hbm_bytes),
                       collectives=_fold(rec.records, groups))
