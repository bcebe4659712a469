"""Logical-axis sharding planner, on ``DeviceMesh`` and DTensor placements.

Port of ``repro.distributed.sharding``. Every parameter and cache dim
carries a logical name (each family's ``param_axes(cfg)`` and
``cache_axes()``). Rules map each logical name to an ordered list of
mesh-axis candidates; the planner picks the first candidate whose axes
(a) all exist in the mesh, (b) are not already used by another dim of the
same array, and (c) whose product divides the dim size and exceeds 1.
Exhausting the candidates replicates the dim, so every (arch x mesh) cell
shards coherently without per-arch special cases.

Rule sets (copied from the reference):
  TRAIN  FSDP over "data" (+"pod") on the big parameter dims, TP over
         "model" for vocab/mlp/heads/experts; batch over ("pod","data").
  SERVE  params TP over "model" only; caches shard batch over
         ("pod","data") and kv_heads over "model", with the serve engine's
         fallback to sequence-dim sharding when head counts do not divide.

A plan (:class:`ShardPlan`) is the reference's ``PartitionSpec`` as a
tuple, e.g. ``(("pod", "data"), None, "model")``, and the DTensor
placements it implies, one per mesh dim. An entry of two axes
``("pod", "data")`` is ``Shard(d)`` on both mesh dims; DTensor splits such a
dim in mesh-dim order, pod-major, as JAX's ``NamedSharding`` does.

A mesh is a ``DeviceMesh`` with dim names, or anything that maps axis
names to sizes in mesh order (a dict, or an object whose ``shape`` is such
a mapping), so specs can be planned without a process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple

import torch

__all__ = ["RuleSet", "TRAIN_RULES", "SERVE_RULES", "ShardPlan",
           "NamedSharding",
           "abstract_mesh", "mesh_axes", "plan_sharding", "plan_tree",
           "batch_spec", "local_slices", "shard_tensor", "shard_tree",
           "shard_module"]


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """logical axis name -> ordered candidates, each a tuple of mesh axes."""

    rules: dict

    def candidates(self, name):
        if name is None:
            return ((),)
        return self.rules.get(name, ((),))


TRAIN_RULES = RuleSet(
    {
        # activations / inputs
        "batch": (("pod", "data"), ("data",), ()),
        "seq": ((),),
        # parameters — TP dims
        "vocab": (("model",), ()),
        "mlp": (("model",), ()),
        "heads_flat": (("model",), ()),
        "kv_flat": (("model",), ()),
        "heads": (("model",), ()),
        "experts": (("model",), ()),
        "rnn": (("model",), ()),
        # parameters — FSDP dim (the "other" big dim of each kernel)
        "embed": (("data",), ()),
        "experts_r": ((),),
        "rnn2": ((),),
        # stacking / small dims — replicated
        "layers": ((),),
        "sup": ((),),
        "kv_heads": (("model",), ()),
        "head_dim": ((),),
        "seq_sharded": (("model",), ()),
    }
)

SERVE_RULES = RuleSet(
    {
        "batch": (("pod", "data"), ("data",), ()),
        "seq": ((),),
        "vocab": (("model",), ()),
        "mlp": (("model",), ()),
        "heads_flat": (("model",), ()),
        "kv_flat": (("model",), ()),
        "heads": (("model",), ()),
        "experts": (("model",), ()),
        "rnn": (("model",), ()),
        "embed": ((),),  # no FSDP at serving: weights live TP-only
        "experts_r": ((),),
        "rnn2": ((),),
        "layers": ((),),
        "sup": ((),),
        "kv_heads": (("model",), ()),
        "head_dim": ((),),
        "seq_sharded": (("model",), ()),
    }
)


def abstract_mesh(axis_sizes, axis_names) -> dict[str, int]:
    """A mesh for planning only (no process group, no devices): axis name
    -> size, in mesh order."""
    return dict(zip(axis_names, axis_sizes))


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One array's plan: the reference's spec and the DTensor placements
    (one per mesh dim, in mesh order)."""

    spec: tuple
    placements: tuple


class NamedSharding(NamedTuple):
    """A leaf of a shardings tree (``checkpoint.restore_checkpoint``): a
    ``DeviceMesh`` and a plan on it, as JAX's ``NamedSharding`` pairs a
    mesh and a spec."""

    mesh: Any
    plan: ShardPlan


def _placements(axes: dict[str, int], spec: tuple) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        order = [list(axes).index(a) for a in group]
        if order != sorted(order):  # DTensor nests shards in mesh order
            raise ValueError(f"axes {group} of dim {d} are not in mesh "
                             f"order {tuple(axes)}")
        for a in group:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axes)


def _plan(axes: dict[str, int], spec: list) -> ShardPlan:
    spec = tuple(spec)
    return ShardPlan(spec=spec, placements=_placements(axes, spec))


def plan_sharding(mesh, shape: tuple, axes: tuple, rules: RuleSet
                  ) -> ShardPlan:
    """The plan of one array given its logical axis names."""
    assert len(shape) == len(axes), (shape, axes)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    spec = []
    for dim, name in zip(shape, axes):
        chosen = None
        for cand in rules.candidates(name):
            if not cand:
                chosen = None
                break
            if any(a not in sizes or a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if dim % prod == 0 and prod > 1:
                chosen = tuple(cand)
                break
        if chosen:
            used.update(chosen)
            spec.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            spec.append(None)
    return _plan(sizes, spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def plan_tree(mesh, abstract: Any, axes_tree: Any, rules: RuleSet) -> Any:
    """Plans for a tree of arrays (anything with ``.shape``) and its
    parallel tree of logical axes: dicts (by state-dict name), NamedTuples
    (caches), lists and tuples."""
    if hasattr(abstract, "shape"):
        if not _is_axes(axes_tree):
            raise ValueError(f"no axes for an array of shape "
                             f"{tuple(abstract.shape)}: {axes_tree!r}")
        return plan_sharding(mesh, tuple(abstract.shape), axes_tree, rules)
    if isinstance(abstract, Mapping):
        if set(abstract) != set(axes_tree):
            raise ValueError("the array and axes trees differ: "
                             f"{sorted(set(abstract) ^ set(axes_tree))}")
        return {k: plan_tree(mesh, v, axes_tree[k], rules)
                for k, v in abstract.items()}
    if hasattr(abstract, "_fields"):  # NamedTuple
        return type(abstract)(*[plan_tree(mesh, getattr(abstract, f),
                                          getattr(axes_tree, f), rules)
                                for f in abstract._fields])
    if isinstance(abstract, (list, tuple)):
        return type(abstract)(plan_tree(mesh, a, x, rules)
                              for a, x in zip(abstract, axes_tree))
    raise TypeError(f"cannot plan a {type(abstract).__name__}")


def batch_spec(mesh, ndim: int, global_batch: int) -> ShardPlan:
    """Input batch plan: dim 0 over ("pod","data") with fallback."""
    sizes = mesh_axes(mesh)
    for cand in (("pod", "data"), ("data",), ()):
        if all(a in sizes for a in cand):
            prod = math.prod(sizes[a] for a in cand) if cand else 1
            if cand and global_batch % prod == 0:
                lead = tuple(cand) if len(cand) > 1 else cand[0]
                return _plan(sizes, [lead, *([None] * (ndim - 1))])
    return _plan(sizes, [None] * ndim)


# ---------------------------------------------------------------------------
# Building sharded tensors
# ---------------------------------------------------------------------------


def local_slices(shape: tuple, sizes: dict[str, int], coord: dict[str, int],
                 spec: tuple) -> tuple[slice, ...]:
    """This rank's block of an array of ``shape`` under ``spec``, at mesh
    coordinate ``coord`` (axis name -> index): an entry of several axes
    splits its dim major-to-minor in the entry's order."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(0, dim))
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in group:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_tensor(t: torch.Tensor, mesh, plan: ShardPlan):
    """``t`` (the global array, the same on every rank) as a DTensor on
    ``mesh`` with ``plan``'s placements, built with ``DTensor.from_local``
    from this rank's block: no scatter, no broadcast, nothing sent. On the
    ``meta`` device the block is an empty meta tensor of the local shape."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    sl = local_slices(tuple(t.shape), sizes, coord, plan.spec)
    if t.device.type == "meta":
        local = torch.empty([s.stop - s.start for s in sl], dtype=t.dtype,
                            device="meta")
    else:
        local = t[sl].contiguous()
    return DTensor.from_local(local, mesh, plan.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_tree(params: Mapping[str, torch.Tensor], mesh,
               plan: Mapping[str, ShardPlan]) -> dict:
    """:func:`shard_tensor` of every leaf of a flat dict."""
    return {k: shard_tensor(v, mesh, plan[k]) for k, v in params.items()}


def shard_module(model: torch.nn.Module, mesh,
                 plan: Mapping[str, ShardPlan]) -> torch.nn.Module:
    """Replace each parameter of ``model`` (by state-dict name) with its
    DTensor under ``plan``, frozen as the port's parameters are; returns
    ``model``."""
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        sharded = shard_tensor(p.detach(), mesh, plan[name])
        owner.register_parameter(
            leaf, torch.nn.Parameter(sharded, requires_grad=False))
    return model
