"""Multi-pod dry run: trace every cell of a production mesh without
allocating.

Port of ``repro.launch.dryrun``. For every (architecture x input shape)
cell and each production mesh (single pod 16x16, multi pod 2x16x16), build
the step's model, parameters, optimizer state, cache and batch as DTensors
of ``meta`` tensors (shapes and dtypes, no storage), planned by the
sharding rules, and run the train, prefill or decode step once under a
fake process group (``launch.mesh.fake_world``: collectives return at once
and move nothing). ``meta`` tensors are the reference's own no-allocation
semantics (its ``ShapeDtypeStruct`` inputs to ``jit(...).lower``), not a
fallback to the CPU. Each cell records:

  - the per-rank argument bytes (the local shards of the parameters,
    optimizer state, cache and batch), against the card's 80 GB;
  - a peak estimate: the step run once more on its ``meta`` DTensors with
    ``torch.distributed._tools.mem_tracker.MemTracker`` tracking the model
    and this rank's blocks of the other arguments; the sum over devices
    of its per-device peaks (``meta`` stands for the card). It runs
    without ``FakeTensorMode``: under it, DTensor's local ops are counted
    short (27% short of the real step on torch 2.11, 4% on 2.13, at
    TinyLlama's 1x1 training step), while on ``meta`` tensors the tracker
    gives what it gives on the real step. Where ``MemTracker`` fails it is
    ``None`` and ``peak_note`` says why;
  - the collective analysis (``analysis.collectives.analyze_step``) and the
    roofline terms.

The process holds the fake group of 256 or 512 ranks, so it cannot hold an
NCCL group too: run the dry run in a process of its own.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import time
import traceback

import torch

from ..analysis.collectives import analyze_step
from ..analysis.roofline import model_flops, roofline_terms
from ..configs import SHAPES, cache_specs, get_arch, input_specs
from ..configs.registry import ARCHS
from ..distributed.sharding import (SERVE_RULES, TRAIN_RULES, batch_spec,
                                    plan_tree, shard_module, shard_tensor,
                                    shard_tree)
from ..models.api import ModelConfig, build_model
from ..models.common import activation_sharding
from ..serve.engine import serve_shardings
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.step import build_train_step
from .mesh import fake_world, make_production_mesh

__all__ = ["lower_cell", "run_matrix", "main"]

# how far the estimate may lie from a real step's max_memory_allocated:
# chip_smoke.py's phase 17(a) fails outside it
PEAK_TOL = 0.15
PEAK_NOTE = ("MemTracker on the step's meta DTensors: the sum over devices "
             "of the per-device peaks, tracking the model and this rank's "
             "blocks of its arguments; held on the card within "
             f"{PEAK_TOL:.0%} of max_memory_allocated for TinyLlama-1.1B's "
             "train step on a 1x1 mesh only (chip_smoke.py phase 17a)")


def _locals(tree) -> list:
    """This rank's blocks of every tensor in a (nested) dict, list or
    NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if hasattr(tree, "to_local") else tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def _peak(step, args, model, mesh, rules) -> tuple[int | None, str]:
    """``(peak bytes, note)`` of ``step(*args)`` by ``MemTracker``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    try:
        tracker = MemTracker()
        tracker.track_external(model, *_locals(args))
        with tracker, activation_sharding(mesh, rules):
            step(*args)
        peak = tracker.get_tracker_snapshot("peak")
        return int(sum(dev["Total"] for dev in peak.values())), PEAK_NOTE
    except Exception as e:  # recorded in the row, with the reason
        return None, f"MemTracker failed: {type(e).__name__}: {e}"


def _batch(mesh, specs: dict) -> dict:
    return shard_tree(specs, mesh, {k: batch_spec(mesh, v.ndim, v.shape[0])
                                    for k, v in specs.items()})


def lower_cell(arch_id, shape_name, mesh, mesh_name: str, *,
               remat: str = "full", microbatches: int = 1) -> dict:
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` over a fake world);
    returns a result dict (or raises). The analysis itself is under
    ``"analysis"`` (not JSON: the caller plans its coflows).

    ``arch_id`` is a registered architecture or a ``ModelConfig`` (a
    config cut to size), and ``shape_name`` a name of ``SHAPES`` or a
    ``ShapeSpec`` (small cells for tests). A train cell's step accumulates
    over ``microbatches`` (``build_train_step``'s)."""
    cfg = arch_id if isinstance(arch_id, ModelConfig) \
        else get_arch(arch_id).config
    arch_id = cfg.name if isinstance(arch_id, ModelConfig) else arch_id
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    if shape.kind == "train" and remat != cfg.remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    model = build_model(cfg, device="meta")
    params_abs = {k: p.detach() for k, p in model.named_parameters()}
    axes = model.param_axes(cfg)
    chips = mesh.size()

    t0 = time.time()
    batch = _batch(mesh, input_specs(cfg, shape))
    if shape.kind == "train":
        shard_module(model, mesh, plan_tree(mesh, params_abs, axes,
                                            TRAIN_RULES))
        params = {k: p.detach() for k, p in model.named_parameters()}
        opt_state = init_opt_state(params)
        # the step counter is read on the host (lr_at): a meta one has no
        # value to read
        opt_state["step"] = torch.zeros((), dtype=torch.int32)
        step = build_train_step(model, OptimizerConfig(),
                                microbatches=microbatches)
        args = (params, opt_state, batch)
        state_bytes = _nbytes(args)
        rules = TRAIN_RULES
    else:
        cache_abs = cache_specs(cfg, shape)
        p_sh, c_sh = serve_shardings(mesh, model, params_abs, axes, cache_abs)
        shard_module(model, mesh, p_sh)
        cache = type(cache_abs)(*[shard_tensor(t, mesh, pl)
                                  for t, pl in zip(cache_abs, c_sh)])
        if shape.kind == "prefill":
            # the cell's prefill starts from an empty cache; a model that
            # reads the cache's length to know it is told instead (a meta
            # tensor has no value to read)
            fresh = {"fresh": True} if "fresh" in inspect.signature(
                model.prefill).parameters else {}

            def step(c, b):
                return model.prefill(c, b, **fresh)

            args = (cache, batch)
        else:
            step = model.decode_step
            args = (cache, batch["tokens"])
        state_bytes = _nbytes([dict(model.named_parameters()), args])
        rules = SERVE_RULES
    with activation_sharding(mesh, rules):
        analysis = analyze_step(step, *args, mesh=mesh)
    t_trace = time.time() - t0
    peak, note = _peak(step, args, model, mesh, rules)

    terms = roofline_terms(arch_id, shape_name, mesh_name, chips, analysis,
                           model_flops(cfg, shape))
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "status": "ok", "trace_s": round(t_trace, 2),
        "memory": {"argument_bytes": state_bytes,
                   "peak_estimate_bytes": peak, "peak_note": note},
        "roofline": terms.row(),
        "analysis": analysis,
    }


def run_matrix(arch_ids, shape_names, meshes, *, out_path=None,
               remat="full"):
    """Every (arch x shape x mesh) cell; ``status: fail`` rows are kept.
    Starts the fake world of the largest mesh asked for."""
    results = []
    fake_world(512 if "multi" in meshes else 256)
    mesh_objs = {m: make_production_mesh(multi_pod=(m == "multi"))
                 for m in meshes}
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        for shape_name in shape_names:
            ok, reason = arch.supports(SHAPES[shape_name])
            if not ok:
                results.append({"arch": arch_id, "shape": shape_name,
                                "status": "skip", "reason": reason})
                print(f"[skip] {arch_id} x {shape_name}: {reason}")
                continue
            for mname, mesh in mesh_objs.items():
                tag = f"{arch_id} x {shape_name} x {mname}"
                try:
                    r = lower_cell(arch_id, shape_name, mesh, mname,
                                   remat=remat)
                    r.pop("analysis")
                    results.append(r)
                    rf = r["roofline"]
                    print(f"[ok]   {tag}: trace={r['trace_s']}s "
                          f"args={r['memory']['argument_bytes'] / 2**30:.2f}"
                          f"GiB/rank dom={rf['dominant']} "
                          f"terms=({rf['compute_s']:.4f},"
                          f"{rf['memory_s']:.4f},"
                          f"{rf['collective_s']:.4f})s "
                          f"roofline_frac={rf['roofline_fraction']:.3f}")
                except Exception as e:  # a failure here is a bug in the port
                    results.append({"arch": arch_id, "shape": shape_name,
                                    "mesh": mname, "status": "fail",
                                    "error": f"{type(e).__name__}: {e}"})
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                    traceback.print_exc()
                if out_path:
                    with open(out_path, "w") as fh:
                        json.dump(results, fh, indent=1, default=str)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch_ids = list(ARCHS) if (args.all or not args.arch) else args.arch
    shape_names = list(SHAPES) if (args.all or not args.shape) else args.shape
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    results = run_matrix(arch_ids, shape_names, meshes,
                         out_path=args.out, remat=args.remat)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_fail = sum(1 for r in results if r.get("status") == "fail")
    n_skip = sum(1 for r in results if r.get("status") == "skip")
    print(f"\n=== dry-run matrix: {n_ok} ok, {n_fail} FAIL, {n_skip} skip ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
