"""The paper's technique as a framework feature, on the port: trace a
training step, extract its cross-block collective traffic as coflows over
the multi-core OCS pod interconnect, and plan the circuit schedule with
Algorithm 1 — printing the circuit program a Jupiter-style fabric manager
would install.

  PYTHONPATH=src python examples/torch_plan_circuits.py [--experts 8] [--device cpu]

The port of ``examples/plan_circuits.py``. The step of a demo MoE is
traced on ``meta`` DTensors over a fake (2, 2, 2) world of 8 ranks
(``launch.mesh.fake_world``), so it takes seconds and needs no cards; the
coflows are planned on CUDA unless ``--device cpu``. A fake process group
and an NCCL one cannot share a process, so this script runs in its own.
The production path (512 ranks) is ``python -m repro_torch.launch.dryrun``.
The last line is a JSON summary: the collectives, the coflows, their
inter-block megabytes and each algorithm's weighted CCT.
"""
import argparse
import json

import torch

from repro_torch.analysis.collectives import analyze_step
from repro_torch.comm import BlockMap, OCSFabric, plan_circuits, step_coflows
from repro_torch.configs import ShapeSpec, input_specs
from repro_torch.core import scheduled_flows
from repro_torch.distributed.sharding import (TRAIN_RULES, batch_spec,
                                              plan_tree, shard_module,
                                              shard_tree)
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.api import ModelConfig, build_model
from repro_torch.models.common import activation_sharding
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.step import build_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    fake_world(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = ModelConfig(name="demo-moe", family="moe", n_layers=4, d_model=256,
                      n_heads=8, n_kv_heads=4, d_ff=512, vocab=1024,
                      n_experts=args.experts, top_k=2)
    model = build_model(cfg, device="meta")
    shard_module(model, mesh, plan_tree(
        mesh, {k: p.detach() for k, p in model.named_parameters()},
        model.param_axes(cfg), TRAIN_RULES))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = init_opt_state(params)
    # the step counter is read on the host: a meta one has no value
    opt_state["step"] = torch.zeros((), dtype=torch.int32)
    specs = input_specs(cfg, ShapeSpec("demo", "train", 256, 16))
    batch = shard_tree(specs, mesh, {k: batch_spec(mesh, v.ndim, v.shape[0])
                                     for k, v in specs.items()})
    step = build_train_step(model, OptimizerConfig())
    with activation_sharding(mesh, TRAIN_RULES):
        analysis = analyze_step(step, params, opt_state, batch, mesh=mesh)
    print(f"collectives in the traced step: {analysis.collective_counts()}")

    bmap = BlockMap.from_mesh_shape({"pod": 2, "data": 2, "model": 2},
                                    ("pod", "data"))
    coflows = step_coflows(analysis, bmap)
    inter_mb = sum(c.total_bytes for c in coflows) / 1e6
    print(f"-> {len(coflows)} coflows over {bmap.n_blocks} aggregation "
          f"blocks, {inter_mb:.1f} MB inter-block")

    fabric = OCSFabric(rates=(25e9, 50e9), delta=1e-3)
    reports = plan_circuits(coflows, fabric, device=torch.device(args.device))
    base = reports["ours"].weighted_cct
    print(f"\n{'algorithm':14s} {'wCCT':>10s} {'makespan':>10s} {'norm':>6s}")
    for alg, r in reports.items():
        print(f"{alg:14s} {r.weighted_cct:9.4f}s {r.makespan:9.4f}s "
              f"{r.weighted_cct/base:5.2f}x")

    # the first few circuit establishments of OURS — the program the fabric
    # manager would install
    print("\nfirst 10 circuit establishments (OURS):")
    flows = sorted(scheduled_flows(reports["ours"].schedule),
                   key=lambda f: f.t_establish)
    for f in flows[:10]:
        print(f"  t={f.t_establish*1e3:7.2f}ms core={f.core} "
              f"block{f.i:2d} -> block{f.j:2d}  "
              f"{f.size/1e6:8.2f} MB  (coflow {f.cid})")
    out = {"device": args.device,
           "collectives": analysis.collective_counts(),
           "coflows": len(coflows), "blocks": bmap.n_blocks,
           "inter_block_mb": inter_mb,
           "weighted_cct": {alg: r.weighted_cct for alg, r in reports.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
