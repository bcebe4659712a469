"""The port's dry run and collective analysis on a fake (2, 2, 2) mesh.

The traces run in three fresh processes (a fake process group is one per
process), each of which starts ``launch.mesh.fake_world(8)`` and traces on
``meta`` DTensors with its own time limit: the three train steps and their
plans; a forward pass, ``lower_cell``'s three cells, the hand-countable
step and the smoke decode cell; the 1x1 peak estimate. The JAX comparison
runs in a fourth:

  - the tiny dense model and the tiny MoE of the reference's
    ``test_planner_on_compiled_step`` yield collectives, coflows, bytes
    and a positive weighted CCT for ``ours`` and ``rand-sunflow``: that
    test's own assertions, which fail in the reference;
  - trip counts: a 2-layer and a 4-layer dense model of equal widths give
    the same folded collective list, the per-layer ops with ``trip_mult``
    2 against 4;
  - an FSDP all-gather has the local shard's operand bytes, group size 2
    and all four data groups of the mesh;
  - the per-rank matmul FLOPs of a forward pass, times 8, equal a hand
    count of the model's products;
  - ``lower_cell`` runs a train, a prefill and a decode cell, each with a
    peak-memory estimate at least its arguments' bytes and a finite
    memory term;
  - the memory term of a hand-countable step (one product and one add on
    a 2x2 mesh) is exactly its operand and result bytes, and a TinyLlama
    smoke decode cell names memory dominant;
  - the peak estimate of a 1x1 train cell (2 microbatches) equals
    MemTracker's peak of the same step on real CPU tensors;
  - ``shard_tree``'s local blocks on (2, 2, 2), rank by rank, equal JAX's
    ``NamedSharding.devices_indices_map`` (8 host devices).
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import hw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import json, warnings
    warnings.filterwarnings("ignore")
    import torch
    torch.set_num_threads(1)
    from repro_torch.analysis.collectives import analyze_step
    from repro_torch.comm import BlockMap, plan_circuits, step_coflows
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models.api import ModelConfig

    fake_world(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    bmap = BlockMap.from_mesh_shape({"pod": 2, "data": 2, "model": 2})
    TRAIN = ShapeSpec("t64", "train", 64, 8)

    def tiny(family="dense", n_layers=2, **kw):
        if family == "moe":
            kw.update(n_experts=4, top_k=2)
        return ModelConfig(name="m", family=family, n_layers=n_layers,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                           vocab=128, **kw)

    def ops(an):
        return [[c.kind, c.operand_bytes, c.result_bytes, c.group_size,
                 c.trip_mult, c.metadata] for c in an.collectives]
""")


#: Each subprocess's time limit, at least 4x its time alone with
#: OMP_NUM_THREADS=1 (the longer of two timings: steps 47.0 s, cells
#: 39.6 s, peak 18.4 s, the JAX comparison 7.3 s), so that a loaded
#: parallel run does not cut it.
STEPS_TIMEOUT, CELLS_TIMEOUT, PEAK_TIMEOUT, JAX_TIMEOUT = 240, 180, 120, 120


def _run(body: str, env_extra=None, *, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c", body], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


STEPS = PRELUDE + textwrap.dedent("""
    out = {"ops": {}, "plan": {}}
    for family, L in (("dense", 2), ("dense", 4), ("moe", 2)):
        an = lower_cell(tiny(family, L), TRAIN, mesh, "2x2x2")["analysis"]
        out["ops"][f"{family}{L}"] = ops(an)
        if L == 2:
            cfs = step_coflows(an, bmap)
            reports = plan_circuits(cfs, device="cpu")
            out["plan"][family] = {
                "n_coll": sum(an.collective_counts().values()),
                "n_coflows": len(cfs),
                "bytes": sum(c.total_bytes for c in cfs),
                "ours": reports["ours"].weighted_cct,
                "rand_sunflow": reports["rand-sunflow"].weighted_cct}
    print(json.dumps(out))
""")

CELLS = PRELUDE + textwrap.dedent("""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (
        TRAIN_RULES, batch_spec, plan_tree, shard_module, shard_tensor)
    from repro_torch.models.api import build_model
    from repro_torch.models.common import activation_sharding

    out = {"cells": {}}
    # the matmul FLOPs of a forward pass
    cfg = tiny()
    model = build_model(cfg, device="meta")
    shard_module(model, mesh, plan_tree(
        mesh, dict(model.named_parameters()), model.param_axes(cfg),
        TRAIN_RULES))
    toks = torch.empty((8, 64), dtype=torch.int32, device="meta")
    batch = {k: shard_tensor(toks, mesh, batch_spec(mesh, 2, 8))
             for k in ("tokens", "labels")}
    with torch.no_grad(), activation_sharding(mesh, TRAIN_RULES):
        out["forward_flops"] = analyze_step(model.loss, batch,
                                            mesh=mesh).flops

    for kind, shape in (("prefill", ShapeSpec("p", "prefill", 64, 8)),
                        ("decode", ShapeSpec("d", "decode", 64, 8)),
                        ("train", TRAIN)):
        row = lower_cell(tiny(), shape, mesh, "2x2x2")
        an = row.pop("analysis")
        out["cells"][kind] = {"status": row["status"],
                              "args": row["memory"]["argument_bytes"],
                              "peak": row["memory"]["peak_estimate_bytes"],
                              "counts": an.collective_counts(),
                              "flops": an.flops, "roofline": row["roofline"]}
    # one product and one add, per rank: x (4, 16) @ w (16, 32) -> y
    # (4, 32), then y + y
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh22 = make_mesh((2, 2), ("data", "model"))
    x = DTensor.from_local(torch.empty((4, 16), device="meta"), mesh22,
                           (Shard(0), Replicate()), run_check=False,
                           shape=(8, 16), stride=(16, 1))
    w = DTensor.from_local(torch.empty((16, 32), device="meta"), mesh22,
                           (Replicate(), Replicate()), run_check=False)

    def hand(x, w):
        y = x @ w
        return y + y

    out["hand_bytes"] = analyze_step(hand, x, w, mesh=mesh22).hbm_bytes

    smoke = get_arch("tinyllama-1.1b").smoke
    row = lower_cell(smoke, ShapeSpec("d", "decode", 64, 8), mesh, "2x2x2")
    row.pop("analysis")
    out["smoke_decode"] = row["roofline"]
    print(json.dumps(out))
""")

PEAK = PRELUDE + textwrap.dedent("""
    # the peak estimate of a 1x1 train cell (2 microbatches, "chunked")
    # against MemTracker on the same step of real CPU tensors, unsharded
    import dataclasses
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import build_train_step
    out = {}
    small = dataclasses.replace(tiny(), attention_impl="chunked", n_layers=2,
                                vocab=512)
    mesh11 = make_mesh((1, 1), ("data", "model"))
    row = lower_cell(small, ShapeSpec("p", "train", 2048, 4), mesh11, "1x1",
                     remat=small.remat_policy, microbatches=2)
    out["peak_estimate"] = row["memory"]["peak_estimate_bytes"]
    real = build_model(small, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in real.named_parameters()}
    opt = init_opt_state(params)
    toks = torch.zeros((4, 2048), dtype=torch.int32)
    tracker = MemTracker()
    tracker.track_external(real, *params.values(), *(
        t for g in ("master", "m", "v") for t in opt[g].values()), toks,
        toks)
    with tracker:
        build_train_step(real, OptimizerConfig(), microbatches=2)(
            params, opt, {"tokens": toks, "labels": toks})
    out["peak_real"] = sum(d["Total"] for d in
                           tracker.get_tracker_snapshot("peak").values())
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def steps():
    """The three traced train steps (dense 2 and 4 layers, MoE) with their
    ops and plans, in one fresh process."""
    return _run(STEPS, timeout=STEPS_TIMEOUT)


@pytest.fixture(scope="module")
def cells():
    """A forward pass's FLOPs, ``lower_cell``'s three cells, the
    hand-countable step and the smoke decode cell, in one fresh process."""
    return _run(CELLS, timeout=CELLS_TIMEOUT)


@pytest.fixture(scope="module")
def peak():
    """The 1x1 peak estimate and MemTracker's real peak, in one fresh
    process."""
    return _run(PEAK, timeout=PEAK_TIMEOUT)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_planner_on_traced_step(steps, family):
    r = steps["plan"][family]
    assert r["n_coll"] > 0 and r["n_coflows"] > 0 and r["bytes"] > 0
    assert r["ours"] > 0 and r["rand_sunflow"] > 0


def test_layer_collectives_fold_into_trip_counts(steps):
    two, four = steps["ops"]["dense2"], steps["ops"]["dense4"]
    assert len(two) == len(four)
    layered = 0
    for a, b in zip(two, four):
        assert a[:4] + a[5:] == b[:4] + b[5:]
        assert (a[4], b[4]) in ((1, 1), (2, 4))
        layered += a[4] == 2
    assert layered > 0


def test_fsdp_all_gather_has_the_local_shard_and_every_data_group(steps):
    data_groups = "{{0,2},{1,3},{4,6},{5,7}}"
    # blocks.wq of one layer, (64, 4 x 16) bf16: (32, 32) per rank, gathered
    # over "data" (its FSDP dim), split over "model"
    local = 32 * 32 * 2
    got = steps["ops"]["dense2"]
    hits = [o for o in got if o[0] == "all-gather" and o[1] == local
            and o[2] == 2 * local and o[3] == 2 and o[5] == data_groups]
    assert hits, got
    assert all(o[4] == 2 for o in hits)  # once per layer, folded


def test_matmul_flops_per_rank_times_ranks_equal_a_hand_count(cells):
    B, S, D, H, KVH, Dh, F, V, L = 8, 64, 64, 4, 2, 16, 96, 128, 2
    per_layer = (2 * B * S * D * H * Dh          # q
                 + 2 * 2 * B * S * D * KVH * Dh  # k, v
                 + 2 * 2 * B * H * S * S * Dh    # scores, probs @ v
                 + 2 * B * S * H * Dh * D        # o
                 + 3 * 2 * B * S * D * F)        # gate, up, down
    assert cells["forward_flops"] * 8 == L * per_layer + 2 * B * S * D * V


def test_lower_cell_train_prefill_decode(cells):
    for kind in ("train", "prefill", "decode"):
        cell = cells["cells"][kind]
        assert cell["status"] == "ok" and cell["args"] > 0, kind
        # MemTracker's peak holds the arguments it tracks, and more
        assert cell["peak"] is not None and cell["peak"] >= cell["args"]
        assert sum(cell["counts"].values()) > 0 and cell["flops"] > 0, kind
        rf = cell["roofline"]
        assert math.isfinite(rf["memory_s"]) and rf["memory_s"] > 0, kind
        assert rf["memory_s"] == rf["hlo_bytes_per_chip"] / hw.HBM_BW
        assert rf["compute_s"] > 0 and rf["collective_s"] > 0
        terms = {k: rf[f"{k}_s"] for k in ("compute", "memory",
                                            "collective")}
        assert rf["dominant"] == max(terms, key=terms.get)
    assert cells["cells"]["train"]["counts"].get("reduce-scatter", 0) > 0


def test_memory_term_of_a_hand_countable_step(cells):
    """Per rank: the product reads x (4, 16) and w (16, 32) and writes y
    (4, 32); the add reads y twice and writes its sum; fp32."""
    mm = (4 * 16 + 16 * 32 + 4 * 32) * 4
    add = 3 * 4 * 32 * 4
    assert cells["hand_bytes"] == mm + add


def test_peak_estimate_is_the_real_steps(peak):
    """The estimate runs MemTracker on the step's meta DTensors; on the
    CPU it gives what MemTracker gives on the same step of real tensors
    (under ``FakeTensorMode`` it counted DTensor's local ops short)."""
    assert peak["peak_estimate"] == pytest.approx(peak["peak_real"],
                                                    rel=1e-3)


def test_decode_cell_is_memory_bound(cells):
    """A decode step reads every weight and the cache for one token a
    sequence: the memory term dominates, and the bound is that term."""
    rf = cells["smoke_decode"]
    assert rf["dominant"] == "memory"
    assert rf["memory_s"] > max(rf["compute_s"], rf["collective_s"])
    useful = rf["model_flops_global"] / (rf["chips"] * hw.PEAK_FLOPS_BF16)
    assert rf["roofline_fraction"] == pytest.approx(useful / rf["memory_s"])


def test_local_blocks_equal_jax_devices_indices_map():
    body = textwrap.dedent("""
        import json, warnings
        warnings.filterwarnings("ignore")
        import jax, numpy as np
        import torch
        import torch.distributed as dist
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from repro_torch.distributed.sharding import (
            TRAIN_RULES, batch_spec, plan_sharding, shard_tree)
        from repro_torch.launch.mesh import fake_world, make_mesh

        axes = ("pod", "data", "model")
        jmesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), axes)
        sizes = dict(zip(axes, (2, 2, 2)))
        arrays = {
            "wq": ((2, 8, 16), ("layers", "embed", "heads_flat")),
            "experts": ((2, 4, 8, 6), ("layers", "experts", "embed", "mlp")),
            "embed": ((16, 8), ("vocab", "embed")),
        }
        glob = {k: torch.arange(np.prod(s), dtype=torch.float32).reshape(s)
                for k, (s, _) in arrays.items()}
        plans = {k: plan_sharding(sizes, s, a, TRAIN_RULES)
                 for k, (s, a) in arrays.items()}
        glob["batch"] = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
        plans["batch"] = batch_spec(sizes, 2, 16)
        bad = []
        for rank in range(8):
            fake_world(8, rank=rank)
            mesh = make_mesh((2, 2, 2), axes, device_type="cpu")
            local = shard_tree(glob, mesh, plans)
            for k, t in local.items():
                idx = NamedSharding(jmesh, P(*plans[k].spec)) \\
                    .devices_indices_map(tuple(glob[k].shape))[
                        jax.devices()[rank]]
                want = glob[k].numpy()[idx]
                if not np.array_equal(t.to_local().numpy(), want):
                    bad.append([rank, k])
            dist.destroy_process_group()
        print(json.dumps({"bad": bad,
                          "specs": {k: str(p.spec) for k, p in plans.items()}}))
    """)
    r = _run(body, {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                    "JAX_PLATFORMS": "cpu"}, timeout=JAX_TIMEOUT)
    assert r["bad"] == [], r
    assert "('pod', 'data')" in r["specs"]["batch"]
