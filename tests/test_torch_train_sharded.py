"""``train_loop(mesh=)`` on 4 gloo ranks against the unsharded loop.

Each case spawns 4 processes on the CPU that start a gloo group on a
``FileStore`` under ``tmp_path`` (no TCP port: the suite runs in parallel
workers) and form a ``(2, 2)`` ``("data", "model")`` mesh. Every rank trains
the same config for 2 steps with ``train_loop(mesh=...)`` (and for 1, to
check that the second step ran on the first step's weights, bit for bit);
rank 0 then trains it unsharded with ``train_loop(device="cpu")`` and
compares. In fp32 (dense and MoE): the losses within 1e-5 relative, and
every leaf of the fp32 master weights (the parameters the optimizer keeps;
``apply_updates`` hands back their bf16 cast, as the reference does)
within 1e-5 relative in the leaf's norm. The norm, not the largest entry:
AdamW divides each gradient by its own magnitude, so a last-bit
difference in a near-zero gradient (the sharded step sums in another
order) moves that one entry by up to the learning rate. In bf16 (dense:
the model's parameters take the step's bf16 output as they are, a path
of its own) at ``BF16_TOL``. The subprocess has a timeout; the ranks exit
on their own.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: bf16 (loss, master weights): the sharded step rounds its products to
#: bf16 after summing in another order, and AdamW turns a near-zero
#: gradient's rounding into a whole step of the learning rate.
BF16_TOL = (1e-3, 2e-2)

WORKER = textwrap.dedent("""
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, family, dtype, out_path):
        dist.init_process_group("gloo", rank=rank, world_size=4,
                                store=dist.FileStore(store_path, 4))
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import train_loop
        from repro_torch.models.api import ModelConfig
        from repro_torch.train.optimizer import OptimizerConfig

        kw = dict(n_experts=4, top_k=2) if family == "moe" else {}
        cfg = ModelConfig(name="t", family=family, n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=96, vocab=128,
                          vocab_pad_to=136, dtype=getattr(torch, dtype),
                          **kw)
        opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2)
        args = dict(steps=2, global_batch=8, seq_len=32, opt_cfg=opt,
                    log_every=0, seed=0)
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        one = train_loop(cfg, mesh=mesh, **dict(args, steps=1))
        run = train_loop(cfg, mesh=mesh, **args)
        # the second step ran on the first step's weights
        stale = [k for k, p in run.model.named_parameters()
                 if not torch.equal(p.full_tensor(),
                                    one.params[k].full_tensor().to(p.dtype))]
        master = {k: v.full_tensor()
                  for k, v in run.opt_state["master"].items()}
        placements = {k: str(v.placements) for k, v in run.params.items()}
        if rank == 0:
            ref = train_loop(cfg, device="cpu", **args)

            def gap(a, b):
                return float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))

            err = {k: gap(master[k], v)
                   for k, v in ref.opt_state["master"].items()}
            json.dump({"sharded": [h["loss"] for h in run.history],
                       "plain": [h["loss"] for h in ref.history],
                       "master_err": err, "placements": placements,
                       "stale": stale},
                      open(out_path, "w"))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:]), nprocs=4)
""")


@pytest.mark.parametrize("family, dtype", [
    ("dense", "float32"), ("moe", "float32"), ("dense", "bfloat16")])
def test_sharded_train_loop_matches_unsharded(tmp_path, family, dtype):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store"), family,
         dtype, str(out)], capture_output=True, text=True, env=env,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(out.read_text())
    assert len(r["sharded"]) == 2
    # the weights really were split: FSDP over data, TP over model
    assert "Shard" in r["placements"]["blocks.wq"]
    assert r["stale"] == []
    loss_tol, master_tol = (1e-5, 1e-5) if dtype == "float32" else BF16_TOL
    for a, b in zip(r["sharded"], r["plain"]):
        assert abs(a - b) <= loss_tol * abs(b), (r["sharded"], r["plain"])
    worst = max(r["master_err"], key=r["master_err"].get)
    assert r["master_err"][worst] <= master_tol, (worst, r["master_err"])
