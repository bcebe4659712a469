"""Sharded serving on 4 gloo ranks against the unsharded model.

Each case spawns 4 processes on the CPU that start a gloo group on a
``FileStore`` under ``tmp_path`` and form a ``(2, 2)`` ``("data",
"model")`` mesh. Every rank builds the same fp32 dense model and cache,
plans them with ``serve.engine.serve_shardings`` (``SERVE_RULES``: TP over
"model", the batch over "data"), shards them with ``shard_module`` /
``shard_tensor`` and runs a prefill of 16 tokens and one decode step under
``activation_sharding``; rank 0 holds the logits, the written K cache and
the slot positions to the unsharded model's on the same weights and
tokens. Two kv-head counts: 2 divides the model axis (the cache splits its
kv heads), 1 does not (the cache splits its sequence, the ``seq_sharded``
fallback, and each rank writes only the slots of its block).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store_path, kv_heads, out_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", rank=rank, world_size=4,
                                store=dist.FileStore(store_path, 4))
        from repro_torch.distributed.sharding import (
            SERVE_RULES, batch_spec, shard_module, shard_tensor)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.api import ModelConfig, build_model
        from repro_torch.models.common import activation_sharding
        from repro_torch.serve.engine import serve_shardings

        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        cfg = ModelConfig(name="s", family="dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=int(kv_heads), d_ff=96,
                          vocab=128, dtype=torch.float32)

        def model():
            return build_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(0))

        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, 128, (4, 16), generator=g)
        nxt = torch.randint(0, 128, (4, 1), generator=g)
        plain = model()
        cache = plain.make_caches(4, 24)
        want_p, cache = plain.prefill(cache, {"tokens": toks})
        want_d, cache = plain.decode_step(cache, nxt)

        sharded = model()
        scache = sharded.make_caches(4, 24)
        p_plan, c_plan = serve_shardings(
            mesh, sharded, dict(sharded.named_parameters()),
            sharded.param_axes(cfg), scache)
        shard_module(sharded, mesh, p_plan)
        scache = type(scache)(*[shard_tensor(t, mesh, p)
                                for t, p in zip(scache, c_plan)])
        rows = batch_spec(mesh, 2, 4)
        with activation_sharding(mesh, SERVE_RULES):
            got_p, scache = sharded.prefill(
                scache, {"tokens": shard_tensor(toks, mesh, rows)})
            got_d, scache = sharded.decode_step(
                scache, shard_tensor(nxt, mesh, rows))
        got = [t.full_tensor() for t in (got_p, got_d, scache.k,
                                         scache.positions)]
        if rank == 0:
            gap = [float((a - b).abs().max()) for a, b in zip(
                got[:3], (want_p, want_d, cache.k))]
            json.dump({"gap": gap, "k_spec": str(c_plan.k.spec),
                       "positions": torch.equal(got[3], cache.positions)},
                      open(out_path, "w"))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:]), nprocs=4)
""")


@pytest.mark.parametrize("kv_heads, split", [(2, "kv_heads"), (1, "seq")])
def test_sharded_serving_matches_unsharded(tmp_path, kv_heads, split):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store"), str(kv_heads),
         str(out)], capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(out.read_text())
    # the cache is split where the policy says: dims (layers, batch, seq,
    # kv_heads, head_dim)
    want_spec = {"kv_heads": "(None, 'data', None, 'model', None)",
                 "seq": "(None, 'data', 'model', None, None)"}[split]
    assert r["k_spec"] == want_spec
    assert r["positions"]
    assert max(r["gap"]) <= 1e-5, r["gap"]
