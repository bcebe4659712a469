"""Sharded training and serving of the hybrid, ssm, audio and vlm families
on 4 gloo ranks against the unsharded model.

One spawn of 4 processes on the CPU (a gloo group on a ``FileStore``
under the test's directory, one thread each) forms a ``(2, 2)`` ("data",
"model") mesh and takes each family's smoke config in fp32
(recurrentgemma-9b, xlstm-1.3b, seamless-m4t-large-v2, internvl2-76b):

  - training: 2 steps of ``train_loop(mesh=...)`` against rank 0's
    unsharded ``train_loop(device="cpu")``: the losses within 1e-5
    relative and every leaf of the fp32 master weights within 1e-5
    relative in the leaf's norm (as ``tests/test_torch_train_sharded.py``
    says why). ``PackedLoader`` yields tokens and labels only; for the
    audio and vlm families the loader is wrapped to add the batch's
    ``src_frames`` / ``prefix_embeds``, drawn from a generator seeded by
    the batch's step, as the reference's launcher leaves them to its
    caller;
  - serving: a prefill of 16 tokens and one decode step, planned by
    ``serve.engine.serve_shardings``, against the unsharded model on the
    same weights and inputs: the logits within 1e-5, and every cache field
    within 1e-5 relative to its norm (xLSTM's ``s_m`` stabiliser moves by
    about 1e-5 in absolute terms).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"hybrid": "recurrentgemma-9b", "ssm": "xlstm-1.3b",
         "audio": "seamless-m4t-large-v2", "vlm": "internvl2-76b"}

WORKER = textwrap.dedent("""
    import dataclasses, json, sys, warnings
    warnings.filterwarnings("ignore")
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def extras(cfg, b, s, seed):
        rng = np.random.default_rng(seed)
        if cfg.family == "audio":
            return {"src_frames": rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm":
            return {"prefix_embeds": rng.standard_normal(
                (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)}
        return {}

    def run(rank, tmp, archs):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", rank=rank, world_size=4,
                                store=dist.FileStore(tmp + "/store", 4))
        import repro_torch.launch.train as launch
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import (
            SERVE_RULES, batch_spec, shard_module, shard_tensor)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.api import build_model
        from repro_torch.models.common import activation_sharding
        from repro_torch.serve.engine import serve_shardings
        from repro_torch.train.optimizer import OptimizerConfig

        cfg_box = []

        class Loader(launch.PackedLoader):
            # the loader's batch, with the family's extra input
            def _make_batch(self, step):
                b = super()._make_batch(step)
                n, s = b["tokens"].shape
                return dict(b, **extras(cfg_box[0], n, s, 1000 + step))

        launch.PackedLoader = Loader
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        out = {}
        for arch in archs.split(","):
            cfg = dataclasses.replace(get_arch(arch).smoke,
                                      dtype=torch.float32)
            cfg_box[:] = [cfg]
            opt = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2)
            args = dict(steps=2, global_batch=8, seq_len=32, opt_cfg=opt,
                        log_every=0, seed=0)
            run_ = launch.train_loop(cfg, mesh=mesh, **args)
            master = {k: v.full_tensor()
                      for k, v in run_.opt_state["master"].items()}
            row = {"sharded": [h["loss"] for h in run_.history]}
            if rank == 0:
                ref = launch.train_loop(cfg, device="cpu", **args)

                def gap(a, b):
                    return float(torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b))

                row["plain"] = [h["loss"] for h in ref.history]
                row["master_err"] = {k: gap(master[k], v) for k, v in
                                     ref.opt_state["master"].items()}

            # serving
            def model():
                return build_model(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))

            g = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
            nxt = torch.randint(0, cfg.vocab, (4, 1), generator=g)
            extra = {k: torch.from_numpy(v)
                     for k, v in extras(cfg, 4, 8, 7).items()}
            kw = {"s_src": 8} if cfg.family == "audio" else {}
            s_max = 24 + cfg.n_prefix_tokens
            plain = model()
            cache = plain.make_caches(4, s_max, **kw)
            want_p, cache = plain.prefill(cache, dict(tokens=toks, **extra))
            want_d, cache = plain.decode_step(cache, nxt)

            sharded = model()
            scache = sharded.make_caches(4, s_max, **kw)
            p_plan, c_plan = serve_shardings(
                mesh, sharded, dict(sharded.named_parameters()),
                sharded.param_axes(cfg), scache)
            shard_module(sharded, mesh, p_plan)
            scache = type(scache)(*[shard_tensor(t, mesh, p)
                                    for t, p in zip(scache, c_plan)])
            sbatch = {k: shard_tensor(v, mesh, batch_spec(mesh, v.ndim, 4))
                      for k, v in dict(tokens=toks, **extra).items()}
            with activation_sharding(mesh, SERVE_RULES):
                got_p, scache = sharded.prefill(scache, sbatch)
                got_d, scache = sharded.decode_step(
                    scache, shard_tensor(nxt, mesh, batch_spec(mesh, 2, 4)))

            def whole(t):
                return t.full_tensor() if hasattr(t, "full_tensor") else t

            got = [whole(t) for t in (got_p, got_d, *scache)]
            if rank == 0:
                row["logits_gap"] = [float((a - b).abs().max()) for a, b in
                                     zip(got[:2], (want_p, want_d))]
                fields = {}
                for name, a, b in zip(cache._fields, got[2:], cache):
                    a, b = a.double(), b.double()
                    norm = float(torch.linalg.vector_norm(b))
                    fields[name] = [float(torch.linalg.vector_norm(a - b)),
                                    norm, float((a - b).abs().max())]
                row["cache"] = fields
                row["sharded_fields"] = sorted(
                    name for name, t in zip(scache._fields, scache)
                    if hasattr(t, "placements")
                    and any(p.is_shard() for p in t.placements))
                out[arch] = row
        if rank == 0:
            json.dump(out, open(tmp + "/out.json", "w"))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:]), nprocs=4)
""")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp), ",".join(ARCHS.values())],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_training_matches_unsharded(families, family):
    r = families[ARCHS[family]]
    assert len(r["sharded"]) == 2
    for a, b in zip(r["sharded"], r["plain"]):
        assert abs(a - b) <= 1e-5 * abs(b), (r["sharded"], r["plain"])
    worst = max(r["master_err"], key=r["master_err"].get)
    assert r["master_err"][worst] <= 1e-5, (worst, r["master_err"])


@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_serving_matches_unsharded(families, family):
    r = families[ARCHS[family]]
    assert max(r["logits_gap"]) <= 1e-5, r["logits_gap"]
    for name, (diff, norm, _) in r["cache"].items():
        assert diff <= 1e-5 * norm, (name, r["cache"][name])
    assert r["sharded_fields"], "no cache field was split"
