"""The port's ``ElasticTrainer`` against the reference, on the CPU.

  - On 4 gloo ranks (spawned on a ``FileStore`` under the test's
    directory, one thread each) falling back to 2: the assertions of the
    reference's ``test_elastic_trainer_survives_device_loss``
    (``tests/test_distributed.py:180-238``: 20 steps, ``device-loss`` and
    ``shrink`` events, a finite last loss), which that test's own run
    cannot reach on this JAX (ROADMAP queue 3); the survivors resume from
    the last checkpoint onto the smaller mesh's shardings, and the dropped
    ranks leave ``run`` with no state; a chain whose smaller mesh does not
    keep mesh 0's first rank, the checkpoint writer, is refused.
  - The fabric wiring, differentially: ``tests/test_fault_differential.py::
    test_elastic_trainer_shrinks_mesh_and_circuit_plane_together`` replayed
    on both packages, the port's ``FabricManager`` on the CPU, with the
    events (cores, aborted, requeued) and the flushed programs equal array
    for array, and the three ``ValueError`` cases.
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import repro.core.coflow as ref_coflow
import repro.distributed.fault as ref_fault
import repro.service as ref_service
import repro_torch.core as port
import repro_torch.distributed.fault as port_fault
import repro_torch.service as port_service
from test_torch_service import assert_same_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = (10.0, 20.0, 30.0)

WORKER = textwrap.dedent("""
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", rank=rank, world_size=4,
                                store=dist.FileStore(tmp + "/store", 4))
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.distributed.fault import DeviceLoss, ElasticTrainer
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import elastic_build
        from repro_torch.models.api import ModelConfig
        from repro_torch.train.optimizer import OptimizerConfig

        cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                          n_heads=2, n_kv_heads=2, d_ff=64, vocab=61,
                          dtype=torch.float32)
        meshes = [make_mesh((2, 2), ("data", "model"), device_type="cpu"),
                  DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                             mesh_dim_names=("data", "model"))]
        build = elastic_build(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1))
        tail = DeviceMesh("cpu", torch.arange(2, 4).reshape(2, 1),
                          mesh_dim_names=("data", "model"))
        try:  # its writer (rank 2) is not mesh 0's (rank 0)
            ElasticTrainer(build, [meshes[0], tail], tmp + "/no")
            refused = None
        except ValueError as e:
            refused = str(e)
        tr = ElasticTrainer(build, meshes, tmp + "/ckpt", ckpt_every=5)

        def batches():
            rng = np.random.default_rng(9)
            while True:
                yield {"tokens": rng.integers(0, 61, (8, 16), dtype=np.int32),
                       "labels": rng.integers(0, 61, (8, 16), dtype=np.int32)}

        fired = []

        def inject(step):
            if step == 12 and not fired:
                fired.append(1)
                raise DeviceLoss(2)

        state, step, hist = tr.run(batches(), max_steps=20, inject=inject)
        tr.ckpt.wait(meshes[1] if rank < 2 else None)
        row = {"refused": refused,
               "steps": step, "events": tr.events, "n_hist": len(hist),
               "losses": [h["loss"] for h in hist],
               "state": None if state is None else sorted(
                   {str(v.placements) + str(tuple(v.device_mesh.mesh.shape))
                    for v in state["params"].values()})}
        json.dump(row, open(f"{tmp}/rank{rank}.json", "w"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4)
""")


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(tmp)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(4)]


def test_elastic_trainer_survives_device_loss(elastic):
    """The reference test's assertions, on every surviving rank."""
    for r in elastic[:2]:
        assert r["steps"] == 20
        assert any(e["event"] == "device-loss" for e in r["events"])
        assert any(e["event"] == "shrink" for e in r["events"])
        assert np.isfinite(r["losses"][-1])
    assert elastic[0]["losses"] == elastic[1]["losses"]


def test_survivors_resume_from_the_last_checkpoint_on_the_smaller_mesh(
        elastic):
    r = elastic[0]
    loss, shrink = r["events"]
    assert loss == {"event": "device-loss", "step": 12, "lost": 2}
    assert shrink == {"event": "shrink", "to": {"data": 2, "model": 1}}
    # 12 steps, then steps 11-20 again from step 10's checkpoint
    assert r["n_hist"] == 12 + 10
    # the state lives on the 2 x 1 mesh, split over "data" somewhere
    assert all(s.endswith("(2, 1)") for s in r["state"])
    assert any("Shard" in s for s in r["state"])


def test_dropped_ranks_leave_run_without_state(elastic):
    for r in elastic[2:]:
        assert r["state"] is None
        assert r["steps"] == 12 and r["n_hist"] == 12
        assert [e["event"] for e in r["events"]] == ["device-loss", "shrink"]
    # until the loss every rank took the same steps
    assert elastic[2]["losses"] == elastic[0]["losses"][:12]


def test_chain_must_keep_its_checkpoint_writer(elastic):
    """A smaller mesh that does not start with mesh 0's first rank would
    read checkpoints that a dropped rank may still be writing."""
    for r in elastic:
        assert r["refused"] == ("mesh 1 starts with rank 2, not rank 0, the "
                                "first rank of mesh 0, which writes the "
                                "checkpoints")


# ------------------------------------------------------------- fabric wiring

def _ref_fabric():
    mgr = ref_service.FabricManager(ref_service.FabricConfig(
        rates=RATES, delta=8.0, N=6))
    mgr.submit(ref_coflow.Coflow(cid=0, demand=np.eye(6) * 50.0), 1.0)
    mgr.tick(2.0)  # commit some circuits so the shrink has work to abort
    return mgr


def _port_fabric():
    mgr = port_service.FabricManager(port_service.FabricConfig(
        rates=RATES, delta=8.0, N=6), device="cpu")
    mgr.submit(port.Coflow(cid=0, demand=torch.eye(
        6, dtype=torch.float64) * 50.0), 1.0)
    mgr.tick(2.0)
    return mgr


def _build(mesh):
    return (lambda s, b: (s, {}), lambda: {}, lambda s: {})


MESHES = [types.SimpleNamespace(shape={"data": 8}),
          types.SimpleNamespace(shape={"data": 4})]


def test_fabric_wiring_matches_reference(tmp_path):
    """DeviceLoss -> shrink() -> fabric CoreDown, one story; grow() brings
    the core back; both packages abort and requeue the same circuits and
    flush the same program."""
    runs = {}
    for name, mod, mgr in (("ref", ref_fault, _ref_fabric()),
                           ("port", port_fault, _port_fabric())):
        tr = mod.ElasticTrainer(_build, MESHES, str(tmp_path / name),
                                fabric=mgr, mesh_cores=[(0, 1, 2), (0, 1)])
        tr.shrink()
        down = [bool(x) for x in mgr.state.core_up]
        tr.grow()
        up = [bool(x) for x in mgr.state.core_up]
        mgr.flush()
        program = mgr.program()
        program.validate()
        tr.ckpt.wait()
        runs[name] = (tr.events, down, up, program)
    ref_events, ref_down, ref_up, ref_program = runs["ref"]
    events, down, up, program = runs["port"]
    assert events == ref_events
    assert [e["event"] for e in events] == [
        "shrink", "fabric-core-down", "grow", "fabric-core-up"]
    assert events[1]["core"] == 2 and events[1]["aborted"] > 0
    assert down == ref_down == [True, True, False]
    assert up == ref_up == [True, True, True]
    assert_same_program(program, ref_program, "flushed program")


@pytest.mark.parametrize("kw, match", [
    (dict(), "go together"),
    (dict(mesh_cores=[(0, 1, 2)]), "every mesh"),
    (dict(mesh_cores=[(0, 1, 2), (1, 2, 3)]), "nested fallback chain")])
def test_fabric_wiring_rejects_what_the_reference_rejects(tmp_path, kw,
                                                          match):
    for mod, mgr in ((ref_fault, _ref_fabric()),
                     (port_fault, _port_fabric())):
        with pytest.raises(ValueError, match=match):
            mod.ElasticTrainer(_build, MESHES, str(tmp_path), fabric=mgr,
                               **kw)
