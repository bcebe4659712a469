"""The rest of the port's ``distributed/`` against the reference, on the CPU.

In this process, JAX and ``repro_torch`` on the same numpy inputs:

  - ``quantize_int8`` / ``dequantize_int8`` bit-equal to the reference's at
    sizes 1, 2,047, 2,048, 2,049 and 10,000 in fp32 and bf16, and on a
    zero block; the reference's round-trip bound.

Then one run of 4 gloo ranks (spawned on a ``FileStore`` under the test's
directory, one thread each) for the cases that need a mesh; rank 0 writes
what the tests read:

  - one pod hop (``build_compressed_train_step(...).grads_fn``) on a
    ``(2, 1, 2)`` ("pod", "data", "model") mesh against the reference's
    ``_grads_fn_vmapped`` on the same weights (``params_from_jax``), batch
    and nonzero residuals, ``n_pods=2``: the loss within 1e-5 relative,
    the residuals and the reduced gradient bit-equal to the port's own
    ``work - dequant`` and pod mean, and element by element the
    reference's but for a level moved at a rounding boundary;
  - the compressed step on that mesh against the plain step, with the
    reference test's bounds (``tests/test_distributed.py:113-142``:
    |dloss| < 0.05, max |dparam| < 0.05), and ``train_loop(
    compress_pods=True)`` for 2 steps against the plain sharded loop;
  - a checkpoint saved on a (2, 2) mesh restored onto (4,) and onto a
    2-rank sub-mesh, bytes identical (the reference's
    ``test_elastic_restore_across_meshes``), one saved on a mesh of ranks
    2 and 3 (its first rank writes), and a checkpoint the reference wrote
    restored onto a sharded (2, 2) mesh;
  - ``train_loop(mesh=(2, 2), ckpt_dir=)`` resumed from step 2's
    checkpoint equals the uninterrupted sharded run, loss for loss and
    parameter for parameter (in bf16, as ``tests/test_torch_train.py::
    test_resume_is_exact`` says why).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.distributed.checkpoint as ref_ckpt
import repro.distributed.compression as ref_comp
import repro_torch.distributed.compression as port_comp
from repro.models.api import ModelConfig as RefConfig
from repro.models.api import build_model as ref_build
from repro_torch.models.weights import _flatten
from test_torch_train_models import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, V = 8, 32, 97


# ------------------------------------------------------------ quantization

def _ref_quant(x: np.ndarray):
    q, s = ref_comp.quantize_int8(jnp.asarray(x))
    back = ref_comp.dequantize_int8(q, s, x.shape, jnp.float32)
    return np.asarray(q), np.asarray(s), np.asarray(back)


def _port_quant(t: torch.Tensor):
    q, s = port_comp.quantize_int8(t)
    back = port_comp.dequantize_int8(q, s, tuple(t.shape), torch.float32)
    return q.numpy(), s.numpy(), back.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 10000])
def test_quantize_bit_equal_to_reference(n, dtype):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 40.0], n)
         ).astype(np.float32)
    x[::7] = np.round(x[::7] * 4) / 4  # some exact ties after scaling
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    rq, rs, rback = _ref_quant(x)
    pq, ps, pback = _port_quant(t)
    assert pq.dtype == np.int8 and pq.shape == rq.shape == (
        -(-n // port_comp.BLOCK), port_comp.BLOCK)
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(ps.view(np.uint32), rs.view(np.uint32))
    np.testing.assert_array_equal(pback.view(np.uint32),
                                  rback.view(np.uint32))


def test_quantize_zero_block_bit_equal_to_reference():
    x = np.zeros(3 * port_comp.BLOCK, np.float32)
    x[:5] = [0.5, -1.0, 2.5, -2.5, 127.0]  # block 0 nonzero, 1-2 zero
    x[-1] = -3.0
    x[port_comp.BLOCK:2 * port_comp.BLOCK] = 0.0
    rq, rs, rback = _ref_quant(x)
    pq, ps, pback = _port_quant(torch.from_numpy(x))
    assert ps[1, 0] == 0 and not pq[1].any()
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(ps.view(np.uint32), rs.view(np.uint32))
    np.testing.assert_array_equal(pback.view(np.uint32),
                                  rback.view(np.uint32))


def test_quantize_roundtrip_bound():
    """The reference's bound (``tests/test_distributed.py:102-110``)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 3, (1000,)).astype(np.float32))
    q, s = port_comp.quantize_int8(g)
    back = port_comp.dequantize_int8(q, s, g.shape, torch.float32)
    err = (back - g).abs()
    assert float(err.max()) <= float(g.abs().max()) / 127.0 + 1e-6


# ------------------------------------------------------------ 4 gloo ranks

WORKER = textwrap.dedent("""
    import dataclasses, json, sys, warnings
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
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.checkpoint import (
            latest_step, restore_checkpoint, save_checkpoint)
        from repro_torch.distributed.compression import (
            build_compressed_train_step, init_error_state)
        from repro_torch.distributed.sharding import (
            TRAIN_RULES, NamedSharding, batch_spec, plan_sharding, plan_tree,
            shard_module, shard_tensor)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import train_loop
        from repro_torch.models.api import ModelConfig, model_class
        from repro_torch.models.common import activation_sharding
        from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
        from repro_torch.train.step import build_train_step

        out, arrays = {}, {}
        cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                          dtype=torch.float32)
        hop = np.load(tmp + "/hop.npz")
        state = {k[2:]: torch.from_numpy(hop[k]) for k in hop.files
                 if k.startswith("p/")}
        mesh3 = make_mesh((2, 1, 2), ("pod", "data", "model"),
                          device_type="cpu")
        pod = mesh3.get_local_rank("pod")

        def sharded_model():
            model = model_class("dense").from_state(cfg, dict(state))
            shard_module(model, mesh3, plan_tree(
                mesh3, dict(model.named_parameters()), model.param_axes(cfg),
                TRAIN_RULES))
            return model, {k: p.detach() for k, p in
                           model.named_parameters()}

        batch = {k: shard_tensor(torch.from_numpy(hop[k]), mesh3,
                                 batch_spec(mesh3, 2, hop[k].shape[0]))
                 for k in ("tokens", "labels")}
        ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1)

        # one pod hop, nonzero residuals
        model, params = sharded_model()
        step = build_compressed_train_step(model, ocfg, mesh3)
        err = init_error_state(params, 2)
        for k, e in err.items():
            e.to_local().copy_(torch.from_numpy(hop["e/" + k][pod][None]))
        with activation_sharding(mesh3, TRAIN_RULES):
            loss, g, e = step.grads_fn(params, batch, err)
        out["hop_loss"] = float(loss)
        out["err_placements"] = str(next(iter(e.values())).placements)
        # each pod's work (its gradient plus its residual), both pods'
        _, g_pod = step.pod_grads(params, batch)
        for k in g:
            arrays["g/" + k] = g[k].full_tensor().numpy()
            arrays["e/" + k] = e[k].full_tensor().numpy()
            work = g_pod[k].full_tensor().float() + err[k].to_local()[0]
            arrays["w/" + k] = DTensor.from_local(
                work[None], mesh3, err[k].placements, run_check=False,
                shape=err[k].shape, stride=err[k].stride()
            ).full_tensor().numpy()

        # the compressed step against the plain step, from the same weights
        model, params = sharded_model()
        with activation_sharding(mesh3, TRAIN_RULES):
            p1, _, m1 = build_train_step(model, ocfg)(
                params, init_opt_state(params), batch)
        model, params = sharded_model()
        with activation_sharding(mesh3, TRAIN_RULES):
            p2, _, _, m2 = build_compressed_train_step(model, ocfg, mesh3)(
                params, init_opt_state(params), init_error_state(params, 2),
                batch)
        out["loss_plain"] = float(m1["loss"].full_tensor())
        out["loss_comp"] = float(m2["loss"])
        out["max_delta"] = max(float((p1[k].full_tensor().float()
                                      - p2[k].full_tensor().float())
                                     .abs().max()) for k in p1)

        # train_loop(compress_pods=True) against the plain sharded loop
        kw = dict(steps=2, global_batch=8, seq_len=32, log_every=0, seed=0,
                  opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=2))
        comp = train_loop(cfg, mesh=mesh3, compress_pods=True, **kw)
        plain = train_loop(cfg, mesh=mesh3, **kw)
        out["loop_comp"] = [h["loss"] for h in comp.history]
        out["loop_plain"] = [h["loss"] for h in plain.history]

        # save on (2, 2), restore onto (4,) and onto ranks 0-1
        mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        mesh4 = make_mesh((4,), ("data",), device_type="cpu")
        pair = DeviceMesh("cpu", torch.tensor([0, 1]),
                          mesh_dim_names=("model",))
        glob = {"x": torch.arange(64.0).reshape(8, 8),
                "b": {"y": (torch.arange(32.0) / 7).to(torch.bfloat16)
                      .reshape(4, 8)}}
        names = {"x": ("embed", "mlp"), "b/y": ("embed", "mlp")}

        def plans(mesh):
            return {k: NamedSharding(mesh, plan_sharding(
                mesh, tuple((glob["x"] if k == "x" else glob["b"]["y"])
                            .shape), names[k], TRAIN_RULES))
                    for k in names}

        def bits(t):
            return t.view(torch.int16 if t.dtype == torch.bfloat16
                          else torch.int32)

        def tree(leaves):
            return {"x": leaves["x"], "b": {"y": leaves["b/y"]}}

        on22 = plans(mesh22)
        save_checkpoint(tmp + "/ck", 1, tree({
            k: shard_tensor(glob["x"] if k == "x" else glob["b"]["y"],
                            mesh22, on22[k].plan) for k in names}))
        targets = [("4", mesh4)] + ([("pair", pair)] if rank < 2 else [])
        for tag, mesh in targets:
            sh = plans(mesh)
            got = restore_checkpoint(tmp + "/ck", 1, glob, tree(sh))
            for k, t in (("x", got["x"]), ("b/y", got["b"]["y"])):
                want = glob["x"] if k == "x" else glob["b"]["y"]
                out[f"restore/{tag}/{k}"] = [
                    str(t.placements), str(sh[k].plan.spec),
                    t.dtype == want.dtype,
                    torch.equal(bits(t.full_tensor()), bits(want))]

        # save on a mesh of ranks 2 and 3 alone: its first rank writes
        tail = DeviceMesh("cpu", torch.tensor([2, 3]),
                          mesh_dim_names=("model",))
        if rank >= 2:
            sh = plans(tail)
            save_checkpoint(tmp + "/tail", 5, tree({
                k: shard_tensor(glob["x"] if k == "x" else glob["b"]["y"],
                                tail, sh[k].plan) for k in names}))
            got = restore_checkpoint(tmp + "/tail", 5, glob, tree(sh))
            json.dump([str(got["x"].placements), all(
                torch.equal(bits(t.full_tensor()), bits(want)) for t, want in
                ((got["x"], glob["x"]), (got["b"]["y"], glob["b"]["y"])))],
                open(f"{tmp}/tail{rank}.json", "w"))
        dist.barrier()
        if rank == 0:
            got = restore_checkpoint(tmp + "/tail", 5, glob)
            out["tail"] = {
                "latest": latest_step(tmp + "/tail"),
                "whole": all(torch.equal(bits(t), bits(want)) for t, want in
                             ((got["x"], glob["x"]),
                              (got["b"]["y"], glob["b"]["y"]))),
                "ranks": [json.load(open(f"{tmp}/tail{r}.json"))
                          for r in (2, 3)]}

        # a checkpoint the reference wrote, onto the (2, 2) mesh
        ref = np.load(tmp + "/refck.npz")
        target = {"w": torch.zeros(8, 4),
                  "b": {"v": torch.zeros(4, 8, dtype=torch.bfloat16)}}
        sh = {"w": NamedSharding(mesh22, plan_sharding(
                  mesh22, (8, 4), ("embed", "mlp"), TRAIN_RULES)),
              "b": {"v": NamedSharding(mesh22, plan_sharding(
                  mesh22, (4, 8), ("mlp", "embed"), TRAIN_RULES))}}
        got = restore_checkpoint(tmp + "/refck", 3, target, sh)
        out["refck"] = [
            str(got["w"].placements), str(got["b"]["v"].placements),
            bool(np.array_equal(got["w"].full_tensor().numpy(), ref["w"])),
            bool(np.array_equal(got["b"]["v"].full_tensor().view(torch.int16)
                                .numpy().view(np.uint16), ref["v_bits"]))]

        # train_loop(mesh=(2, 2), ckpt_dir=) resumed == uninterrupted, in
        # bf16 (the step's parameters' dtype, which the restore keeps)
        kw = dict(global_batch=8, seq_len=32, log_every=0, seed=0,
                  opt_cfg=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=4))
        cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
        whole = train_loop(cfg16, mesh=mesh22, steps=4, **kw)
        first = train_loop(cfg16, mesh=mesh22, steps=2,
                           ckpt_dir=tmp + "/run", ckpt_every=2, **kw)
        resumed = train_loop(cfg16, mesh=mesh22, steps=4,
                             ckpt_dir=tmp + "/run", ckpt_every=100, **kw)
        out["resume"] = {
            "whole": [h["loss"] for h in whole.history],
            "first": [h["loss"] for h in first.history],
            "resumed": [h["loss"] for h in resumed.history],
            "params_equal": all(torch.equal(
                resumed.params[k].to_local(), whole.params[k].to_local())
                for k in whole.params),
            "placements": sorted({str(p.placements)
                                  for p in resumed.params.values()}),
            "timings": first.ckpt_timings}
        if rank == 0:
            np.savez(tmp + "/arrays.npz", **arrays)
            json.dump(out, open(tmp + "/out.json", "w"))
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1],), nprocs=4)
""")


def _ref_setup():
    rcfg = RefConfig(name="t", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab=V,
                     dtype=jnp.float32)
    model = ref_build(rcfg)
    params, _ = model.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    flat = _flatten(jax.tree_util.tree_map(np.asarray, params))
    err = {k: (rng.standard_normal((2, *v.shape)) * 1e-3).astype(np.float32)
           for k, v in flat.items()}
    return rcfg, model, params, batch, flat, err


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The 4-rank run's results, and the reference's pod hop on the same
    weights, batch and residuals."""
    tmp = tmp_path_factory.mktemp("dist")
    rcfg, model, params, batch, flat, err = _ref_setup()
    assert port_config(rcfg).padded_vocab == rcfg.padded_vocab
    np.savez(tmp / "hop.npz", **{f"p/{k}": v for k, v in flat.items()},
             **{f"e/{k}": v for k, v in err.items()}, **batch)
    # a checkpoint written by the reference
    w = np.arange(32, dtype=np.float32).reshape(8, 4) / 3
    v = (np.arange(32, dtype=np.float32).reshape(4, 8) - 9.5).astype(
        ml_dtypes.bfloat16)
    ref_ckpt.save_checkpoint(str(tmp / "refck"), 3,
                             {"w": jnp.asarray(w), "b": {"v": jnp.asarray(v)}})
    np.savez(tmp / "refck.npz", w=w, v_bits=v.view(np.uint16))

    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script), str(tmp)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads((tmp / "out.json").read_text())
    arrays = np.load(tmp / "arrays.npz")

    # the reference's pod hop, and each pod's work (g_pod + err) for the
    # scales of its blocks
    ref_err = jax.tree_util.tree_map(jnp.asarray, _unflat(err, params))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    loss, g_red, e_new = ref_comp._grads_fn_vmapped(model, params, jbatch,
                                                    ref_err, 2)
    batch_p = {k: x.reshape(2, B // 2, S) for k, x in jbatch.items()}
    _, g_pods = jax.vmap(lambda b: jax.value_and_grad(model.loss)(
        params, b))(batch_p)
    work = {k: np.asarray(gp, np.float32) + err[k] for k, gp in
            _flatten(jax.tree_util.tree_map(np.asarray, g_pods)).items()}
    ref = {"loss": float(loss),
           "g": _flatten(jax.tree_util.tree_map(np.asarray, g_red)),
           "e": _flatten(jax.tree_util.tree_map(np.asarray, e_new)),
           "work": work}
    return out, arrays, ref


def _unflat(flat: dict, like: dict) -> dict:
    """``flat`` (dotted names) in the nesting of ``like``."""
    def build(node, prefix):
        return {k: build(v, f"{prefix}{k}.") if isinstance(v, dict)
                else flat[f"{prefix}{k}"] for k, v in node.items()}
    return build(like, "")


def _quantized(work: np.ndarray):
    """Per pod and element of ``work`` (n_pods, *shape): the int8 level and
    its block's scale, and the dequantised value, from the port's
    ``quantize_int8`` (bit-equal to the reference's, tested above)."""
    n = work[0].size
    qs, ss, back = [], [], []
    for w in work:
        q, s = port_comp.quantize_int8(torch.from_numpy(w))
        qs.append(q.numpy().reshape(-1)[:n].astype(np.float32))
        ss.append(np.repeat(s.numpy()[:, 0], port_comp.BLOCK)[:n])
        back.append(port_comp.dequantize_int8(q, s, w.shape,
                                              torch.float32).numpy())
    shape = work.shape
    return (np.stack(qs).reshape(shape), np.stack(ss).reshape(shape),
            np.stack(back))


def test_pod_hop_matches_reference(gloo):
    """The port's hop is exact arithmetic on its own pod gradients: the
    residual is ``work - dequant(q, scale)`` and the reduced gradient the
    pods' mean of ``dequant`` bit for bit. Against the reference, each
    pod's ``work`` agrees within 1e-5 of its largest value, and so the
    levels agree but for values at a rounding boundary (under 1% of them,
    one level apart). Where the levels agree the residual and the reduced
    gradient differ from the reference's only by what ``work`` and the
    scales do; where a level differs they differ by that one step."""
    out, arrays, ref = gloo
    assert out["err_placements"] == \
        "(Shard(dim=0), Replicate(), Replicate())"
    assert abs(out["hop_loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert set(ref["g"]) == {k[2:] for k in arrays.files
                             if k.startswith("g/")}
    moved = total = 0
    for k, g_ref in ref["g"].items():
        w_port, w_ref = arrays["w/" + k], ref["work"][k]
        e_port, g_port = arrays["e/" + k], arrays["g/" + k]
        q_p, s_p, back = _quantized(w_port)
        q_r, s_r, _ = _quantized(w_ref)
        # the port's own arithmetic, bit for bit
        np.testing.assert_array_equal((w_port - back).view(np.uint32),
                                      e_port.view(np.uint32), err_msg=k)
        mean = (back[0] + back[1]) / np.float32(2)
        np.testing.assert_array_equal(mean.view(np.uint32),
                                      g_port.view(np.uint32), err_msg=k)
        # against the reference
        big = np.abs(w_ref).max()
        d_work = w_port - w_ref
        assert np.abs(d_work).max() <= 1e-5 * big, k
        assert np.abs(q_p - q_r).max() <= 1, k
        moved += int((q_p != q_r).sum())
        total += q_p.size
        slack = 4 * np.finfo(np.float32).eps * big
        d_scale = np.abs(q_p) * np.abs(s_p - s_r)
        one_step = (q_p - q_r) * s_r  # zero where the levels agree
        assert np.all(np.abs((e_port - ref["e"][k]) - (d_work - one_step))
                      <= d_scale + slack), k
        assert np.all(np.abs((g_port - g_ref) - one_step.sum(0) / 2)
                      <= d_scale.sum(0) / 2 + slack), k
    assert moved < 0.01 * total


def test_compressed_step_matches_plain(gloo):
    out = gloo[0]
    assert abs(out["loss_plain"] - out["loss_comp"]) < 0.05
    assert out["max_delta"] < 0.05  # quantization noise through one adam step


def test_train_loop_compress_pods(gloo):
    out = gloo[0]
    comp, plain = out["loop_comp"], out["loop_plain"]
    assert len(comp) == 2 and all(np.isfinite(comp))
    assert comp[0] == pytest.approx(plain[0], rel=1e-6)  # the same weights
    assert abs(comp[1] - plain[1]) < 0.05


@pytest.mark.parametrize("target, leaf, placements", [
    ("4", "x", "(Shard(dim=0),)"), ("4", "b/y", "(Shard(dim=0),)"),
    ("pair", "x", "(Shard(dim=1),)"), ("pair", "b/y", "(Shard(dim=1),)")])
def test_restore_across_meshes_is_byte_identical(gloo, target, leaf,
                                                 placements):
    got, _spec, same_dtype, same_bytes = \
        gloo[0][f"restore/{target}/{leaf}"]
    assert got == placements and same_dtype and same_bytes


def test_save_on_a_mesh_without_rank_0(gloo):
    """The mesh's first rank (2) writes; both its ranks read their blocks
    back and rank 0, outside the mesh, finds the step whole."""
    t = gloo[0]["tail"]
    assert t["latest"] == 5 and t["whole"]
    assert t["ranks"] == [["(Shard(dim=1),)", True]] * 2


def test_restore_reference_checkpoint_onto_sharded_mesh(gloo):
    w_pl, v_pl, w_ok, v_ok = gloo[0]["refck"]
    assert w_pl == "(Shard(dim=0), Shard(dim=1))"
    assert v_pl == "(Shard(dim=1), Shard(dim=0))"
    assert w_ok and v_ok


def test_sharded_train_loop_resume_is_exact(gloo):
    r = gloo[0]["resume"]
    assert r["first"] == r["whole"][:2]
    assert r["resumed"] == r["whole"][2:]
    assert r["params_equal"]
    assert any("Shard" in p for p in r["placements"])
    (t,) = r["timings"]
    assert t["step"] == 2 and t["snapshot_s"] >= 0 and t["write_s"] > 0
