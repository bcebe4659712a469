"""The port's training path vs the reference, on the CPU.

Same numpy inputs through the JAX package and ``repro_torch``:

  - data: ``SyntheticCorpus.document`` and ``PackedLoader`` batches are
    bit-equal, after a ``start_step`` resume and across a 2-host split;
  - optimizer: ``lr_at`` bit for bit in fp32 over steps 0-200; the same
    numpy grads through both ``apply_updates`` give ``m``, ``v`` and the
    master weights within 1e-6 relative (to each leaf's max); new
    parameters come out bf16
    whatever the model's dtype, as in the reference;
  - step: ``build_train_step`` with ``microbatches=1`` and ``4`` on the
    reference's ``test_microbatch_accumulation_equivalence`` setting: the
    loss, and every accumulated gradient leaf within 1e-4 x its max|g|;
  - loop: ``train_loop`` at the tinyllama smoke config (fp32), 6 steps,
    gives the reference's loss history within 1e-4 relative; train,
    checkpoint, resume and serve; the watchdog's straggler case;
  - checkpoint: written by ``repro`` and restored by ``repro_torch`` (and
    the reverse) bit for bit, corruption detected, ``AsyncCheckpointer``
    keeping ``keep`` steps.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.data.pipeline as ref_data
import repro.distributed.checkpoint as ref_ckpt
import repro.launch.train as ref_launch
import repro.train.optimizer as ref_opt
import repro.train.step as ref_step
import repro_torch.data.pipeline as port_data
import repro_torch.distributed.checkpoint as port_ckpt
import repro_torch.launch.train as port_launch
import repro_torch.train.optimizer as port_opt
import repro_torch.train.step as port_step
from repro.configs import get_arch as ref_arch
from repro.models.api import ModelConfig as RefConfig
from repro.models.api import build_model as ref_build
from repro_torch.analysis import hw, roofline
from repro_torch.configs import SHAPES, get_arch
from repro_torch.distributed.fault import DeviceLoss, StepWatchdog
from repro_torch.models.api import model_class
from repro_torch.models.weights import _flatten, params_from_jax
from test_torch_train_models import assert_grads_match, port_config


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("vocab, seed", [(100, 5), (32000, 0)])
def test_corpus_documents_bit_equal(vocab, seed):
    ref, port = ref_data.SyntheticCorpus(vocab, seed=seed), \
        port_data.SyntheticCorpus(vocab, seed=seed)
    for doc in (0, 1, 42, (7 << 8) + 3):
        want, got = ref.document(doc), port.document(doc)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _batches(mod, n, **kw):
    loader = mod.PackedLoader(mod.SyntheticCorpus(100, seed=1),
                              global_batch=4, seq_len=64, **kw)
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    loader.close()
    return out


def test_loader_batches_bit_equal_and_resume():
    for kw in ({}, {"start_step": 2}):
        for want, got in zip(_batches(ref_data, 3, **kw),
                             _batches(port_data, 3, **kw)):
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
    assert np.array_equal(_batches(port_data, 3)[2]["tokens"],
                          _batches(port_data, 1, start_step=2)[0]["tokens"])


def test_loader_two_host_split_bit_equal():
    for i in range(2):
        kw = dict(global_batch=4, seq_len=32, process_index=i,
                  process_count=2)
        want = ref_data.PackedLoader(ref_data.SyntheticCorpus(50, seed=2),
                                     **kw)._make_batch(3)
        got = port_data.PackedLoader(port_data.SyntheticCorpus(50, seed=2),
                                     **kw)._make_batch(3)
        assert all(np.array_equal(got[k], want[k]) for k in want)


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cfg", [
    dict(), dict(lr=1e-3, warmup_steps=2, total_steps=24),
    dict(warmup_steps=10, total_steps=200, min_lr_ratio=0.0)])
def test_lr_at_bit_equal_over_steps(cfg):
    rc, pc = ref_opt.OptimizerConfig(**cfg), port_opt.OptimizerConfig(**cfg)
    for s in range(201):
        want = np.asarray(ref_opt.lr_at(rc, jnp.int32(s)))
        got = port_opt.lr_at(pc, torch.tensor(s, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes(), s


def _tree(rng):
    return {"blocks": {"wq": rng.standard_normal((2, 8, 8)),
                       "ln1": rng.standard_normal((2, 8))},
            "embed": rng.standard_normal((11, 8))}


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                    _tree(rng))
    grads = [jax.tree_util.tree_map(lambda a: a.astype(np.float32) * 3.0,
                                    _tree(rng)) for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    rstate = ref_opt.init_opt_state(jax.tree_util.tree_map(jnp.asarray,
                                                           params))
    pstate = port_opt.init_opt_state({k: torch.from_numpy(v) for k, v in
                                      _flatten(params).items()})
    for g in grads:
        rp, rstate, rm = ref_opt.apply_updates(
            ref_opt.OptimizerConfig(**cfg),
            jax.tree_util.tree_map(jnp.asarray, g), rstate)
        pp, pstate, pm = port_opt.apply_updates(
            port_opt.OptimizerConfig(**cfg),
            {k: torch.from_numpy(v) for k, v in _flatten(g).items()}, pstate)
        for part in ("m", "v", "master"):
            want = _flatten(jax.tree_util.tree_map(np.asarray, rstate[part]))
            for k, w in want.items():
                # relative to the leaf's scale: the global norm's last bit
                # (another summation order) scales every g, and m cancels
                np.testing.assert_allclose(pstate[part][k].numpy(), w,
                                           rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{part}/{k}")
        assert int(pstate["step"]) == int(rstate["step"])
        for k in ("grad_norm", "lr", "param_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)
        # the reference's quirk, kept: the new params are bf16 whatever the
        # model's dtype (here fp32)
        want_p = _flatten(jax.tree_util.tree_map(np.asarray, rp))
        for k, t in pp.items():
            assert t.dtype == torch.bfloat16
            assert want_p[k].dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(t.float().numpy(),
                                          want_p[k].astype(np.float32))


def test_global_norm_sums_in_the_references_leaf_order():
    tree = {"b.x": torch.ones(2), "a": torch.ones(3), "b.a_": torch.ones(1),
            "ab": torch.ones(1)}
    assert port_opt.leaf_order(tree) == ["a", "ab", "b.a_", "b.x"]
    assert float(port_opt.global_norm(tree)) == pytest.approx(7 ** 0.5)


# ------------------------------------------------------------------- step

def _small_cfg():
    return RefConfig(name="t", family="dense", n_layers=2, d_model=32,
                     n_heads=2, n_kv_heads=2, d_ff=64, vocab=61,
                     dtype=jnp.float32)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(microbatches):
    """The reference's ``test_microbatch_accumulation_equivalence``
    setting, the port's step against the reference's at each count: the
    loss within 1e-5 relative, and every gradient leaf the step hands to
    ``grad_transform`` (accumulated over the microbatches) within 1e-4 x
    its max|g|. Gradients, not the updated weights: AdamW's first step is
    lr * g/(|g| + eps), so any update of size lr would pass."""
    rcfg = _small_cfg()
    m = ref_build(rcfg)
    params, _ = m.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    arrays = {"tokens": rng.integers(0, 61, (8, 16)).astype(np.int32),
              "labels": rng.integers(0, 61, (8, 16)).astype(np.int32)}
    ocfg = dict(lr=1e-3, warmup_steps=1)
    ref_seen, port_seen = [], []
    step = ref_step.build_train_step(
        m, ref_opt.OptimizerConfig(**ocfg), microbatches=microbatches,
        grad_transform=lambda g: ref_seen.append(g) or g)
    # eager, so that grad_transform sees the values
    _, _, rm = step(params, ref_opt.init_opt_state(params),
                    {k: jnp.asarray(v) for k, v in arrays.items()})

    pcfg = port_config(rcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg,
                            device="cpu")
    model = model_class(pcfg.family).from_state(pcfg, state)
    pstep = port_step.build_train_step(
        model, port_opt.OptimizerConfig(**ocfg), microbatches=microbatches,
        grad_transform=lambda g: port_seen.append(g) or g)
    _, _, pm = pstep(dict(state), port_opt.init_opt_state(state),
                     {k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-4)
    assert len(ref_seen) == len(port_seen) == 1
    assert {g.dtype for g in port_seen[0].values()} == {torch.float32}
    assert_grads_match(port_seen[0], _flatten(jax.tree_util.tree_map(
        np.asarray, ref_seen[0])))


def test_microbatch_accumulation_equivalence():
    """grad accumulation over 4 microbatches == single full batch step, in
    the port, at the reference's tolerance."""
    pcfg = port_config(_small_cfg())
    outs = []
    for mb in (1, 4):
        model = model_class(pcfg.family)(
            pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        state = {k: p.detach() for k, p in model.named_parameters()}
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, 61, (8, 16), generator=g),
                 "labels": torch.randint(0, 61, (8, 16), generator=g)}
        step = port_step.build_train_step(
            model, port_opt.OptimizerConfig(lr=1e-3, warmup_steps=1),
            microbatches=mb)
        outs.append(step(state, port_opt.init_opt_state(state), batch))
    (p1, _, m1), (p4, _, m4) = outs
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    assert max(float((p1[k].float() - p4[k].float()).abs().max())
               for k in p1) < 5e-3


def test_step_grads_in_the_leaf_dtype():
    """After one step an fp32 model's parameters are bf16 (the reference's
    quirk), and the next step's gradients come bf16-rounded, as
    ``jax.grad`` gives them for bf16 leaves."""
    pcfg = port_config(_small_cfg())
    model = model_class(pcfg.family)(pcfg, device="cpu")
    state = {k: p.detach() for k, p in model.named_parameters()}
    seen = []
    step = port_step.build_train_step(
        model, port_opt.OptimizerConfig(lr=1e-3, warmup_steps=1),
        grad_transform=lambda g: seen.append({k: v.dtype for k, v in
                                              g.items()}) or g)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.ones((2, 8), dtype=torch.int32)}
    state, opt, _ = step(state, port_opt.init_opt_state(state), batch)
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    step(state, opt, batch)
    assert set(seen[0].values()) == {torch.float32}
    assert set(seen[1].values()) == {torch.bfloat16}
    assert {p.dtype for p in model.parameters()} == {torch.float32}


# ------------------------------------------------------------------- loop

def _tinyllama():
    rcfg = dataclasses.replace(ref_arch("tinyllama-1.1b").smoke,
                               dtype=jnp.float32)
    return rcfg, port_config(rcfg)


def test_train_loop_loss_history_matches_reference(monkeypatch):
    """Six steps of the tinyllama smoke config (fp32) from the reference's
    initial weights give its loss history within 1e-4 relative. The
    reference's loop donates the params and the optimizer state to its
    jitted step, and in fp32 the master copy is the params' own buffer,
    which JAX refuses to donate twice, so the reference runs here without
    donation (ROADMAP queue 3)."""
    rcfg, pcfg = _tinyllama()
    kw = dict(steps=6, global_batch=4, seq_len=32, log_every=0)
    real_jit = jax.jit
    monkeypatch.setattr(ref_launch.jax, "jit",
                        lambda f, **_: real_jit(f))
    want = ref_launch.train_loop(rcfg, opt_cfg=ref_opt.OptimizerConfig(
        lr=1e-3, total_steps=6, warmup_steps=2), **kw)
    monkeypatch.undo()
    init = params_from_jax(jax.tree_util.tree_map(
        np.asarray, ref_build(rcfg).init(jax.random.key(0))[0]), pcfg,
        device="cpu")
    monkeypatch.setattr(port_launch, "build_model", lambda cfg, **_:
                        model_class(cfg.family).from_state(cfg, init))
    got = port_launch.train_loop(pcfg, opt_cfg=port_opt.OptimizerConfig(
        lr=1e-3, total_steps=6, warmup_steps=2), device="cpu", **kw)
    assert got.steps_done == 6 and len(got.history) == 6
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        # lr_at is bit-equal to the reference's eager lr_at; inside its
        # jitted step XLA may round the fused cosine's last bit otherwise
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)


def test_train_checkpoint_resume_serve(tmp_path):
    """tests/test_system.py's scenario on the port: train 24 steps with a
    checkpoint every 8, resume to 30, then serve the trained weights."""
    _, cfg = _tinyllama()
    kw = dict(global_batch=4, seq_len=64, ckpt_dir=str(tmp_path),
              ckpt_every=8, log_every=0, device="cpu")
    run = port_launch.train_loop(cfg, steps=24, opt_cfg=port_opt.
                                 OptimizerConfig(lr=1e-3, total_steps=24,
                                                 warmup_steps=2), **kw)
    first = np.mean([h["loss"] for h in run.history[:6]])
    assert np.mean([h["loss"] for h in run.history[-6:]]) < first
    assert port_ckpt.latest_step(str(tmp_path)) == 24
    run2 = port_launch.train_loop(cfg, steps=30, opt_cfg=port_opt.
                                  OptimizerConfig(lr=1e-3, total_steps=30,
                                                  warmup_steps=2), **kw)
    assert run2.steps_done == 30 and len(run2.history) == 6
    assert np.mean([h["loss"] for h in run2.history[:3]]) < first
    model = model_class(cfg.family).from_state(
        cfg, {k: v.to(cfg.dtype) for k, v in run2.params.items()})
    cache = model.make_caches(2, 32)
    logits, cache = model.prefill(cache, {"tokens": torch.zeros(
        (2, 8), dtype=torch.int32)})
    assert bool(torch.isfinite(logits).all())
    tok = logits[:, -1].argmax(-1)[:, None]
    logits2, _ = model.decode_step(cache, tok)
    assert logits2.shape == (2, 1, cfg.vocab)


def test_resume_is_exact(tmp_path):
    """Steps 4-6 resumed from step 4's checkpoint equal the uninterrupted
    run's: parameters, optimizer state and the data stream come back. In
    bf16, the config's dtype: an fp32 model restores its (bf16) parameters
    as fp32, the dtype of the restore's target, as in the reference, and
    its next gradients are then not bf16-rounded."""
    cfg = get_arch("tinyllama-1.1b").smoke
    kw = dict(global_batch=2, seq_len=16, log_every=0, device="cpu",
              opt_cfg=port_opt.OptimizerConfig(lr=1e-3, total_steps=6,
                                               warmup_steps=1))
    whole = port_launch.train_loop(cfg, steps=6, **kw)
    port_launch.train_loop(cfg, steps=4, ckpt_dir=str(tmp_path), ckpt_every=4,
                           **kw)
    resumed = port_launch.train_loop(cfg, steps=6, ckpt_dir=str(tmp_path),
                                     ckpt_every=4, **kw)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history[4:]]


def test_main_cli(capsys):
    port_launch.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3",
                      "--global-batch", "2", "--seq-len", "16", "--device",
                      "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"first10_loss", "last10_loss", "stragglers"}
    assert np.isfinite(out["first10_loss"])


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=2.0, min_samples=3)
    for s in range(6):
        assert not wd.observe(s, 1.0)
    assert wd.observe(6, 5.0)  # 5x median
    assert wd.stragglers and wd.stragglers[0][0] == 6
    assert DeviceLoss(2).lost == 2 and "lost 2" in str(DeviceLoss(2))


# ------------------------------------------------------------- checkpoint

def _ref_tree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"c": jnp.linspace(-3, 3, 5).astype(jnp.bfloat16)},
            "step": jnp.asarray(7, jnp.int32)}


def _port_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b.c": torch.linspace(-3, 3, 5).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16).tobytes() \
            if x.dtype == torch.bfloat16 else x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a) \
        .tobytes()


def test_checkpoint_from_reference_restores_in_port(tmp_path):
    ref_ckpt.save_checkpoint(str(tmp_path), 3, _ref_tree())
    assert port_ckpt.latest_step(str(tmp_path)) == 3
    target = {"a": torch.zeros(3, 4), "b.c": torch.zeros(5, dtype=torch.bfloat16),
              "step": torch.zeros((), dtype=torch.int32)}
    got = port_ckpt.restore_checkpoint(str(tmp_path), 3, target)
    want = _ref_tree()
    assert _bits(got["a"]) == _bits(want["a"])
    assert _bits(got["b.c"]) == _bits(want["b"]["c"])
    assert _bits(got["step"]) == _bits(want["step"])


def test_checkpoint_from_port_restores_in_reference(tmp_path):
    port_ckpt.save_checkpoint(str(tmp_path), 5, _port_tree())
    assert ref_ckpt.latest_step(str(tmp_path)) == 5
    got = ref_ckpt.restore_checkpoint(str(tmp_path), 5, _ref_tree())
    want = _port_tree()
    assert _bits(got["a"]) == _bits(want["a"])
    assert _bits(got["b"]["c"]) == _bits(want["b.c"])
    assert _bits(got["step"]) == _bits(want["step"])
    # the manifests name the same leaves with the same hashes
    ref_ckpt.save_checkpoint(str(tmp_path / "r"), 5, _ref_tree())
    port_ckpt.save_checkpoint(str(tmp_path / "r"), 6, {
        "a": torch.arange(12.0).reshape(3, 4),
        "b.c": torch.from_numpy(np.array(_ref_tree()["b"]["c"]).view(
            np.uint16).view(np.int16)).view(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32)})
    metas = []
    for s in (5, 6):
        with open(tmp_path / "r" / f"step_{s:08d}" / "manifest.json") as fh:
            metas.append({k: (v["file"], v["dtype"], v["sha256"])
                          for k, v in json.load(fh)["leaves"].items()})
    assert metas[0] == metas[1]


def test_checkpoint_of_a_train_state_roundtrips_between_packages(tmp_path):
    """A model's params and AdamW state, keyed as the reference keys them
    (``params/blocks/wq``, ``opt/master/blocks/wq``, ``opt/step``)."""
    rcfg = _small_cfg()
    params = ref_build(rcfg).init(jax.random.key(0))[0]
    ropt = ref_opt.init_opt_state(params)
    ref_ckpt.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": ropt})
    pcfg = port_config(rcfg)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg,
                            device="cpu")
    target = {"params": {k: torch.zeros_like(v) for k, v in state.items()},
              "opt": port_opt.init_opt_state(
                  {k: torch.zeros_like(v) for k, v in state.items()})}
    got = port_ckpt.restore_checkpoint(str(tmp_path), 1, target)
    for k, v in state.items():
        assert torch.equal(got["params"][k], v)
        assert torch.equal(got["opt"]["master"][k], v.float())
    port_ckpt.save_checkpoint(str(tmp_path), 2, got)
    with open(tmp_path / "step_00000002" / "manifest.json") as fh:
        keys = set(json.load(fh)["leaves"])
    with open(tmp_path / "step_00000001" / "manifest.json") as fh:
        assert keys == set(json.load(fh)["leaves"])
    assert {"params/blocks/wq", "opt/master/blocks/wq", "opt/step"} <= keys
    back = ref_ckpt.restore_checkpoint(str(tmp_path), 2,
                                       {"params": params, "opt": ropt})
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, {"params": params, "opt": ropt})


def test_checkpoint_detects_corruption(tmp_path):
    path = port_ckpt.save_checkpoint(str(tmp_path), 1,
                                     {"a": torch.arange(8.0)})
    fn = os.path.join(path, "arrays", "a.npy")
    arr = np.load(fn)
    arr[0] = 999.0
    np.save(fn, arr)
    with pytest.raises(IOError, match="hash mismatch"):
        port_ckpt.restore_checkpoint(str(tmp_path), 1,
                                     {"a": torch.zeros(8)})
    with pytest.raises(KeyError, match="missing leaf"):
        port_ckpt.restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(8)})
    with pytest.raises(ValueError, match="shape"):
        port_ckpt.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)},
                                     verify=False)


def test_async_checkpointer_gc(tmp_path):
    ck = port_ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(5):
        x = torch.full((4,), float(s))
        ck.save(s, {"x": x})
        x.fill_(-1.0)  # the snapshot was taken at save()
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    out = port_ckpt.restore_checkpoint(str(tmp_path), 4,
                                       {"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 4.0))


# --------------------------------------------------------------- analysis

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-1.3b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_count_params_and_model_flops_match_reference(arch):
    from repro.analysis import roofline as ref_roofline
    from repro.configs import SHAPES as REF_SHAPES

    rcfg, pcfg = ref_arch(arch).config, get_arch(arch).config
    assert roofline.count_params(pcfg) == ref_roofline.count_params(rcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(pcfg, shape) == \
            ref_roofline.model_flops(rcfg, REF_SHAPES[name])
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
