"""The port's dense LM and serving path vs the reference, on the CPU.

The smoke configs of tinyllama-1.1b (GQA), qwen1.5-0.5b (QKV bias) and
stablelm-1.6b (LayerNorm, partial RoPE) are built in the reference from
``jax.random.key(0)`` and carried into ``repro_torch`` with
``params_from_jax``. Then, on the same numpy tokens:

  - ``_forward_train`` logits agree at 1e-4 in fp32 and 5e-2 in bf16 (the
    matrix products round in another order);
  - the prefill under ``attention_impl="pallas"`` agrees with the
    reference's (its Pallas kernel in interpret mode) at the same
    tolerances;
  - three greedy decode steps agree with the reference's ``"xla"`` decode,
    token for token in fp32.

The reference's ``"pallas"`` decode is wrong (its kernel wrapper drops the
cache positions); ``test_reference_pallas_decode_fault_is_not_copied`` pins
that, and that the port's ``"pallas"`` decode equals the reference's
``"xla"`` one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as port_configs
from repro.models.api import ModelConfig as RefConfig
from repro.models.api import build_model as ref_build
from repro.serve.engine import build_decode as ref_build_decode
from repro.serve.engine import build_prefill as ref_build_prefill
from repro_torch.models.api import ModelConfig as PortConfig
from repro_torch.models.api import build_model as port_build
from repro_torch.models.common import param_count, tree_bytes
from repro_torch.models.dense import DenseLM
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import build_decode, build_prefill

ARCHS = ["tinyllama-1.1b", "qwen1.5-0.5b", "stablelm-1.6b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, S, STEPS = 2, 16, 3


def _configs(ref_cfg, dt, impl):
    jdt, tdt, _ = DTYPES[dt]
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(RefConfig)}
    fields.update(attention_impl=impl, dtype=tdt)
    return (dataclasses.replace(ref_cfg, attention_impl=impl, dtype=jdt),
            PortConfig(**fields))


def _models(ref_cfg, dt, impl):
    """(reference model, its params, port model with the same weights)."""
    rcfg, pcfg = _configs(ref_cfg, dt, impl)
    ref_model = ref_build(rcfg)
    params, _ = ref_model.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = DenseLM.from_state(pcfg, params_from_jax(tree, pcfg, device="cpu"))
    return ref_model, params, port


def _tokens(vocab, n=S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_port_configs_equal_reference_configs():
    """Every arch of the reference, config and smoke config, field by field,
    in the reference's order."""
    assert list(port_configs.ARCHS) == list(ref_configs.ARCHS)
    for arch in ref_configs.ARCHS:
        ref, port = ref_configs.get_arch(arch), port_configs.get_arch(arch)
        assert (port.arch_id, port.source) == (ref.arch_id, ref.source)
        for which in ("config", "smoke"):
            r, p = getattr(ref, which), getattr(port, which)
            for f in dataclasses.fields(RefConfig):
                if f.name != "dtype":
                    assert getattr(p, f.name) == getattr(r, f.name), (arch, f)
            assert p.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
            assert (p.dh, p.padded_vocab) == (r.dh, r.padded_vocab)
        for shape in ref_configs.SHAPES.values():
            assert port.supports(port_configs.SHAPES[shape.name]) == \
                ref.supports(shape)
    assert port_configs.SHAPES == {
        k: port_configs.ShapeSpec(*dataclasses.astuple(v))
        for k, v in ref_configs.SHAPES.items()}


def _leaf_name(path) -> str:
    return ".".join(str(getattr(k, "key", k)) for k in path)


@pytest.mark.parametrize("arch", list(ref_configs.ARCHS))
def test_full_config_param_shapes_match_reference_abstract_init(arch):
    """``build_model`` of every arch's full config on the ``meta`` device
    (nothing allocated) has the names, shapes and dtypes of the reference's
    abstract init, and they are the family's ``param_shapes``."""
    ref_cfg = ref_configs.get_arch(arch).config
    port_cfg = port_configs.get_arch(arch).config
    abstract, _ = ref_build(ref_cfg).init(None)
    want = {_leaf_name(path): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_leaves_with_path(abstract)}
    model = port_build(port_cfg, device="meta")
    got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for name, t in model.state_dict().items()}
    assert got == want
    assert type(model).param_shapes(port_cfg) == {
        k: v[0] for k, v in want.items()}
    assert all(t.is_meta for t in model.state_dict().values())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_pallas_prefill_match_reference(arch, dt):
    tol = DTYPES[dt][2]
    ref_model, params, port = _models(ref_configs.get_arch(arch).smoke, dt,
                                      "pallas")
    tokens = _tokens(port.cfg.vocab)

    want = jax.jit(ref_model._forward_train)(params,
                                              {"tokens": jnp.asarray(tokens)})
    got = port._forward_train({"tokens": torch.from_numpy(tokens)})
    assert got.dtype == DTYPES[dt][1] and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)

    s_max = S + STEPS
    want_l, want_c = jax.jit(ref_build_prefill(ref_model))(
        params, ref_model.make_caches(B, s_max), {"tokens": jnp.asarray(tokens)})
    got_l, got_c = build_prefill(port)(port.make_caches(B, s_max),
                                       {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_f32(got_l), _f32(want_l), atol=tol, rtol=tol)
    np.testing.assert_array_equal(got_c.length.numpy(),
                                  np.asarray(want_c.length))
    np.testing.assert_array_equal(got_c.positions.numpy(),
                                  np.asarray(want_c.positions))
    np.testing.assert_allclose(_f32(got_c.k), _f32(want_c.k), atol=tol,
                               rtol=tol)


def _greedy(prefill, decode, cache, tokens, steps, to_np):
    logits, cache = prefill(cache, tokens)
    seq, all_logits = [], [to_np(logits)]
    for _ in range(steps):
        nxt = all_logits[-1][:, -1].argmax(-1)[:, None].astype(np.int32)
        seq.append(nxt)
        logits, cache = decode(cache, nxt)
        all_logits.append(to_np(logits))
    return np.concatenate(seq, 1), all_logits


def _ref_greedy(ref_model, params, tokens, s_max, steps=STEPS):
    pre = jax.jit(ref_build_prefill(ref_model))
    dec = jax.jit(ref_build_decode(ref_model))
    return _greedy(lambda c, t: pre(params, c, {"tokens": jnp.asarray(t)}),
                   lambda c, t: dec(params, c, jnp.asarray(t)),
                   ref_model.make_caches(B, s_max), tokens, steps, _f32)


def _port_greedy(port, tokens, s_max, steps=STEPS):
    pre, dec = build_prefill(port), build_decode(port)
    return _greedy(lambda c, t: pre(c, {"tokens": torch.from_numpy(t)}),
                   lambda c, t: dec(c, torch.from_numpy(t)),
                   port.make_caches(B, s_max), tokens, steps, _f32)


@functools.lru_cache(maxsize=None)
def _ref_xla_greedy(arch):
    ref_model, params, _ = _models(ref_configs.get_arch(arch).smoke,
                                   "float32", "xla")
    tokens = _tokens(ref_model.cfg.vocab)
    return tokens, _ref_greedy(ref_model, params, tokens, S + STEPS)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_xla(arch, impl):
    """Whatever the port's attention impl, its decode is the reference's
    correct ("xla") decode: same greedy tokens, logits at 1e-4 (fp32)."""
    tokens, (want_seq, want_logits) = _ref_xla_greedy(arch)
    _, _, port = _models(ref_configs.get_arch(arch).smoke, "float32", impl)
    got_seq, got_logits = _port_greedy(port, tokens, S + STEPS)
    np.testing.assert_array_equal(got_seq, want_seq)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_reference_pallas_decode_fault_is_not_copied():
    """The reference's flash wrapper (``repro/kernels/ops.py:36``) drops
    q_positions/kv_positions/kv_valid, so its "pallas" decode attends the
    new token as if it stood at position 0 (max |diff| 3.1 on this config
    and these draws). Its prefill is right: the causal mask hides the
    empty slots of a fresh cache. The port routes cached calls to
    attend_xla."""
    cfg = RefConfig(name="probe", family="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                    dtype=jnp.float32)
    ref_x, params, _ = _models(cfg, "float32", "xla")
    ref_p, _, port = _models(cfg, "float32", "pallas")
    tokens = _tokens(cfg.vocab)
    s_max = S + 4
    _, xla_logits = _ref_greedy(ref_x, params, tokens, s_max, steps=1)
    _, pal_logits = _ref_greedy(ref_p, params, tokens, s_max, steps=1)
    _, port_logits = _port_greedy(port, tokens, s_max, steps=1)
    np.testing.assert_allclose(pal_logits[0], xla_logits[0], atol=1e-5)
    assert np.abs(pal_logits[1] - xla_logits[1]).max() > 1.0  # the fault
    np.testing.assert_allclose(port_logits[1], xla_logits[1], atol=1e-5,
                               rtol=1e-5)


def test_padded_vocab_and_tied_embeddings_match_reference():
    """``vocab_pad_to`` masks the pad logits with -1e9, ``tie_embeddings``
    reads the logits off ``embed``; loss is forward-only fp32 CE."""
    cfg = RefConfig(name="pad", family="dense", n_layers=1, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=48, vocab=90,
                    vocab_pad_to=96, tie_embeddings=True, window=5,
                    dtype=jnp.float32)
    ref_model, params, port = _models(cfg, "float32", "pallas")
    tokens = _tokens(cfg.vocab, n=12)
    labels = np.where(np.arange(12) % 3 == 0, -1, tokens).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(tokens),
               "labels": torch.from_numpy(labels)}
    want = jax.jit(ref_model._forward_train)(params, batch_j)
    got = port._forward_train(batch_t)
    assert "unembed" not in dict(port.named_parameters())
    np.testing.assert_array_equal(got[..., 90:].numpy(), -1e9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(port.loss(batch_t)),
                               float(jax.jit(ref_model.loss)(params, batch_j)),
                               rtol=1e-5)
    assert param_count(port) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    assert tree_bytes(port) == 4 * param_count(port)


def test_params_from_jax_refuses_a_tree_of_another_config():
    smoke = ref_configs.get_arch("tinyllama-1.1b").smoke
    params, _ = ref_build(smoke).init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    other = port_configs.get_arch("qwen1.5-0.5b").smoke
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, other)
    state = params_from_jax(tree, port_configs.get_arch(
        "tinyllama-1.1b").smoke, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    np.testing.assert_array_equal(
        state["blocks.wq"].float().numpy(),
        np.asarray(params["blocks"]["wq"], np.float32))


def test_params_from_jax_defaults_to_cuda():
    """Without ``device`` the weights go to CUDA, as every entry point of
    the port does: with no card that raises instead of landing on the CPU;
    ``device="cpu"`` is honoured when asked for."""
    cfg = port_configs.get_arch("tinyllama-1.1b").smoke
    params, _ = ref_build(ref_configs.get_arch("tinyllama-1.1b").smoke).init(
        jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    if torch.cuda.is_available():
        state = params_from_jax(tree, cfg)
        assert all(t.is_cuda for t in state.values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax(tree, cfg)
    state = params_from_jax(tree, cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in state.values())


def test_seeded_initialisation_is_reproducible():
    cfg = port_configs.get_arch("tinyllama-1.1b").smoke
    a, b = (DenseLM(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    c = DenseLM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    for name, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[name])
    assert not torch.equal(a.blocks["wq"], c.blocks["wq"])
    w = a.blocks["w_gate"].float()
    assert float(w.abs().max()) <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 0.88) < 0.05


def test_large_leaves_are_drawn_slice_by_slice(monkeypatch):
    """A leaf within ``DRAW_SLICE`` is one truncated-normal draw, as before
    the limit; a larger one is drawn one leading slice at a time (no fp32
    temporary of the whole leaf), each slice the next draw of the same
    generator, at the whole leaf's fan-in."""
    import math

    from repro_torch.models import common

    def factory(seed):
        return common.ParamFactory(torch.Generator().manual_seed(seed),
                                   dtype=torch.bfloat16,
                                   device=torch.device("cpu"))

    shape = (3, 4, 16, 8)
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=torch.Generator().manual_seed(7))
    one = factory(7).dense(shape)
    assert torch.equal(one, (w / math.sqrt(16)).to(torch.bfloat16))

    monkeypatch.setattr(common, "DRAW_SLICE", 4 * 16 * 8)
    sliced = factory(7).dense(shape)
    gen = torch.Generator().manual_seed(7)
    for i in range(3):
        part = torch.empty(shape[1:])
        torch.nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0, generator=gen)
        assert torch.equal(sliced[i], (part / math.sqrt(16)).to(
            torch.bfloat16))
    monkeypatch.setattr(common, "DRAW_SLICE", 16 * 8 - 1)
    deeper = factory(7).dense(shape)  # slices of slices
    assert deeper.shape == shape and float(deeper.abs().max()) <= 0.5
    assert torch.equal(deeper, factory(7).dense(shape))
