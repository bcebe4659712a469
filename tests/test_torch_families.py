"""The port's other model families vs the reference, on the CPU.

The smoke configs of phi3.5-moe and qwen3-moe (MoE), recurrentgemma
(RG-LRU hybrid), seamless-m4t (enc-dec audio), xlstm (sLSTM + mLSTM) and
internvl2 (the dense backbone with a vision prefix) are built in the
reference from ``jax.random.key(0)`` and carried into ``repro_torch`` with
``params_from_jax``. Then, on the same numpy tokens, source frames and
prefix embeddings:

  - the loss, the prefill's last logits and every field of the cache or
    recurrent state agree at 1e-4 in fp32 and 5e-2 in bf16 (the tolerances
    of ``test_torch_models.py``: products and scans sum in another order),
    under ``attention_impl="xla"`` and ``"pallas"`` (the reference's Pallas
    kernel in interpret mode, the port's plain flash version);
  - three greedy decode steps agree with the reference's ``"xla"`` decode
    (its ``"pallas"`` decode drops the cache positions: ROADMAP queue 3),
    the port fed the reference's greedy tokens, and in fp32 choosing them.

The serve-agreement checks of ``tests/test_system.py`` (decode vs the
whole-sequence forward for the hybrid and audio families, prefill vs
token-by-token decode for the ssm family) are repeated on the port's own
seeded models, and the bf16 gap between decode and forward is held to the
reference's own at a mid width (bf16 rounding alone moves the hybrid and
ssm models' logits by more than 6e-2 at full width), as is the MoE
family's bf16 gap between its ``"pallas"`` and ``"xla"`` prefills.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.api import ModelConfig as RefConfig
from repro.models.api import build_model as ref_build
from repro_torch.models.api import ModelConfig as PortConfig
from repro_torch.models.api import build_model, model_class
from repro_torch.models.weights import params_from_jax
from repro_torch.serve.engine import build_decode, build_prefill

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "recurrentgemma-9b",
         "seamless-m4t-large-v2", "xlstm-1.3b", "internvl2-76b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, S, STEPS, S_SRC = 2, 16, 3, 12


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, dt, impl):
    """(reference model, its params, port model with the same weights)."""
    ref_cfg = ref_configs.get_arch(arch).smoke
    jdt, tdt, _ = DTYPES[dt]
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(RefConfig)}
    fields.update(attention_impl=impl, dtype=tdt)
    pcfg = PortConfig(**fields)
    ref_model = ref_build(dataclasses.replace(ref_cfg, attention_impl=impl,
                                              dtype=jdt))
    params, _ = ref_model.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = model_class(pcfg.family).from_state(
        pcfg, params_from_jax(tree, pcfg, device="cpu"))
    return ref_model, params, port


def _inputs(cfg, seed=1):
    """numpy tokens, labels and the family's extra inputs (float32)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.where(np.arange(S) % 5 == 0, -1, rng.integers(
        0, cfg.vocab, (B, S))).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["src_frames"] = rng.standard_normal(
            (B, S_SRC, cfg.d_model)).astype(np.float32)
    return tokens, labels, extra


def _batches(tokens, extra, dt, labels=None):
    jdt, tdt, _ = DTYPES[dt]
    jb = {"tokens": jnp.asarray(tokens),
          **{k: jnp.asarray(v, jdt) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(tokens),
          **{k: torch.from_numpy(v).to(tdt) for k, v in extra.items()}}
    if labels is not None:
        jb["labels"], tb["labels"] = jnp.asarray(labels), \
            torch.from_numpy(labels)
    return jb, tb


def _caches(model, cfg):
    kw = {"s_src": S_SRC} if cfg.family == "audio" else {}
    return model.make_caches(B, S + STEPS + cfg.n_prefix_tokens, **kw)


def _assert_cache_equal(got, want, tol):
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(g), _f32(w), atol=tol, rtol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_and_caches_match_reference(arch, dt, impl):
    tol = DTYPES[dt][2]
    ref_model, params, port = _models(arch, dt, impl)
    cfg = port.cfg
    tokens, labels, extra = _inputs(cfg)
    jb, tb = _batches(tokens, extra, dt, labels)
    want = float(jax.jit(ref_model.loss)(params, jb))
    got = port.loss(tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, atol=tol, rtol=tol)

    jb.pop("labels")
    tb.pop("labels")
    want_l, want_c = jax.jit(ref_model.prefill)(
        params, _caches(ref_model, cfg), jb)
    got_l, got_c = build_prefill(port)(_caches(port, cfg), tb)
    assert got_l.dtype == DTYPES[dt][1]
    assert tuple(got_l.shape) == want_l.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(_f32(got_l), _f32(want_l), atol=tol, rtol=tol)
    _assert_cache_equal(got_c, want_c, tol)


@functools.lru_cache(maxsize=None)
def _ref_xla_greedy(arch, dt):
    """The reference's "xla" prefill and greedy decode: (tokens chosen,
    logits of each step)."""
    ref_model, params, _ = _models(arch, dt, "xla")
    cfg = ref_model.cfg
    tokens, _, extra = _inputs(cfg)
    jb, _ = _batches(tokens, extra, dt)
    logits, cache = jax.jit(ref_model.prefill)(
        params, _caches(ref_model, cfg), jb)
    dec = jax.jit(ref_model.decode_step)
    chosen, out = [], [_f32(logits)]
    for _ in range(STEPS):
        nxt = out[-1][:, -1].argmax(-1)[:, None].astype(np.int32)
        chosen.append(nxt)
        logits, cache = dec(params, cache, jnp.asarray(nxt))
        out.append(_f32(logits))
    return chosen, out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference_xla(arch, dt, impl):
    """Whatever the port's attention impl, its decode is the reference's
    correct ("xla") decode, step by step on the reference's tokens."""
    tol = DTYPES[dt][2]
    chosen, want = _ref_xla_greedy(arch, dt)
    _, _, port = _models(arch, dt, impl)
    tokens, _, extra = _inputs(port.cfg)
    _, tb = _batches(tokens, extra, dt)
    logits, cache = build_prefill(port)(_caches(port, port.cfg), tb)
    got = [_f32(logits)]
    decode = build_decode(port)
    for nxt in chosen:
        if dt == "float32":
            np.testing.assert_array_equal(got[-1][:, -1].argmax(-1), nxt[:, 0])
        logits, cache = decode(cache, torch.from_numpy(nxt))
        got.append(_f32(logits))
    assert int(cache.length.min()) == S + STEPS + port.cfg.n_prefix_tokens
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# tests/test_system.py's serve agreement, on the port's own seeded models
# ---------------------------------------------------------------------------


def _decode_matches_forward(cfg, extra=None, steps=3, atol=6e-2):
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    kw = {"s_src": 8} if cfg.family == "audio" else {}
    cache = model.make_caches(2, 24 + steps, **kw)
    logits, cache = model.prefill(cache, {"tokens": tokens, **(extra or {})})
    seq = tokens
    for _ in range(steps):
        nxt = logits[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = model.decode_step(cache, nxt)
    full = model._forward_train({"tokens": seq, **(extra or {})})
    np.testing.assert_allclose(_f32(logits[:, -1]),
                               _f32(full[:, -1, :cfg.vocab]), atol=atol,
                               rtol=atol)
    last = model._forward_train({"tokens": seq, **(extra or {})}, last=True)
    assert torch.equal(last, full[:, -1:])  # the phase-14 check's form


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_matches_forward_griffin(impl):
    _decode_matches_forward(PortConfig(
        name="g", family="hybrid", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=91, window=8,
        block_pattern=("rec", "rec", "attn"), pattern_tail=("rec", "rec"),
        rnn_state_dim=64, attention_impl=impl))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_matches_forward_encdec(impl):
    src = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 64)).astype(np.float32))
    _decode_matches_forward(PortConfig(
        name="e", family="audio", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=83, norm="layer",
        enc_layers=2, dec_layers=2, attention_impl=impl),
        extra={"src_frames": src})


def test_prefill_matches_stepwise_xlstm():
    cfg = PortConfig(name="x", family="ssm", n_layers=4, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=0, vocab=77,
                     slstm_period=2)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 77, (2, 32)))
    lp, st1 = model.prefill(model.make_caches(2, 0), {"tokens": tokens})
    st2 = model.make_caches(2, 0)
    for t in range(32):
        ld, st2 = model.decode_step(st2, tokens[:, t:t + 1])
    np.testing.assert_allclose(_f32(lp), _f32(ld), atol=6e-2, rtol=6e-2)
    np.testing.assert_allclose(_f32(st1.m_C), _f32(st2.m_C), atol=6e-2,
                               rtol=6e-2)
    assert torch.equal(st1.length, st2.length)


_GAP_CONFIGS = {
    "hybrid": dict(name="g", family="hybrid", n_layers=5, d_model=1024,
                   n_heads=4, n_kv_heads=1, d_ff=3072, vocab=512, window=64,
                   block_pattern=("rec", "rec", "attn"),
                   pattern_tail=("rec", "rec"), rnn_state_dim=1024),
    "ssm": dict(name="x", family="ssm", n_layers=8, d_model=512, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab=512, slstm_period=4),
}


def _serving_gap(prefill, decode, forward, tokens, s):
    """max |last decode logits - forward logits at the last position| after
    a prefill of ``tokens[:, :s]`` and a decode of the rest."""
    logits, cache = prefill(tokens[:, :s])
    for t in range(s, tokens.shape[1]):
        logits, cache = decode(cache, tokens[:, t:t + 1])
    full = forward(tokens)
    return float(np.abs(_f32(logits)[:, -1] - _f32(full)[:, -1]).max())


@pytest.mark.parametrize("family", list(_GAP_CONFIGS))
def test_bf16_serving_gap_is_the_references(family):
    """In bf16 a model's decode and its whole-sequence forward differ by
    rounding alone, and for the hybrid and ssm families at full width by
    more than the 6e-2 serving tolerance, in the reference as in the port
    (so ``chip_smoke.py`` phase 14 measures that gap and holds the
    agreement in fp32). At a mid width the port's gap is the reference's:
    at most twice it plus 1e-2 (the two frameworks round elementwise chains
    at other places). In fp32 the port's gap is under 1e-4."""
    base = _GAP_CONFIGS[family]
    ref_model = ref_build(RefConfig(**base, dtype=jnp.bfloat16))
    params, _ = ref_model.init(jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, 512, (1, 132)).astype(
        np.int32)
    ref_pre, ref_dec = jax.jit(ref_model.prefill), jax.jit(
        ref_model.decode_step)
    ref_gap = _serving_gap(
        lambda t: ref_pre(params, ref_model.make_caches(1, 132),
                          {"tokens": jnp.asarray(t)}),
        lambda c, t: ref_dec(params, c, jnp.asarray(t)),
        lambda t: jax.jit(ref_model._forward_train)(
            params, {"tokens": jnp.asarray(t)}), tokens, 128)
    gaps = {}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = PortConfig(**base, dtype=dtype)
        port = model_class(family).from_state(
            cfg, params_from_jax(tree, cfg, device="cpu", dtype=dtype))
        t = torch.from_numpy(tokens)
        gaps[dtype] = _serving_gap(
            lambda x: port.prefill(port.make_caches(1, 132), {"tokens": x}),
            port.decode_step,
            lambda x: port._forward_train({"tokens": x}, last=True), t, 128)
    assert gaps[torch.bfloat16] <= 2 * ref_gap + 1e-2, (gaps, ref_gap)
    assert gaps[torch.float32] < 1e-4, gaps


_MOE_GAP = dict(name="m", family="moe", n_layers=4, d_model=512, n_heads=4,
                n_kv_heads=2, d_ff=512, vocab=512, n_experts=8, top_k=2)


def test_bf16_moe_impl_gap_is_the_references():
    """The MoE family's prefill under ``"pallas"`` and under ``"xla"``
    differs in bf16 by rounding alone (``chip_smoke.py`` phase 14 compares
    the two there, since capacity dispatch depends on how tokens are
    grouped and decode is another function than the forward). At a mid
    width the port's gap is the reference's: at most twice it plus 1e-2.
    In fp32 the port's gap is under 1e-4."""
    tokens = np.random.default_rng(2).integers(0, 512, (1, 128)).astype(
        np.int32)
    params, ref = None, {}
    for impl in ("pallas", "xla"):
        model = ref_build(RefConfig(**_MOE_GAP, dtype=jnp.bfloat16,
                                    attention_impl=impl))
        if params is None:
            params, _ = model.init(jax.random.key(0))
        ref[impl], _ = jax.jit(model.prefill)(
            params, model.make_caches(1, 128), {"tokens": jnp.asarray(tokens)})
    ref_gap = float(np.abs(_f32(ref["pallas"]) - _f32(ref["xla"])).max())
    tree = jax.tree_util.tree_map(np.asarray, params)
    gaps = {}
    for dtype in (torch.bfloat16, torch.float32):
        out = {}
        for impl in ("pallas", "xla"):
            cfg = PortConfig(**_MOE_GAP, dtype=dtype, attention_impl=impl)
            port = model_class("moe").from_state(
                cfg, params_from_jax(tree, cfg, device="cpu", dtype=dtype))
            out[impl], _ = port.prefill(port.make_caches(1, 128),
                                        {"tokens": torch.from_numpy(tokens)})
        gaps[dtype] = float(np.abs(_f32(out["pallas"])
                                   - _f32(out["xla"])).max())
    assert gaps[torch.bfloat16] <= 2 * ref_gap + 1e-2, (gaps, ref_gap)
    assert gaps[torch.float32] < 1e-4, gaps
