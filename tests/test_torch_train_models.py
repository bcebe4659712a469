"""The port's training halves of the model zoo vs the reference, on the CPU.

Every architecture's smoke config, in fp32, is built in the reference from
``jax.random.key(0)`` and carried into ``repro_torch`` with
``params_from_jax``. On the same numpy batch the port's ``loss`` and its
gradients (``loss.backward()``) are held to ``jax.value_and_grad(
model.loss)``: the loss within 1e-5 relative, every gradient leaf within
1e-4 x that leaf's max|g|. Then the parts on their own:

  - ``attend_chunked`` (a ``torch.autograd.Function``) against the
    reference's ``attend_chunked`` (its ``jax.custom_vjp``), and the
    ``"chunked"`` model at S=2,048 on a one-layer d=64 cut, where the
    dispatch engages it;
  - the sLSTM scan's custom VJP against ``jax.grad`` through the
    reference's ``_slstm_scan_core``;
  - MoE's ``aux_load_balance_loss`` within 1e-6;
  - the remat policies, which change memory and never the loss (1e-6);
  - ``"pallas"`` under autograd raises, and serving stays frozen.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.attention as ref_attn
import repro.models.xlstm as ref_xlstm
from repro.models.api import ModelConfig as RefConfig
from repro.models.api import build_model as ref_build
from repro_torch.models import attention as port_attn
from repro_torch.models import xlstm as port_xlstm
from repro_torch.models.api import ModelConfig as PortConfig
from repro_torch.models.api import model_class
from repro_torch.models.weights import _flatten, params_from_jax
from repro_torch.train.step import loss_and_grads

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")


def port_config(ref_cfg: RefConfig, **over) -> PortConfig:
    """The port's config with the reference config's fields, fp32."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(RefConfig)}
    fields.update(dtype=torch.float32, **over)
    return PortConfig(**fields)


@functools.lru_cache(maxsize=None)
def _ref(ref_cfg: RefConfig):
    """(reference model, its params at key 0) for an fp32 config."""
    model = ref_build(ref_cfg)
    return model, model.init(jax.random.key(0))[0]


def models(ref_cfg: RefConfig, **over):
    """(reference model, params, port model with the same weights)."""
    ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.float32, **over)
    ref_model, params = _ref(ref_cfg)
    pcfg = port_config(ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = model_class(pcfg.family).from_state(
        pcfg, params_from_jax(tree, pcfg, device="cpu"))
    return ref_model, params, port


def batch_arrays(cfg, B, S, seed=1):
    """numpy tokens, labels (every fifth masked) and the family's extra
    inputs."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": np.where(np.arange(S) % 5 == 0, -1, rng.integers(
               0, cfg.vocab, (B, S))).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["src_frames"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    return out


def port_grads(port, tb, fn=None):
    """(loss, {name: grad}) of ``fn(port)`` (default: its loss on tb)."""
    loss, grads = loss_and_grads(
        port, lambda: port.loss(tb) if fn is None else fn(port))
    return float(loss), grads


def assert_grads_match(got: dict, want: dict, tol=GRAD_TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().float().numpy()
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=name)


def check_loss_and_grads(ref_model, params, port, arrays):
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    want_loss, want = jax.jit(jax.value_and_grad(ref_model.loss))(params, jb)
    loss, got = port_grads(port, tb)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert_grads_match(got, _flatten(jax.tree_util.tree_map(np.asarray,
                                                            want)))


@pytest.mark.parametrize("arch", list(ref_configs.ARCHS))
def test_loss_and_grads_match_reference(arch):
    ref_model, params, port = models(ref_configs.get_arch(arch).smoke)
    S = 16 if arch in RECURRENT else 32
    check_loss_and_grads(ref_model, params, port,
                         batch_arrays(port.cfg, 2, S))


def _chunk_cut():
    return RefConfig(name="chunk-cut", family="dense", n_layers=1,
                     d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                     vocab=97, attention_impl="chunked")


def test_chunked_model_at_2048_matches_reference_and_xla():
    """At S=2,048 the dispatch takes ``attend_chunked``; its gradients are
    the reference's, and the port's ``"xla"`` path's."""
    ref_model, params, port = models(_chunk_cut())
    arrays = batch_arrays(port.cfg, 1, 2048)
    check_loss_and_grads(ref_model, params, port, arrays)
    _, _, xla = models(_chunk_cut(), attention_impl="xla")
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    loss_c, g_c = port_grads(port, tb)
    loss_x, g_x = port_grads(xla, tb)
    np.testing.assert_allclose(loss_c, loss_x, rtol=LOSS_RTOL)
    assert_grads_match(g_c, {k: v.numpy() for k, v in g_x.items()})


@pytest.mark.parametrize("causal, window, H, KVH, S", [
    (True, None, 4, 2, 320), (True, 100, 4, 4, 256), (False, None, 2, 1, 192),
])
def test_attend_chunked_vjp_matches_reference(causal, window, H, KVH, S):
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (2, S, H, 16), (2, S, KVH, 16), (2, S, KVH, 16), (2, S, H, 16)))
    fn = functools.partial(ref_attn.attend_chunked, causal=causal,
                           window=window)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = port_attn.attend_chunked(tq, tk, tv, causal=causal, window=window)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_attend_chunked_dispatch_is_the_references():
    """``impl="chunked"`` engages only for self-attention with Sq >= 2048,
    no ``kv_valid`` and a chunk dividing Sk; otherwise ``attend_xla``."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 8), np.float32))
    out = port_attn.attend(q, q, q, impl="chunked", causal=True)
    assert torch.equal(out, port_attn.attend_xla(q, q, q, causal=True))
    calls = []
    real = port_attn.attend_chunked
    try:
        port_attn.attend_chunked = lambda *a, **kw: calls.append(1) or a[0]
        big = torch.zeros((1, 2048, 2, 8))
        port_attn.attend(big, big, big, impl="chunked", causal=True)
        port_attn.attend(big, big, big, impl="chunked", causal=True,
                         kv_valid=torch.ones((1, 2048), dtype=torch.bool))
        port_attn.attend(big, big[:, :2047], big[:, :2047], impl="chunked",
                         causal=True)
        port_attn.attend(torch.zeros((1, 2050, 2, 8)),
                         torch.zeros((1, 2050, 2, 8)),
                         torch.zeros((1, 2050, 2, 8)), impl="chunked",
                         causal=True)
    finally:
        port_attn.attend_chunked = real
    assert calls == [1]


def test_slstm_vjp_matches_reference_custom_vjp():
    """The port's ``_SLSTMScan`` against ``jax.grad`` through the
    reference's ``_slstm_scan_core``, with cotangents on every output."""
    rng = np.random.default_rng(5)
    S, B, NH, dh = 12, 2, 2, 4
    D = NH * dh
    wx = rng.standard_normal((S, B, 4, D)).astype(np.float32)
    r = (0.3 * rng.standard_normal((NH, dh, 4 * dh))).astype(np.float32)
    c0, n0, h0 = (0.1 * rng.standard_normal((B, D))).astype(np.float32), \
        np.abs(rng.standard_normal((B, D))).astype(np.float32), \
        (0.1 * rng.standard_normal((B, D))).astype(np.float32)
    m0 = np.full((B, D), -1e9, np.float32)
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in [(B, D)] * 4 + [(S, B, D)]]

    def ref_obj(wx, r, c0, n0, m0, h0):
        (c, n, m, h), hs = ref_xlstm._slstm_scan_core(wx, r, c0, n0, m0, h0,
                                                      NH, dh)
        return sum(jnp.sum(a * b) for a, b in zip((c, n, m, h, hs), cot))

    args = (wx, r, c0, n0, m0, h0)
    want = jax.grad(ref_obj, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    outs = port_xlstm._SLSTMScan.apply(*targs)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)) \
        .backward()
    for name, t, w in zip(("wx", "r", "c0", "n0", "m0", "h0"), targs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_aux_load_balance_loss_matches_reference(arch):
    ref_model, params, port = models(ref_configs.get_arch(arch).smoke)
    arrays = batch_arrays(port.cfg, 2, 32)
    jb = {"tokens": jnp.asarray(arrays["tokens"])}
    want, want_g = jax.value_and_grad(ref_model.aux_load_balance_loss)(
        params, jb)
    got, got_g = port_grads(port, None, fn=lambda m: m.aux_load_balance_loss(
        {"tokens": torch.from_numpy(arrays["tokens"])}))
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    assert_grads_match(got_g, _flatten(jax.tree_util.tree_map(np.asarray,
                                                              want_g)))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi3.5-moe-42b-a6.6b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "xlstm-1.3b"])
def test_remat_changes_no_value(arch, policy):
    smoke = ref_configs.get_arch(arch).smoke
    _, _, plain = models(smoke)
    _, _, remat = models(smoke, remat_policy=policy)
    assert remat.cfg.remat_policy == policy
    tb = {k: torch.from_numpy(v)
          for k, v in batch_arrays(plain.cfg, 2, 16).items()}
    loss_p, g_p = port_grads(plain, tb)
    loss_r, g_r = port_grads(remat, tb)
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-6)
    assert_grads_match(g_r, {k: v.numpy() for k, v in g_p.items()}, tol=1e-6)


def test_pallas_under_autograd_raises_and_serving_stays_frozen():
    smoke = ref_configs.get_arch("tinyllama-1.1b").smoke
    _, _, port = models(smoke, attention_impl="pallas")
    assert not any(p.requires_grad for p in port.parameters())
    tb = {k: torch.from_numpy(v)
          for k, v in batch_arrays(port.cfg, 2, 16).items()}
    assert not port._forward_train(tb).requires_grad
    for p in port.parameters():
        p.requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        port.loss(tb)
    # serving under inference_mode still runs the kernel's plain version
    logits, _ = port.prefill(port.make_caches(2, 20), tb)
    assert logits.shape == (2, 1, smoke.vocab) and not logits.requires_grad
