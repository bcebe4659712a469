"""The port's attention, norms, RoPE and KV cache vs the reference, on the CPU.

``repro_torch.kernels.flash_attention.flash_attention_plain`` (what the
port runs on the CPU, and what the CUDA kernel is held to on the card) is
compared with the Pallas kernel ``flash_attention_fwd`` in interpret mode
and with ``attention_ref``, on the CASES of ``test_kernels_attention.py``:
1e-5 in fp32 (sums in another order), 2e-2 in bf16 (the output's rounding).
A test-local emulation of the bf16 CUDA kernel's rounding (which cannot
run here) is held to the same references, and the wrapper's pure-Python
parts (the kernel chosen by dtype, the TMA stride check, the build key)
are tested on CPU tensors. ``attend_xla``, the norms, RoPE and the cache are
compared with ``repro.models`` on the same numpy inputs. Run with
``REPRO_PALLAS_INTERPRET=1`` as the JAX suite is (off a TPU the Pallas
kernels run in interpret mode either way).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
import repro.models.common as ref_common
import repro_torch.models.attention as port_attn
import repro_torch.models.common as port_common
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.ref import attention_ref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as port_ops

# (B, S, H, KVH, Dh, causal, window, dtype, block): test_kernels_attention.py
CASES = [
    (2, 128, 4, 4, 64, True, None, "float32", 64),
    (2, 256, 4, 2, 64, True, None, "float32", 128),
    (1, 256, 8, 1, 128, True, None, "bfloat16", 128),
    (2, 256, 4, 1, 64, True, 128, "bfloat16", 64),
    (1, 128, 2, 2, 64, False, None, "float32", 64),
    (1, 512, 4, 4, 128, True, 256, "float32", 128),
    (3, 192, 6, 3, 64, True, None, "bfloat16", 64),
]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 just above a power of two


def _qkv(seed, B, S, H, KVH, Dh, scale=1.0, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32) * scale
    k = rng.standard_normal((B, Sk, KVH, Dh)).astype(np.float32) * scale
    v = rng.standard_normal((B, Sk, KVH, Dh)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    """The same values in both frameworks (bf16 rounds alike in both)."""
    j = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:7]) for c in CASES])
def test_plain_version_matches_pallas_kernel_and_oracle(case):
    B, S, H, KVH, Dh, causal, window, dt, blk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S * H + Dh, B, S, H, KVH, Dh), dt)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH[dt] and got.shape == (B, S, H, Dh)
    kern = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                               block_q=blk, block_k=blk, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64), (64, 128), (256, 256)])
def test_plain_version_matches_every_pallas_tiling(blocks):
    """The Pallas kernel's block shapes carry no meaning: each tiling of it
    agrees with the one plain version at 1e-5."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(7, 1, 256, 2, 2, 64), "float32")
    kern = flash_attention_fwd(jq, jk, jv, causal=True, block_q=blocks[0],
                               block_k=blocks[1], interpret=True)
    got = fa.flash_attention_plain(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), atol=1e-5, rtol=1e-5)


# (B, Sq, Sk, H, KVH, Dh, causal, window, dtype, block_q, block_k): the
# shapes the hybrid and audio families bring to the kernel. Dh=256 with and
# without a window (RecurrentGemma's head dim); Sq != Sk both ways, causal
# (the mask aligned top-left, kp <= qp) and not (cross-attention).
NEW_SHAPES = [
    (1, 128, 128, 4, 1, 256, True, None, "float32", 64, 64),
    (2, 128, 128, 4, 1, 256, True, 48, "float32", 32, 64),
    (1, 64, 64, 2, 2, 256, False, None, "bfloat16", 64, 32),
    (2, 128, 128, 4, 1, 256, True, 100, "bfloat16", 64, 64),
    (2, 32, 128, 4, 2, 64, True, None, "float32", 32, 64),
    (2, 32, 128, 4, 2, 64, False, None, "float32", 32, 64),
    (2, 128, 32, 4, 2, 64, True, None, "float32", 64, 32),
    (2, 128, 32, 4, 2, 128, False, None, "bfloat16", 64, 32),
    (1, 16, 96, 4, 4, 256, False, None, "bfloat16", 16, 32),
    (1, 96, 64, 4, 1, 256, True, None, "bfloat16", 32, 64),
]


@pytest.mark.parametrize("case", NEW_SHAPES, ids=[str(c[:9]) for c in NEW_SHAPES])
def test_plain_version_matches_pallas_kernel_at_new_shapes(case):
    B, Sq, Sk, H, KVH, Dh, causal, window, dt, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _both(
        _qkv(Sq * 7 + Sk, B, Sq, H, KVH, Dh, Sk=Sk), dt)
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH[dt] and got.shape == (B, Sq, H, Dh)
    kern = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                               block_q=bq, block_k=bk, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_plain_version_gives_zero_for_a_row_that_sees_no_key():
    """With Sq > Sk and a window, late rows see no key: the plain version
    and the sm90 kernel give 0 there (softmax alone gives NaN)."""
    _, (tq, tk, tv) = _both(_qkv(2, 1, 40, 2, 2, 64, Sk=8), "float32")
    got = fa.flash_attention_plain(tq, tk, tv, causal=True, window=4)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, 11:], torch.zeros_like(got[:, 11:]))
    assert bool(got[:, :11].abs().sum(-1).gt(0).all())


def test_ops_flash_attention_runs_plain_version_on_cpu():
    _, (tq, tk, tv) = _both(_qkv(3, 2, 100, 4, 2, 64), "float32")
    before, by_kernel = fa.launches, dict(fa.launches_by_kernel)
    got = port_ops.flash_attention(tq, tk, tv, causal=True, window=40)
    want = fa.flash_attention_plain(tq, tk, tv, causal=True, window=40)
    assert torch.equal(got, want)
    assert fa.launches == before  # no kernel on the CPU
    assert fa.launches_by_kernel == by_kernel


def test_ops_flash_attention_refuses_what_the_kernel_cannot_honour():
    """Positions and ``kv_valid`` raise (the reference's wrapper drops
    them: ROADMAP queue 3); Sq != Sk is the kernel's own contract now and
    runs the plain version with implicit positions."""
    _, (tq, tk, tv) = _both(_qkv(3, 2, 16, 4, 2, 64), "float32")
    pos = torch.arange(16).expand(2, 16)
    with pytest.raises(ValueError, match="kv_valid"):
        port_ops.flash_attention(tq, tk, tv, kv_valid=pos >= 0)
    with pytest.raises(ValueError, match="q_positions"):
        port_ops.flash_attention(tq, tk, tv, q_positions=pos)
    with pytest.raises(ValueError, match="kv_positions"):
        port_attn.attend(tq[:, -1:], tk, tv, impl="pallas", causal=True,
                         kv_positions=pos)
    for causal in (True, False):
        got = port_ops.flash_attention(tq[:, -1:], tk, tv, causal=causal)
        want = fa.flash_attention_plain(tq[:, -1:], tk, tv, causal=causal)
        assert got.shape == (2, 1, 4, 64) and torch.equal(got, want)
    got = port_attn.attend(tq[:, :5], tk, tv, impl="pallas", causal=False)
    want = port_attn.attend_xla(tq[:, :5], tk, tv, causal=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # "chunked" is ported: at Sq < 2048 it is attend_xla, as in the
    # reference's dispatch (tests/test_torch_train_models.py holds the rest)
    assert torch.equal(port_attn.attend(tq, tk, tv, impl="chunked",
                                        causal=True),
                       port_attn.attend_xla(tq, tk, tv, causal=True))


def test_cuda_wrapper_rejects_cpu_tensors():
    _, (tq, tk, tv) = _both(_qkv(3, 1, 8, 2, 2, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(tq, tk, tv)


# ---------------------------------------------------------------------------
# The bf16 kernel's numerics, and the wrapper's pure-Python parts
# ---------------------------------------------------------------------------


def _sm90_emulation(q, k, v, *, causal, window, block=128):
    """The rounding of ``csrc/flash_attention_sm90.cu``, in torch on the CPU:
    bf16 q, k, v; S = Q.K^T in fp32; the scale (times log2 e) applied to the
    fp32 S; the fp32 online softmax with exp2 over kv tiles of ``block``
    rows; P rounded to bf16 before an fp32-accumulated P.V; l summed from
    the fp32 p; O / l (0 where l == 0), rounded to bf16."""
    _, s, h, dh = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    kf, vf = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * np.float32(
        dh ** -0.5 * np.log2(np.e))
    qp, kp = torch.arange(s)[:, None], torch.arange(sk)[None, :]
    mask = torch.ones((s, sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = torch.full(logits.shape[:3], float("-inf"))
    l = torch.zeros(logits.shape[:3])
    acc = torch.zeros(logits.shape[:3] + (dh,))
    for k0 in range(0, sk, block):
        st = logits[..., k0:k0 + block]
        mn = torch.maximum(m, st.amax(-1))
        mu = torch.where(mn == float("-inf"), 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(st - mu[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, k0:k0 + block])
        m = mn
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("case", NEW_SHAPES, ids=[str(c[:9]) for c in NEW_SHAPES])
def test_bf16_kernel_numerics_meet_the_contract_at_new_shapes(case):
    """As below, at Dh=256 (64-row kv tiles) and Sq != Sk."""
    B, Sq, Sk, H, KVH, Dh, causal, window, dt, bq, bk = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv(Sq * 7 + Sk, B, Sq, H, KVH, Dh, Sk=Sk))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dt)
    got = _sm90_emulation(tq, tk, tv, causal=causal, window=window,
                          block=64 if Dh == 256 else 128)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sq, H, Dh)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:7]) for c in CASES])
def test_bf16_kernel_numerics_meet_the_reference_contract(case):
    """bf16 products with fp32 sums and a bf16 P stay within the bf16
    contract (2e-2) of the Pallas kernel and ``attention_ref``, on the
    CASES' values rounded to bf16 (given to the references in the case's
    dtype)."""
    B, S, H, KVH, Dh, causal, window, dt, blk = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv(S * H + Dh, B, S, H, KVH, Dh))
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dt)
    got = _sm90_emulation(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, Dh)
    kern = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                               block_q=blk, block_k=blk, interpret=True)
    ref = attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (kern, ref):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("dtype, kernel", [
    (torch.bfloat16, "sm90_bf16"), (torch.float32, "simt_fp32")])
def test_cuda_wrapper_picks_the_kernel_by_dtype(dtype, kernel):
    assert fa.kernel_for(dtype) == kernel
    source, taken = fa.KERNELS[kernel]
    assert taken == dtype
    assert (_build.CSRC / f"{source}.cu").is_file()
    assert set(fa.launches_by_kernel) == set(fa.KERNELS)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_cuda_wrapper_has_no_kernel_for_other_dtypes(dtype):
    with pytest.raises(ValueError, match="bfloat16"):
        fa.kernel_for(dtype)


def _fused_split(B, S, H, KVH, Dh):
    fused = torch.zeros((B, S, H + 2 * KVH, Dh), dtype=torch.bfloat16)
    return fused.split([H, KVH, KVH], dim=2)


# bf16 layouts TMA loads as they lie: contiguous at the prefill's and the
# edge cases' shapes, a fused (B, S, H + 2 KVH, Dh) split, a (B, H, S, Dh)
# transpose, and extent-1 dimensions whose strides are never walked.
TMA_OK = {
    "prefill": lambda: torch.zeros((8, 2048, 32, 64), dtype=torch.bfloat16),
    "S=1": lambda: torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16),
    "S=63 Dh=128": lambda: torch.zeros((2, 63, 8, 128), dtype=torch.bfloat16),
    "S=2064": lambda: torch.zeros((2, 2064, 8, 64), dtype=torch.bfloat16),
    "fused q": lambda: _fused_split(2, 160, 8, 2, 64)[0],
    "fused k": lambda: _fused_split(2, 160, 8, 2, 64)[1],
    "fused v": lambda: _fused_split(2, 160, 8, 2, 64)[2],
    "BHSD transpose": lambda: torch.zeros(
        (2, 8, 160, 64), dtype=torch.bfloat16).transpose(1, 2),
    "H=1 sliced": lambda: torch.zeros(
        (1, 129, 4, 64), dtype=torch.bfloat16)[:, :, 1:2],
}
# and what it cannot: the message names what is wrong
TMA_BAD = {
    "Dh stride 2": (lambda: torch.zeros(
        (1, 64, 2, 128), dtype=torch.bfloat16)[..., ::2], "Dh stride 1"),
    "H stride 136 B": (lambda: torch.zeros(
        (1, 64, 2, 68), dtype=torch.bfloat16)[..., :64], "multiple of 16"),
    "S stride 130 B": (lambda: torch.zeros(
        (1, 64, 65), dtype=torch.bfloat16)[..., :64].unsqueeze(2),
        "multiple of 16"),
    "base 2 B off": (lambda: torch.zeros(
        520, dtype=torch.bfloat16)[1:513].view(1, 4, 2, 64), "aligned"),
}


@pytest.mark.parametrize("name", list(TMA_OK))
def test_tma_check_accepts_layouts_tma_can_load(name):
    fa.check_tma(TMA_OK[name](), "q")


@pytest.mark.parametrize("name", list(TMA_BAD))
def test_tma_check_refuses_what_tma_cannot_load(name):
    make, match = TMA_BAD[name]
    with pytest.raises(ValueError, match=match):
        fa.check_tma(make(), "q")


def test_build_key_covers_every_included_header(tmp_path, monkeypatch):
    """An edit to a header that a source includes, directly or through
    another header, changes the built library's name; an edit to a header
    it does not include does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build._target("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build._target("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._target("k") != before


def test_build_flags_are_per_source():
    assert "-fmad=false" in _build.nvcc_flags("coflow_assign")
    assert "-fmad=false" in _build.nvcc_flags("flash_attention")
    assert "-fmad=false" not in _build.nvcc_flags("flash_attention_sm90")
    assert "sm_90a" in " ".join(_build.nvcc_flags("flash_attention_sm90"))


# ---------------------------------------------------------------------------
# attend_xla: positions, window, kv_valid
# ---------------------------------------------------------------------------

XLA_CASES = [
    # (B, Sq, Sk, H, KVH, causal, window, with positions, with kv_valid)
    (2, 12, 12, 4, 2, True, None, False, False),
    (2, 12, 12, 4, 4, False, None, False, False),
    (2, 12, 12, 6, 2, True, 5, False, False),
    (2, 1, 20, 4, 2, True, None, True, True),      # a decode step
    (2, 4, 20, 4, 1, True, 7, True, True),         # chunk into a cache
    (3, 9, 9, 4, 2, False, 3, True, False),
]


def _positions(rng, B, Sq, Sk):
    start = rng.integers(0, Sk - Sq + 1, B)
    qpos = (start[:, None] + np.arange(Sq)[None, :]).astype(np.int32)
    kpos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kpos[kpos >= (start + Sq)[:, None]] = -1  # empty slots
    return qpos, kpos


@pytest.mark.parametrize("case", XLA_CASES, ids=[str(c) for c in XLA_CASES])
def test_attend_xla_matches_reference(case):
    B, Sq, Sk, H, KVH, causal, window, with_pos, with_valid = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((B, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KVH, 16)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KVH, 16)).astype(np.float32)
    kw_np = {}
    if with_pos:
        qpos, kpos = _positions(rng, B, Sq, Sk)
        kw_np.update(q_positions=qpos, kv_positions=kpos)
        if with_valid:
            kw_np["kv_valid"] = kpos >= 0
    want = ref_attn.attend_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, **{n: jnp.asarray(a) for n, a in kw_np.items()})
    got = port_attn.attend_xla(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
        **{n: torch.from_numpy(a) for n, a in kw_np.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_attend_xla_row_with_no_visible_key_averages_values():
    """The finite NEG_INF: a fully masked row is the mean of v, not NaN
    (``attention_ref`` would give NaN with its -inf)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1, 2, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    valid = np.ones((2, 6), bool)
    valid[1] = False
    want = ref_attn.attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=False, kv_valid=jnp.asarray(valid))
    got = port_attn.attend_xla(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=False,
                               kv_valid=torch.from_numpy(valid))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[1, 0].numpy(), v[1].mean(0), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_attend_xla_casts_probs_to_bf16_before_pv():
    """Probabilities (0.2, 0.3, 0.5) and values (300, -200, 0) cancel
    exactly in fp32; rounded to bf16 before P.V, as the reference does, they
    leave about -0.1. The port must give the reference's -0.1."""
    logits = np.log(np.array([0.2, 0.3, 0.5], np.float32))
    q = np.ones((1, 1, 1, 1), np.float32)
    k = logits.reshape(1, 3, 1, 1)
    v = np.array([300.0, -200.0, 0.0], np.float32).reshape(1, 3, 1, 1)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], "bfloat16")
    want = float(np.asarray(ref_attn.attend_xla(jq, jk, jv, causal=False),
                            np.float32).ravel()[0])
    got = port_attn.attend_xla(tq, tk, tv, causal=False)
    assert got.dtype == torch.bfloat16
    probs = torch.softmax((tq * tk).float().reshape(3), dim=0)
    uncast = float((probs * tv.float().reshape(3)).sum())
    assert abs(want - uncast) > 0.05  # the cast is visible at this input
    assert abs(float(got.float()) - want) <= 1e-2


# ---------------------------------------------------------------------------
# Norms and RoPE: statistics and rotation in fp32, result in the input dtype
# ---------------------------------------------------------------------------


def _assert_bf16_close(got, want):
    """At most one bf16 ulp apart anywhere, and equal almost everywhere:
    the fp32 work is the same, only a transcendental's last bit may
    differ between the frameworks before the final rounding."""
    g, w = _f32(got), _f32(want)
    assert np.all(np.abs(g - w) <= BF16_ULP * np.abs(w) + 1e-30)
    assert np.mean(g == w) > 0.99


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norms_match_reference(dt):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 48)) * 4 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    (jx, jg, jb), (tx, tg, tb) = _both([x, g, b], dt)
    pairs = [(port_common.rms_norm(tx, tg), ref_common.rms_norm(jx, jg)),
             (port_common.layer_norm(tx, tg, tb),
              ref_common.layer_norm(jx, jg, jb))]
    for got, want in pairs:
        assert got.dtype == TORCH[dt]
        if dt == "float32":
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6,
                                       rtol=1e-6)
        else:
            _assert_bf16_close(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.25])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_matches_reference(dt, fraction):
    inv_t, rot_t = port_common.rope_frequencies(64, fraction=fraction)
    inv_j, rot_j = ref_common.rope_frequencies(64, fraction=fraction)
    assert rot_t == rot_j
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    (jx,), (tx,) = _both([x], dt)
    got = port_common.apply_rope(tx, torch.from_numpy(pos), inv_t, rot_t)
    want = ref_common.apply_rope(jx, jnp.asarray(pos), inv_j, rot_j)
    assert got.dtype == TORCH[dt]
    np.testing.assert_array_equal(_f32(got)[..., rot_t:], x[..., rot_t:]
                                  if dt == "float32" else _f32(tx)[..., rot_t:])
    if dt == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=1e-5)
    else:
        _assert_bf16_close(got, want)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

CACHE_CASES = [  # (B, S_max, Sq, starts)
    (2, 10, 4, (0, 3)),
    (2, 10, 1, (9, 4)),      # decode at the last slot
    (2, 6, 4, (4, 5)),       # wraps modulo S_max
    (2, 6, 6, (0, 2)),       # Sq == S_max
    (3, 5, 8, (0, 1, 7)),    # Sq > S_max: only the trailing S_max written
]


@pytest.mark.parametrize("case", CACHE_CASES, ids=[str(c) for c in CACHE_CASES])
def test_kv_cache_update_and_positions_match_reference(case):
    B, s_max, sq, starts = case
    rng = np.random.default_rng(s_max * 10 + sq)
    layer_k = rng.standard_normal((B, s_max, 2, 4)).astype(np.float32)
    layer_v = rng.standard_normal((B, s_max, 2, 4)).astype(np.float32)
    new_k = rng.standard_normal((B, sq, 2, 4)).astype(np.float32)
    new_v = rng.standard_normal((B, sq, 2, 4)).astype(np.float32)
    positions = rng.integers(-1, 50, (B, s_max)).astype(np.int32)
    start = np.array(starts, np.int32)
    qpos = (start[:, None] + np.arange(sq)[None, :]).astype(np.int32)

    wk, wv = ref_attn.kv_cache_layer_update(
        *(jnp.asarray(a) for a in (layer_k, layer_v, new_k, new_v, start)))
    wpos = ref_attn.kv_cache_slot_positions(
        jnp.asarray(positions), jnp.asarray(qpos), jnp.asarray(start))
    tk, tv = torch.from_numpy(layer_k.copy()), torch.from_numpy(layer_v.copy())
    tpos = torch.from_numpy(positions)
    gk, gv = port_attn.kv_cache_layer_update(
        tk, tv, torch.from_numpy(new_k), torch.from_numpy(new_v),
        torch.from_numpy(start))
    gpos = port_attn.kv_cache_slot_positions(tpos, torch.from_numpy(qpos),
                                             torch.from_numpy(start))
    assert gk is tk and gv is tv  # written in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(tpos.numpy(), positions)  # input unchanged


def test_kv_cache_init_matches_reference():
    want = ref_attn.kv_cache_init(3, 2, 7, 4, 8, jnp.float32)
    got = port_attn.kv_cache_init(3, 2, 7, 4, 8, torch.float32, device="cpu")
    for name in ("k", "v", "length", "positions"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.s_max == want.s_max == 7
    assert got.length.dtype == got.positions.dtype == torch.int32


def test_kv_cache_init_defaults_to_cuda():
    """Without ``device`` the cache goes to CUDA: with no card that raises
    instead of landing on the CPU; ``device="cpu"`` is honoured."""
    if torch.cuda.is_available():
        cache = port_attn.kv_cache_init(2, 1, 4, 2, 8, torch.float32)
        assert all(t.is_cuda for t in cache)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_attn.kv_cache_init(2, 1, 4, 2, 8, torch.float32)
    cache = port_attn.kv_cache_init(2, 1, 4, 2, 8, torch.float32, device="cpu")
    assert all(t.device.type == "cpu" for t in cache)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_swiglu_and_cross_entropy_match_reference(dt):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.25
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    (jx, jg, ju, jd), (tx, tg, tu, td) = _both([x, wg, wu, wd], dt)
    got = port_common.swiglu(tx, tg, tu, td)
    want = ref_common.swiglu(jx, jg, ju, jd)
    tol = 5e-2 if dt == "bfloat16" else 1e-5
    assert got.dtype == TORCH[dt]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    labels = rng.integers(0, 16, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.7
    for m in (None, mask):
        want_ce = ref_common.softmax_cross_entropy(
            jx, jnp.asarray(labels), None if m is None else jnp.asarray(m))
        got_ce = port_common.softmax_cross_entropy(
            tx, torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        assert got_ce.dtype == torch.float32
        np.testing.assert_allclose(float(got_ce), float(want_ce), rtol=1e-5)
