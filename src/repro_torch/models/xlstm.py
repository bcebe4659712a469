"""xLSTM LM (sLSTM + mLSTM blocks), the ``ssm`` family (arXiv:2405.04517).

Port of ``repro.models.xlstm``, forward and serving. ``slstm_period``
groups the layers into super-blocks of ``period - 1`` mLSTM blocks and one
sLSTM block (all mLSTM when it is 0), stacked as ``m.* (NS, PM, ...)`` and
``s.* (NS, ...)``.

  - mLSTM: a pre-norm up-projection (``mlstm_proj_factor``) with a causal
    depthwise conv, per-head matrix memory ``C (dk x dv)``, log-sigmoid
    input and forget gates and an output-gate branch. A sequence runs in
    the chunkwise-parallel form (quadratic inside a chunk of up to 128
    steps, the state carried from chunk to chunk); the products of bf16
    operands accumulate in fp32 (the operands are widened, which is exact,
    where the reference asks for an fp32 result).
  - sLSTM: scalar memory with a block-diagonal (per-head) recurrence and a
    stabiliser, then a 4/3 GeLU MLP; a plain forward scan over time. Under
    autograd the scan is ``_SLSTMScan``, the reference's custom VJP: the
    forward keeps each step's incoming state, the backward scans in
    reverse, recomputing one step at a time, and the recurrent weight's
    gradient is one contraction after the loop.

Serving keeps the O(1) recurrent state ``XLSTMState``. As in the reference,
a prefill starts every state and conv from zeros. No attention, so no
kernel: the large products are ``torch.matmul``/``einsum``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .api import ModelConfig
from .common import (ParamFactory, at_least, causal_depthwise_conv,
                     conv_step, is_sharded, local_call, maybe_remat, rms_norm,
                     serve_mode)
from .family import FamilyLM

__all__ = ["XLSTMLM", "XLSTMState", "param_shapes", "param_axes"]

CHUNK = 128  # intra-chunk quadratic width of the chunkwise mLSTM


class XLSTMState(NamedTuple):
    """Recurrent serving state (O(1) in S); written in place by a step."""

    m_C: torch.Tensor  # (NSUP, PM, B, NH, dk, dv) fp32 matrix memory
    m_n: torch.Tensor  # (NSUP, PM, B, NH, dk) fp32 normaliser
    m_conv: torch.Tensor  # (NSUP, PM, B, w-1, pD) conv tail
    s_c: torch.Tensor  # (NSUP, B, D) fp32
    s_n: torch.Tensor  # (NSUP, B, D) fp32
    s_m: torch.Tensor  # (NSUP, B, D) fp32 stabiliser
    s_h: torch.Tensor  # (NSUP, B, D) hidden fed back into the recurrence
    s_conv: torch.Tensor  # (NSUP, B, w-1, D)
    length: torch.Tensor  # (B,) int32


def _dims(cfg: ModelConfig) -> dict:
    period = cfg.slstm_period or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are no whole "
                         f"number of periods of {period}")
    pd = int(cfg.mlstm_proj_factor * cfg.d_model)
    dv = pd // cfg.n_heads
    return {"n_sup": cfg.n_layers // period,
            "pm": period - 1 if cfg.slstm_period else period,
            "has_slstm": bool(cfg.slstm_period), "pd": pd, "nh": cfg.n_heads,
            "dv": dv, "dk": max(dv // 2, 1), "dh": cfg.d_model // cfg.n_heads,
            # sLSTM MLP width: 4/3 D down to a multiple of 128 (>= 128)
            "fs": max((int(4 * cfg.d_model / 3) // 128) * 128, 128)}


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """State-dict name -> shape of an xLSTM model's weights."""
    d = _dims(cfg)
    D, pD, NH, dk, dv, w = (cfg.d_model, d["pd"], d["nh"], d["dk"], d["dv"],
                            cfg.conv_width)
    NS, PM, V = d["n_sup"], d["pm"], cfg.padded_vocab
    shapes = {f"m.{k}": (NS, PM, *v) for k, v in {
        "ln": (D,), "w_up": (D, 2 * pD), "conv": (w, pD),
        "wq": (pD, NH * dk), "wk": (pD, NH * dk), "wv": (pD, NH * dv),
        "w_if": (pD, 2 * NH), "b_if": (2 * NH,), "w_down": (pD, D)}.items()}
    shapes.update({"embed": (V, D), "ln_f": (D,), "unembed": (V, D)})
    if d["has_slstm"]:
        dh = d["dh"]
        shapes.update({f"s.{k}": (NS, *v) for k, v in {
            "ln": (D,), "conv": (w, D), "w": (D, 4 * D),
            "r": (NH, dh, 4 * dh), "b": (4 * D,), "ln2": (D,),
            "w_mlp_up": (D, d["fs"]), "w_mlp_down": (d["fs"], D)}.items()})
    return shapes


#: Logical axes of the mLSTM (``m.``, after ``sup, layers``) and sLSTM
#: (``s.``, after ``sup``) leaves.
_M_AXES = {"ln": ("embed",), "w_up": ("embed", "mlp"), "conv": (None, "mlp"),
           "wq": ("mlp", "heads_flat"), "wk": ("mlp", "heads_flat"),
           "wv": ("mlp", "mlp"), "w_if": ("mlp", None), "b_if": (None,),
           "w_down": ("mlp", "embed")}
_S_AXES = {"ln": ("embed",), "conv": (None, "embed"), "w": ("embed", "mlp"),
           "r": ("heads", None, None), "b": (None,), "ln2": ("embed",),
           "w_mlp_up": ("embed", "mlp"), "w_mlp_down": ("mlp", "embed")}


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """State-dict name -> logical axes of an xLSTM model's weights."""
    top = {"embed": ("vocab", "embed"), "unembed": ("vocab", "embed"),
           "ln_f": ("embed",)}
    out = {}
    for name in param_shapes(cfg):
        head, _, base = name.partition(".")
        if name in top:
            out[name] = top[name]
        elif head == "m":
            out[name] = ("sup", "layers") + _M_AXES[base]
        else:
            out[name] = ("sup",) + _S_AXES[base]
    return out


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor per rank (DTensor has no rule for its
    backward). Elementwise, so each rank's block keeps its placements; a
    partial sum is reduced first."""
    if not is_sharded(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_call(F.logsigmoid, x.device_mesh, pl, (pl,), x)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the operands widened to fp32: the reference's product
    with ``preferred_element_type=float32``."""
    return a.float() @ b.float()


def _mlstm_chunkwise(q, k, v, li, lf, C, n):
    """Chunkwise-parallel mLSTM from state ``(C, n)``.

    q, k ``(B, S, NH, dk)``; v ``(B, S, NH, dv)``; li/lf ``(B, S, NH)``
    log-gates (<= 0); C ``(B, NH, dk, dv)``, n ``(B, NH, dk)`` fp32.
    Returns ``(h (B, S, NH, dv) in q.dtype, C, n)``.
    """
    B, S, NH, dk = q.shape
    W = CHUNK
    while S % W:
        W //= 2
    causal = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                   device=q.device))
    qs = (q * dk ** -0.5).to(q.dtype)
    hs = []
    for c0 in range(0, S, W):
        qq, kk, vv = (x[:, c0:c0 + W] for x in (qs, k, v))
        ll_i, ll_f = li[:, c0:c0 + W], lf[:, c0:c0 + W]
        Fc = torch.cumsum(ll_f, dim=1)  # (B, W, NH) decay from chunk start
        # intra-chunk: weight(t, s) = exp(F_t - F_s + li_s), s <= t
        logits = torch.einsum("bthd,bshd->bhts", qq.float(), kk.float())
        wts = Fc[:, :, None, :] - Fc[:, None, :, :] + ll_i[:, None, :, :]
        wts = wts.masked_fill(~causal[None, :, :, None], float("-inf"))
        ew = torch.exp(wts).permute(0, 3, 1, 2)  # (B, NH, t, s)
        intra = torch.einsum("bhts,bshv->bthv",
                             (logits * ew).to(qq.dtype).float(), vv.float())
        # inter-chunk: q_t reads the incoming state decayed by exp(F_t)
        eF = torch.exp(Fc)
        inter = torch.einsum("bthd,bhdv->bthv", qq.float() * eF[..., None], C)
        n_run = eF[..., None] * n[:, None] + torch.einsum(
            "bhts,bshd->bthd", ew, kk.float())
        denom = torch.einsum("bthd,bthd->bth", qq.float(), n_run).abs()
        hs.append((intra + inter) / at_least(denom, 1.0)[..., None])
        # state at the chunk's end
        Fw = Fc[:, -1, :]  # (B, NH)
        decay = torch.exp(Fw[:, None] - Fc + ll_i)  # (B, W, NH)
        C = torch.exp(Fw)[..., None, None] * C + torch.einsum(
            "bshd,bsh,bshv->bhdv", kk.float(), decay, vv.float())
        n = torch.exp(Fw)[..., None] * n + torch.einsum(
            "bshd,bsh->bhd", kk.float(), decay)
    return torch.cat(hs, dim=1).to(q.dtype), C, n


def _slstm_math(g, c, n, m):
    """The sLSTM cell from its gate pre-activations ``g (B, 4, D)``."""
    zt = torch.tanh(g[:, 0])
    it, ft = g[:, 1], g[:, 2]
    ot = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c_new = f_ * c + i_ * zt
    n_new = f_ * n + i_
    return c_new, n_new, m_new, ot * c_new / at_least(n_new, 1.0)


def _slstm_step(xt, r4, c, n, m, h):
    """One sLSTM step from the state ``(c, n, m, h)``; ``xt (B, 4, D)`` the
    input's gate pre-activations, ``r4 (NH, dh, 4, dh)`` gate-major."""
    B, _, D = xt.shape
    NH, dh = r4.shape[0], r4.shape[1]
    rec = torch.einsum("bhd,hdgf->bghf", h.reshape(B, NH, dh), r4)
    return _slstm_math(xt + rec.reshape(B, 4, D), c, n, m)


def _slstm_run(wx4s, r4, state, pres=None):
    """The scan over time of ``wx4s (S, B, 4, D)`` from ``state``; returns
    ``(final state, hs (S, B, D))``. ``pres``, a list, receives each step's
    incoming state."""
    hs = []
    for xt in wx4s:
        if pres is not None:
            pres.append(state)
        state = _slstm_step(xt, r4, *state)
        hs.append(state[3])
    return state, torch.stack(hs)


class _SLSTMScan(torch.autograd.Function):
    """The reference's ``_slstm_scan_core`` with its custom VJP.

    ``forward(wx4s (S, B, 4, D), r (NH, dh, 4 dh), c0, n0, m0, h0)`` ->
    ``(c, n, m, h, hs (S, B, D))``, all fp32. The forward keeps each step's
    incoming state; the backward runs the steps in reverse, recomputing
    each under ``enable_grad`` and pulling the gradients through it with
    ``torch.autograd.grad``, and forms ``dR`` in one contraction over
    (steps x batch) after the loop.
    """

    @staticmethod
    def forward(ctx, wx4s, r, c0, n0, m0, h0):
        NH = r.shape[0]
        r4 = r.reshape(NH, r.shape[1], 4, r.shape[1])
        pres = []
        (c, n, m, h), hs = _slstm_run(wx4s, r4, (c0, n0, m0, h0), pres)
        ctx.save_for_backward(wx4s, r, *(torch.stack(x) for x in zip(*pres)))
        return c, n, m, h, hs

    @staticmethod
    def backward(ctx, dc, dn, dm, dh_, dhs):
        wx4s, r, cs, ns, ms, hps = ctx.saved_tensors
        NH, dh = r.shape[0], r.shape[1]
        r4 = r.reshape(NH, dh, 4, dh)
        S, B = wx4s.shape[0], wx4s.shape[1]
        dxs = [None] * S
        for t in range(S - 1, -1, -1):
            with torch.enable_grad():
                ins = [x.detach().requires_grad_()
                       for x in (wx4s[t], hps[t], cs[t], ns[t], ms[t])]
                out = _slstm_step(ins[0], r4, ins[2], ins[3], ins[4], ins[1])
                dxs[t], dh_, dc, dn, dm = torch.autograd.grad(
                    out, ins, (dc, dn, dm, dh_ + dhs[t]))
        dwx4s = torch.stack(dxs)
        # g = xt + rec, so d(rec) = d(g) = dwx4s; regroup gate-major per head
        dr4 = torch.einsum("sbhd,sbghf->hdgf", hps.reshape(S, B, NH, dh),
                           dwx4s.reshape(S, B, 4, NH, dh))
        return dwx4s, dr4.reshape(NH, dh, 4 * dh), dc, dn, dm, dh_


class XLSTMLM(FamilyLM):
    """xLSTM LM (see :class:`family.FamilyLM`)."""

    FAMILIES = ("ssm",)
    FP32_LEAVES = frozenset({"b_if", "b"})
    param_shapes = staticmethod(param_shapes)
    param_axes = staticmethod(param_axes)

    def __init__(self, cfg: ModelConfig, **kw):
        d = _dims(cfg)
        self.n_sup, self.pm, self.has_slstm = d["n_sup"], d["pm"], \
            d["has_slstm"]
        self.pd, self.nh, self.dv, self.dk, self.dh, self.fs = (
            d["pd"], d["nh"], d["dv"], d["dk"], d["dh"], d["fs"])
        super().__init__(cfg, **kw)

    def _init_leaf(self, f: ParamFactory, name: str, shape: tuple[int, ...],
                   dtype: torch.dtype) -> torch.Tensor:
        base = name.split(".")[-1]
        if base in ("ln", "ln2", "ln_f"):
            return f.ones(shape, dtype=dtype)
        if base in ("b_if", "b"):
            if f.device.type == "meta":
                return torch.empty(shape, dtype=dtype, device=f.device)
            NH, D = self.nh, self.cfg.d_model
            # forget gates open, input gates mildly open (m); the sLSTM's
            # forget-gate bias 3 (s)
            row = [1.0] * NH + [3.0] * NH if base == "b_if" else \
                [0.0] * 2 * D + [3.0] * D + [0.0] * D
            return torch.tensor(row, dtype=dtype, device=f.device).expand(
                shape).clone()
        scale = {"embed": 0.02, "conv": 0.5}.get(base)
        return f.dense(shape, scale=scale, dtype=dtype)

    def _m(self, s: int, j: int) -> dict:
        return {k: v[s, j] for k, v in self.m.items()}

    def _s(self, s: int) -> dict:
        return {k: v[s] for k, v in self.s.items()}

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.unembed.T

    # ------------------------------------------------------------ mLSTM block
    def _mlstm_qkvif(self, xm, xc, lp):
        """q, k and the gates from the conv branch ``xc``; v from ``xm``."""
        B, S, _ = xm.shape
        NH = self.nh
        q = (xc @ lp["wq"]).reshape(B, S, NH, self.dk)
        k = (xc @ lp["wk"]).reshape(B, S, NH, self.dk)
        v = (xm @ lp["wv"]).reshape(B, S, NH, self.dv)
        gf = _mm32(xc, lp["w_if"].to(xc.dtype)) + lp["b_if"].float()
        return (q, k, v, _logsigmoid(gf[..., :NH]),
                _logsigmoid(gf[..., NH:]))

    def _mlstm_seq(self, h, lp):
        """One mLSTM block over a sequence from a zero state; returns
        ``(h, C, n, conv tail)``."""
        B, S, _ = h.shape
        up = rms_norm(h, lp["ln"]) @ lp["w_up"]
        xm, z = up.chunk(2, dim=-1)
        xc = F.silu(causal_depthwise_conv(xm, lp["conv"]))
        q, k, v, li, lf = self._mlstm_qkvif(xm, xc, lp)
        C0 = torch.zeros((B, self.nh, self.dk, self.dv), dtype=torch.float32,
                         device=h.device)
        n0 = torch.zeros((B, self.nh, self.dk), dtype=torch.float32,
                         device=h.device)
        ht, C1, n1 = _mlstm_chunkwise(q, k, v, li, lf, C0, n0)
        out = ht.reshape(B, S, -1) * F.silu(z)
        tail = xm[:, S - (self.cfg.conv_width - 1):, :]
        return h + out @ lp["w_down"], C1, n1, tail

    # ------------------------------------------------------------ sLSTM block
    def _slstm_scan(self, x, sp, c, n, m, h):
        """Forward scan over time of ``x (B, S, D)`` (the conv output);
        returns ``(hs (B, S, D), final state)``. Under autograd it is the
        custom-VJP ``_SLSTMScan``."""
        B, S, D = x.shape
        wx = _mm32(x, sp["w"]) + sp["b"].float()
        wx4s = wx.reshape(B, S, 4, D).transpose(0, 1)
        r = sp["r"].float()
        if torch.is_grad_enabled():
            c, n, m, h, hs = _SLSTMScan.apply(wx4s, r, c, n, m, h)
        else:
            (c, n, m, h), hs = _slstm_run(
                wx4s, r.reshape(self.nh, self.dh, 4, self.dh), (c, n, m, h))
        return hs.transpose(0, 1), (c, n, m, h)

    def _slstm_seq(self, h, sp):
        """One sLSTM block over a sequence from a zero state; returns
        ``(h, (c, n, m, h_state), conv tail)``."""
        B, S, D = h.shape
        hn = rms_norm(h, sp["ln"])
        tail = hn[:, S - (self.cfg.conv_width - 1):, :]
        xc = F.silu(causal_depthwise_conv(hn, sp["conv"]))
        z = torch.zeros((B, D), dtype=torch.float32, device=h.device)
        hs, state = self._slstm_scan(xc, sp, z, z, torch.full_like(z, -1e9),
                                     z)
        h = h + hs.to(h.dtype)
        hn = rms_norm(h, sp["ln2"])
        mlp = F.gelu(hn @ sp["w_mlp_up"], approximate="tanh") \
            @ sp["w_mlp_down"]
        return h + mlp, state, tail

    # ----------------------------------------------------------------- train
    def _sup_train(self, h, s):
        """Super-block ``s``: its mLSTM blocks, then its sLSTM block."""
        for j in range(self.pm):
            h = self._mlstm_seq(h, self._m(s, j))[0]
        if self.has_slstm:
            h = self._slstm_seq(h, self._s(s))[0]
        return h

    def _forward(self, batch: dict, *, last: bool = False) -> torch.Tensor:
        """Logits ``(B, S, V)`` of the whole sequence, or of the last
        position alone when ``last``. Each super-block is remat'd per
        ``cfg.remat_policy``, as in the reference."""
        h = self._embed(batch["tokens"])
        sup = maybe_remat(self._sup_train, self.cfg.remat_policy)
        for s in range(self.n_sup):
            h = sup(h, s)
        if last:
            h = h[:, -1:]
        return self._masked_logits(rms_norm(h, self.ln_f), self.unembed)

    # ----------------------------------------------------------------- serve
    def cache_axes(self) -> XLSTMState:
        s = ("sup", "batch", "embed")
        return XLSTMState(
            m_C=("sup", "layers", "batch", "heads", "head_dim", "mlp"),
            m_n=("sup", "layers", "batch", "heads", "head_dim"),
            m_conv=("sup", "layers", "batch", None, "mlp"),
            s_c=s, s_n=s, s_m=s, s_h=s,
            s_conv=("sup", "batch", None, "embed"), length=("batch",))

    def make_caches(self, batch: int, s_max: int = 0) -> XLSTMState:
        """A zero state (``s_max`` is not used: the state is O(1) in S)."""
        cfg = self.cfg
        NS, PM, NH, dk, dv = self.n_sup, self.pm, self.nh, self.dk, self.dv
        D, pD, w, dev = cfg.d_model, self.pd, cfg.conv_width, self.device

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return XLSTMState(
            m_C=zeros((NS, PM, batch, NH, dk, dv)),
            m_n=zeros((NS, PM, batch, NH, dk)),
            m_conv=zeros((NS, PM, batch, w - 1, pD), cfg.dtype),
            s_c=zeros((NS, batch, D)), s_n=zeros((NS, batch, D)),
            s_m=torch.full((NS, batch, D), -1e9, dtype=torch.float32,
                           device=dev),
            s_h=zeros((NS, batch, D)),
            s_conv=zeros((NS, batch, w - 1, D), cfg.dtype),
            length=zeros((batch,), torch.int32))

    def _decode_mlstm(self, h, lp, C, n, conv_tail):
        """One token through an mLSTM block; ``h (B, 1, D)``."""
        B = h.shape[0]
        NH, dk, dv = self.nh, self.dk, self.dv
        up = rms_norm(h[:, 0], lp["ln"]) @ lp["w_up"]
        xm, z = up.chunk(2, dim=-1)
        xc, conv_tail = conv_step(xm, conv_tail, lp["conv"])
        xc = F.silu(xc)
        q = (xc @ lp["wq"]).reshape(B, NH, dk).float()
        k = (xc @ lp["wk"]).reshape(B, NH, dk).float()
        v = (xm @ lp["wv"]).reshape(B, NH, dv).float()
        gf = _mm32(xc, lp["w_if"]) + lp["b_if"].float()
        i_ = torch.exp(F.logsigmoid(gf[:, :NH]))
        f_ = torch.exp(F.logsigmoid(gf[:, NH:]))
        C = f_[..., None, None] * C + i_[..., None, None] * torch.einsum(
            "bhd,bhv->bhdv", k, v)
        n = f_[..., None] * n + i_[..., None] * k
        q = q * dk ** -0.5
        num = torch.einsum("bhd,bhdv->bhv", q, C)
        den = torch.einsum("bhd,bhd->bh", q, n).abs()
        ht = (num / den.clamp(min=1.0)[..., None]).to(h.dtype)
        out = ht.reshape(B, -1) * F.silu(z)
        return h + (out @ lp["w_down"])[:, None], C, n, conv_tail

    def _decode_slstm(self, h, sp, c, n, m, hprev, conv_tail):
        """One token through the sLSTM block; ``h (B, 1, D)``."""
        B, D = h.shape[0], self.cfg.d_model
        xc, conv_tail = conv_step(rms_norm(h[:, 0], sp["ln"]), conv_tail,
                                  sp["conv"])
        wx = _mm32(F.silu(xc), sp["w"]) + sp["b"].float()
        rec = torch.einsum("bhd,hdg->bhg", hprev.reshape(B, self.nh, self.dh),
                           sp["r"].float())
        rec4 = rec.reshape(B, self.nh, 4, self.dh).transpose(1, 2)
        c, n, m, hprev = _slstm_math((wx + rec4.reshape(B, 4 * D)).reshape(
            B, 4, D), c, n, m)
        h = h + hprev[:, None].to(h.dtype)
        hn = rms_norm(h[:, 0], sp["ln2"])
        mlp = F.gelu(hn @ sp["w_mlp_up"], approximate="tanh") \
            @ sp["w_mlp_down"]
        return h + mlp[:, None], c, n, m, hprev, conv_tail

    def decode_step(self, state: XLSTMState, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, XLSTMState]:
        """Append ``tokens (B, 1)``; logits ``(B, 1, vocab)``."""
        with serve_mode(state.m_C):
            return self._decode_step(state, tokens)

    def _decode_step(self, state: XLSTMState, tokens: torch.Tensor
                     ) -> tuple[torch.Tensor, XLSTMState]:
        h = self._embed(tokens)
        for s in range(self.n_sup):
            for j in range(self.pm):
                h, C, n, tail = self._decode_mlstm(
                    h, self._m(s, j), state.m_C[s, j], state.m_n[s, j],
                    state.m_conv[s, j])
                state.m_C[s, j], state.m_n[s, j] = C, n
                state.m_conv[s, j] = tail
            if self.has_slstm:
                h, c, n, m, hp, tail = self._decode_slstm(
                    h, self._s(s), state.s_c[s], state.s_n[s], state.s_m[s],
                    state.s_h[s], state.s_conv[s])
                state.s_c[s], state.s_n[s], state.s_m[s] = c, n, m
                state.s_h[s], state.s_conv[s] = hp, tail
        logits = self._unembed(rms_norm(h, self.ln_f))
        return logits[..., :self.cfg.vocab], state._replace(
            length=state.length + 1)

    def prefill(self, state: XLSTMState, batch: dict
                ) -> tuple[torch.Tensor, XLSTMState]:
        """Run the prompt ``batch["tokens"]`` from a zero state (as the
        reference does); last logits ``(B, 1, vocab)``."""
        with serve_mode(state.m_C):
            return self._prefill(state, batch)

    def _prefill(self, state: XLSTMState, batch: dict
                 ) -> tuple[torch.Tensor, XLSTMState]:
        h = self._embed(batch["tokens"])
        S = h.shape[1]
        for s in range(self.n_sup):
            for j in range(self.pm):
                h, C, n, tail = self._mlstm_seq(h, self._m(s, j))
                state.m_C[s, j], state.m_n[s, j] = C, n
                state.m_conv[s, j] = tail
            if self.has_slstm:
                h, (c, n, m, hp), tail = self._slstm_seq(h, self._s(s))
                state.s_c[s], state.s_n[s], state.s_m[s] = c, n, m
                state.s_h[s], state.s_conv[s] = hp, tail
        logits = self._unembed(rms_norm(h[:, -1:], self.ln_f))
        return logits[..., :self.cfg.vocab], state._replace(
            length=state.length + S)
