"""Analytic parameter and FLOP counts of a model configuration.

Port of the analytic half of ``repro.analysis.roofline``: ``count_params``
and ``model_flops`` (6·N·D for training on D tokens, 2·N·D for inference;
N the active parameters for MoE). ``roofline_terms`` reads a compiled
step's HLO and waits for ``analysis/hlo.py`` (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

__all__ = ["count_params", "model_flops"]


def count_params(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from a ModelConfig (analytic)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    attn = D * H * dh + 2 * D * KVH * dh + H * dh * D
    if cfg.family in ("dense", "vlm"):
        per_layer = attn + 3 * D * F
        total = cfg.n_layers * per_layer + 2 * V * D
        return float(total), float(total)
    if cfg.family == "moe":
        expert = 3 * D * F
        per_layer = attn + cfg.n_experts * expert + D * cfg.n_experts
        act_layer = attn + cfg.top_k * expert + D * cfg.n_experts
        total = cfg.n_layers * per_layer + 2 * V * D
        act = cfg.n_layers * act_layer + 2 * V * D
        return float(total), float(act)
    if cfg.family == "ssm":
        pD = int(cfg.mlstm_proj_factor * D)
        nh = cfg.n_heads
        dv = pD // nh
        dk = max(dv // 2, 1)
        m_layer = D * 2 * pD + pD * (2 * nh * dk + nh * dv) + pD * D + pD * 2 * nh
        period = cfg.slstm_period or cfg.n_layers
        n_sup = cfg.n_layers // period
        pm = period - 1 if cfg.slstm_period else period
        fs = max((int(4 * D / 3) // 128) * 128, 128)
        s_layer = D * 4 * D + nh * (D // nh) * 4 * (D // nh) + 2 * D * fs
        total = n_sup * (pm * m_layer + (s_layer if cfg.slstm_period else 0)) + 2 * V * D
        return float(total), float(total)
    if cfg.family == "hybrid":
        W_ = cfg.rnn_state_dim or D
        rec = 2 * D * W_ + W_ * 2 * W_ + W_ * D + 3 * D * F
        att = attn + 3 * D * F
        pattern = cfg.block_pattern or ("rec", "rec", "attn")
        tail = cfg.pattern_tail
        n_sup = (cfg.n_layers - len(tail)) // len(pattern)
        n_rec = n_sup * sum(1 for p in pattern if p == "rec") + sum(
            1 for p in tail if p == "rec")
        n_att = cfg.n_layers - n_rec
        total = n_rec * rec + n_att * att + V * D
        return float(total), float(total)
    if cfg.family == "audio":
        enc = cfg.enc_layers * (attn + 2 * D * F)
        dec = cfg.dec_layers * (2 * attn + 2 * D * F)
        total = enc + dec + 2 * V * D
        return float(total), float(total)
    raise ValueError(cfg.family)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6·N_active·tokens (train),
    2·N_active·tokens (prefill), 2·N_active per sequence (decode)."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch
