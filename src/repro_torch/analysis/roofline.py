"""Three-term roofline model of a traced step, and the analytic parameter
and FLOP counts of a configuration (target: one NVIDIA H100 SXM per rank).

Port of ``repro.analysis.roofline``:

    compute    = FLOPs / peak_FLOP/s              [per rank]
    memory     = HBM_bytes / HBM_bw               [per rank]
    collective = collective_bytes / NVLink_bw     [per rank]

FLOPs, HBM bytes and collective bytes come from
``analysis.collectives.analyze_step``, per rank. ``memory`` divides the
unfused sum of the compute ops' operand and result bytes (eager PyTorch's
kernels, the port's counterpart of the reference's fusion surfaces).
``collective`` uses the summed *operand* bytes of every collective (the
reference's definition); the ring-model wire bytes are also reported. The
dominant term and the bound are taken over all three, as in the reference.

MODEL_FLOPS is the analytic useful compute (6·N·D for training a dense
model on D tokens, 2·N·D for inference; N_active for MoE), used to report
how much of the traced compute is "useful".
"""
from __future__ import annotations

import dataclasses

from . import hw

__all__ = ["RooflineTerms", "roofline_terms", "count_params", "model_flops"]


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # per rank
    hlo_bytes: float  # per rank
    collective_bytes: float  # per rank (operand-sum definition)
    wire_bytes: float  # ring-model per rank
    model_flops_global: float
    collective_counts: dict

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Idealised step time if terms overlap perfectly = max term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs * chips): how much traced compute is useful."""
        tot = self.hlo_flops * self.chips
        return self.model_flops_global / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful compute time / idealised step time."""
        t_useful = self.model_flops_global / (self.chips * hw.PEAK_FLOPS_BF16)
        return t_useful / self.bound_s if self.bound_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "wire_bytes_per_chip": self.wire_bytes,
            "model_flops_global": self.model_flops_global,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collective_counts,
        }


def roofline_terms(arch: str, shape: str, mesh_name: str, chips: int,
                   analysis, model_flops_global: float) -> RooflineTerms:
    """The terms of ``analysis`` (an ``analysis.collectives.HLOAnalysis``)."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=analysis.flops / hw.PEAK_FLOPS_BF16,
        memory_s=analysis.hbm_bytes / hw.HBM_BW,
        collective_s=analysis.collective_operand_bytes / hw.NVLINK_BW,
        hlo_flops=analysis.flops,
        hlo_bytes=analysis.hbm_bytes,
        collective_bytes=analysis.collective_operand_bytes,
        wire_bytes=analysis.collective_wire_bytes,
        model_flops_global=model_flops_global,
        collective_counts=analysis.collective_counts(),
    )


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
