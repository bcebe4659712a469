#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU and check it.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any mismatch raises and the script exits
non-zero without printing a result):

  1. the device: ``torch.cuda.get_device_name`` and the card's name and power
     limit from ``nvidia-smi``;
  2. build: ``nvcc`` compiles the two assignment kernels for sm_90a,
     ``kernels/csrc/coflow_assign_sm90.cu`` (the chain kernel, K <= 8) and
     ``kernels/csrc/coflow_assign.cu`` (the warp kernel, K <= 32), one nvcc
     per source, all four sources of the script started together; their
     ptxas lines (registers, shared memory, spills);
  3. the assignment kernels against their plain PyTorch version on the
     card, bit for bit: the chain kernel on small and edge shapes (F=0,
     F=5, K=8 at N=150, K=8 at N=512 where the nonzero bitmap lives in
     global memory), on every hazard stream of ``kernels/hazards.py``
     (ports repeated at distances 1..4, runs of one port, exact ties, zero
     sizes) for K=1..8 at N=8, 150 and 512, and on the first 4,096
     pi-ordered flows of the 526-coflow trace instance; the warp kernel on
     those 4,096 flows and on hazard streams at K=9 and 32;
  4. the main path: ``sample_instance(N=150, M=200)`` of the FB-2010-style
     trace through ``run_fast(backend="kernel")`` (the kernel is opt-in: the
     default backend is the fp64 host one, as in the reference) and
     ``validate``, with weighted and tail CCT,
     each stage's time, each assignment kernel's launches in that run (one
     of the chain kernel, none of the warp kernel), a check of every CCT
     against the Lemma 1 lower bound, a small instance whose GPU run must
     equal its CPU run, and the chain kernel against its plain version on
     the main path's own 191,551 flows;
  5. the whole trace (M=526, 443,943 flows): the chain kernel against the
     warp kernel, choice for choice; then both kernels timed in turns
     (warp, chain, chain, warp) at F=191,551 and F=443,943 with CUDA
     events, the SM clock read with ``nvidia-smi`` beside each timing, ns
     and cycles per flow, the roofline bound and the chain floor;
  6. build: ``nvcc`` compiles the two flash-attention kernels,
     ``kernels/csrc/flash_attention_sm90.cu`` (bf16: TMA + wgmma) and
     ``kernels/csrc/flash_attention.cu`` (fp32: CUDA cores), started
     beside the phase-2 build, one nvcc per source; their ptxas lines, one
     per head-dim instance (Dh 64, 128 and 256), and the sm90 kernel's
     shared memory and kv tile rows at each;
  7. the flash-attention kernels against their plain PyTorch version on
     the card: the 7 CASES of ``tests/test_kernels_attention.py`` (1e-5
     fp32 through the SIMT kernel, 2e-2 bf16 through the sm90 kernel),
     ragged S, the sm90 kernel's edge cases (S around its 128-row tiles,
     Dh 64 and 128, windows 1/70/128/300 and none, non-causal, GQA groups
     1/2/8), and the real layer-0 q/k/v of the TinyLlama prefill of phase
     8 (bf16, 2e-2), with the sm90 kernel's, the plain version's and
     SDPA's times at that shape, and the SIMT kernel's, the plain
     version's and SDPA's at the same shape in fp32; then both kernels at
     the shapes the other families bring (``FLASH_SHAPES`` of
     ``kernels/hazards.py``): Dh=256 around the sm90 kernel's 64-row kv
     tiles with windows none, 1, 300 and 2,048, and Sq != Sk both ways,
     causal (aligned top-left) and not;
  8. the serving path at full width: ``DenseLM`` with tinyllama-1.1b's
     config (22 layers, d_model 2048, 32/4 heads, bf16, seeded random
     weights), ``attention_impl="pallas"``, 8 prompts of 2,048 tokens, one
     ``build_prefill`` step (22 launches of the sm90 kernel, none of the
     SIMT one) and 16 greedy
     ``build_decode`` steps; the last decode logits are held to
     ``_forward_train`` on the whole 2,064-token sequence (6e-2), and a
     ``torch.profiler`` trace of one prefill and one decode step gives the
     device time by kind of kernel;
  9. the online path at full width: ``sample_online_instance`` of the same
     trace (N=150, M=200: phase 4's coflows, 191,551 flows, released over
     phase 4's makespan) through ``run_fast_online(backend="kernel")`` (one
     launch of the chain kernel on the arrival-ordered flows, none of the warp kernel) and
     ``validate(releases=)``, every CCT against release + delta + rho/R,
     weighted and tail CCT and the price of arrival (online over offline
     weighted CCT), each stage's time, the chain kernel against the warp
     kernel on every online flow and against its plain version on the first
     4,096, and the kernel's agreement with the fp64 host backend's choices,
     online and offline, and the weighted-CCT drift it causes, beside the
     reference's stated precision contract (>= 97%, < 2%);
 10. the paper's ablation grid: ``run_batch`` over the five algorithms and
     the three list policies (the sunflow baselines once), offline and
     online, on the M=48 trace instance (N=150), the fp64 host backend for
     every point and the kernel for the tau-aware ones, through a spawn
     pool of ``WORKERS`` processes (the chain kernel's launches counted in
     the workers and returned with their rows), weighted CCT normalized to
     ``ours`` and each point's wall time; the four cheapest fp64 points
     run again serially and must give the pool's rows; then, on the small
     N=24, M=60 instance, every grid point on the card against the same
     point on the CPU, bit for bit in choices, t_establish and CCTs;
 11. the streaming service at full width: ``FabricManager`` on the card
     over phase 9's online instance (200 coflows, 191,551 flows):
     ``arrival_stream`` -> ``submit``, 16 evenly spaced ``tick``s and
     ``flush`` (each tick's report and wall time printed, and the host
     seconds of each traced span); every flow committed, the per-coflow
     CCTs equal to the fp64 replay in admission order bit for bit (phase
     9's fp64 ``run_fast_metrics`` when the releases are untied), the
     program of record validated on the card, no kernel launched (the
     streaming plane assigns on the fp64 host backend, as the reference's);
     ``summary()``; then the one-shot plane on phase 4's instance with
     ``backend="kernel"``, twice: one chain-kernel launch on the miss, none
     on the hit, byte-identical programs equal to phase 4's schedule;
 12. the fault plane: phase 10's online M=48 instance (25,217 flows; the
     stream is cut from phase 11's M=200, where phases 11-12 can overrun
     their 150 s budget ``STREAM_BUDGET_S``; PERF.md) served the same way
     with a ``FaultInjector`` (core 2 down at 0.25 of the span and up at
     0.5, a flap of core 1's port 0 over [0.6, 0.62], core 0's delay
     drifting to 12 at 0.7) and one ``report_fault`` discovered late (core
     2 down again a twentieth of the span before the middle tick); the
     program of record (aborted circuits dropped) validated, every coflow's
     bytes delivered exactly once, every CCT finite; then
     examples/serve_fabric.py's stream (N=16, M=80) with the same faults
     through ``FabricState`` on the card and on the CPU, every
     ``TickCommit`` equal. A run over the budget says so;
 13. the paper's guarantee and its oracles (budget ``ORACLE_BUDGET_S``):
     (a) at full width and depth, phase 9's offline fp64 choices on phase
     4's instance (191,551 flows) through ``assignment_from_choices`` and
     ``schedule_all_cores``, whose CCTs must equal phase 9's fp64 run bit
     for bit, then every certificate of ``core/theory.py`` on it (Lemma 1,
     Lemma 2 and Theorem 1 must hold; Lemma 3 and Theorem 2, which the
     reference documents as violated, report their violations), each
     empirical ratio beside its bound and ``gamma_w``, then Lemma 1 and
     Theorem 1 on phase 4's kernel schedule and its choices' divergence
     from ``assign_ref`` against the kernel gate's allowance; (b) the
     oracle gates
     ``cross_check`` and ``cross_check_online`` with ``backend="kernel"``
     on the trace cut to ``M_ORACLE`` coflows (N=150), one launch of the
     chain kernel each, the gate's divergence beside its allowance; (c)
     ``run_batch(check="oracle")`` over the five algorithms and the three
     list policies, offline and online, on phase 10's small instance (N=24,
     M=60) on the card, the fp64 backend for every point and the kernel for
     the tau-aware ones (pooled, as phase 10), then one point and the
     oracle ``run`` with all
     five certificates on the CPU, equal to the card's bit for bit. A run
     over the budget says so; 13b's depth is what gets cut;
 14. the other model families at full width (budget ``FAMILY_BUDGET_S``),
     one configuration at a time, each freed before the next: bf16, seeded
     random weights, ``attention_impl="pallas"``, B=8 prompts
     (``FAMILY_RUNS``: recurrentgemma-9b at 4,096 tokens, all 38 layers;
     seamless-m4t-large-v2 with 2,048 source frames and a 128-token target,
     24 + 24 layers; phi3.5-moe at 16 of 32 layers, qwen3-moe at 8 of 94
     and internvl2-76b at 16 of 80, where one card's 80 GB forces the cut,
     at 2,048 tokens (internvl2 after 256 prefix embeddings); xlstm-1.3b
     at 2,048 tokens, all 48 layers). First the sm90 kernel against its
     plain version (2e-2) at every shape the configuration's prefill gives
     it, on its first attention layer's q/k/v of the prompts (the MoE and
     InternVL2 configurations' GQA at S=2,048 and 2,304; Dh=256 with the
     2,048 window; the encoder's self-attention, the decoder's causal
     self-attention and its cross-attention, Sq=128 against Sk=2,048),
     timed beside the plain version and SDPA at RecurrentGemma's and
     Seamless's (``steady_ms``: at least 10 ms of launches). Then the
     prefill (its time; the sm90 kernel's launches must equal the
     attention layers, 12, 72, 16, 8, 16 and 0, the SIMT kernel's 0) and
     16 greedy decode steps (each step's time; no launch), the peak
     ``max_memory_allocated``, and the agreement: the last decode logits
     against ``_forward_train`` of the whole sequence at its last
     position, except for the two MoE configurations, whose prefill logits
     under ``"pallas"`` are compared with the same weights under ``"xla"``
     (capacity dispatch depends on the grouping of tokens, so the
     whole-sequence forward is another function at the last position).
     In bf16 that gap is measured and printed: bf16 rounding alone moves
     some of these models' logits by more than 6e-2 at full width, in the
     reference as in the port. It is held at 6e-2 in fp32 on the same
     weights widened, the first two prompts and the bf16 run's tokens
     (the MoE cuts at half their depth, which is what fits the card in
     fp32). The bf16 main path is then held to that fp32 serving run: its
     distance from it at most twice the bf16 ``"xla"`` path's plus 1e-2
     (the MoE cuts again at half depth, prefill only). A run over the
     budget says so; qwen3-moe's depth is the first cut.

 15. training (budget ``TRAIN_BUDGET_S``): (a) TinyLlama-1.1B at full
     width and depth (22 layers, d=2,048, V=32,000), bf16, seeded random
     weights, ``attention_impl="chunked"``, B=8 sequences of 2,048 tokens
     from ``SyntheticCorpus(32000, seed=0)`` through ``PackedLoader``, 2
     microbatches, AdamW (lr 1e-3, one warm-up step), 8 steps of
     ``train_loop``: each step's time, tokens/s, ``model_flops`` over the
     step time and its share of the bf16 peak of ``analysis/hw.py``, the
     loss and grad norm, the peak ``max_memory_allocated``; the loss must
     be finite and fall from the first step to the last (if 80 GB does not
     hold it: ``remat_policy="full"``, then half the batch, said so); (b)
     a two-layer cut at full width in fp32 (B=1, S=2,048, so that
     ``"chunked"`` engages): one ``loss.backward()`` on the card and on the
     card's host from the same weights and batch, the loss within 1e-5
     relative and every gradient leaf within 1e-4 x its max|g|, and the
     card's ``"chunked"`` gradients against its ``"xla"`` ones within the
     same bound; (c) train -> checkpoint -> resume -> serve at a mid size
     (TinyLlama at d=512 with 8 heads of its Dh=64, 4 layers, V=32,000):
     24 steps with a checkpoint every 8 under ``chiprun_out/``, resumed to
     30 (the resumed loss below the first steps'), then the trained
     weights served under ``attention_impl="pallas"``: a prefill that
     launches the sm90 kernel once per layer, and 4 decode steps.

It then prints the kernel table as one JSON line and, last, the
``{"ok": true, "device": ...}`` line. It needs one card and no network;
without CUDA it exits 1 before doing anything.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and fp32 (non-tensor) peak.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: fp32 operations per flow and core in the kernel's step: 5 for li, 5 for
#: lj, 2 maxima.
OPS_PER_FLOW_CORE = 12
#: Bytes per flow the function must move: fi, fj, size in, choice out.
BYTES_PER_FLOW = 16
#: The chain floor of the chain kernel (derived from its source, not
#: measured): the dependent instructions from one flow's candidates to the
#: next flow's -- 2 per level of the argmin tree (compare, select), then
#: k == k*, the winner's bound and the max -- at CHAIN_CYCLES_PER_OP cycles
#: each (Hopper's fixed-latency integer/float pipes).
CHAIN_CYCLES_PER_OP = 5


def chain_dependent_ops(k_cores: int) -> int:
    return 2 * max(1, (k_cores - 1).bit_length()) + 3

TRACE_COFLOWS, TRACE_SEED = 526, 2026
N_PORTS, M_MAIN, RATES, DELTA = 150, 200, (10.0, 20.0, 30.0), 8.0
#: Coflows of phase 10's ablation grid: 25,217 flows at N=150. M=50 (54,251
#: flows) took 312.7 s on the card's host, over the phase's 150 s cap, the
#: priority-guard points most of it (PERF.md, PR 15).
M_GRID = 48
#: Worker processes of the pooled grids (phases 10 and 13c).
WORKERS = min(os.cpu_count() or 1, 16)
#: Phases 11-12: service ticks, evenly spaced over the arrival span, and
#: the budget of the two phases together on the card's host.
STREAM_TICKS, STREAM_BUDGET_S = 16, 150.0
#: Phase 13: its budget on the card's host, and the depth of 13b's oracle
#: gates (the trace cut to M_ORACLE coflows at N=150; the legacy per-core
#: loops rescan every pending flow at every event, so their time grows
#: faster than the flows).
ORACLE_BUDGET_S, M_ORACLE = 150.0, 16
#: tests/test_kernels_assign.py CASES: (F, K, N, delta).
CASES = [(64, 3, 16, 8.0), (200, 4, 32, 2.0), (129, 5, 16, 0.5), (32, 2, 8, 0.0)]

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak.
BF16_OPS_PER_S = 989e12
#: The sm90 kernel's edges (bf16): every S around its 128-row tiles with
#: both head dims, each mask and GQA group in turn; then every mask x group
#: at one ragged S. (B, S, H, KVH, Dh, causal, window).
FA_MASKS = [(True, None), (True, 1), (True, 70), (True, 128), (True, 300),
            (False, None)]
FA_GROUPS = [1, 2, 8]
FA_EDGES = [
    (1 if S > 1000 else 2, S, 8, 8 // FA_GROUPS[i % 3], Dh,
     *FA_MASKS[i % len(FA_MASKS)])
    for i, (S, Dh) in enumerate(
        (S, Dh) for S in (1, 63, 64, 65, 127, 128, 129, 200, 2064)
        for Dh in (64, 128))
] + [(1, 200, 8, 8 // g, 64, c, w) for c, w in FA_MASKS for g in FA_GROUPS]
#: tests/test_kernels_attention.py CASES: (B, S, H, KVH, Dh, causal, window,
#: dtype), then two ragged lengths (S not a multiple of the kernel's 64).
FA_CASES = [
    (2, 128, 4, 4, 64, True, None, "float32"),
    (2, 256, 4, 2, 64, True, None, "float32"),
    (1, 256, 8, 1, 128, True, None, "bfloat16"),
    (2, 256, 4, 1, 64, True, 128, "bfloat16"),
    (1, 128, 2, 2, 64, False, None, "float32"),
    (1, 512, 4, 4, 128, True, 256, "float32"),
    (3, 192, 6, 3, 64, True, None, "bfloat16"),
    (2, 200, 4, 2, 64, True, None, "float32"),
    (2, 2064, 8, 1, 64, True, None, "bfloat16"),
]
#: The serving phase: prompts, prompt length (TinyLlama's context), decode
#: steps, and the reference's serving tolerance (tests/test_system.py).
SERVE_B, SERVE_S, SERVE_STEPS, SERVE_TOL = 8, 2048, 16, 6e-2
#: Phase 14: (arch, layers run or None for all, prompt tokens, the sm90
#: kernel's launches in one prefill = its attention layers). B=8 prompts,
#: 16 decode steps; seamless's source has 2,048 frames. The budget of the
#: phase on the card's host; qwen3-moe's depth is its first cut.
FAMILY_RUNS = [("recurrentgemma-9b", None, 4096, 12),
               ("seamless-m4t-large-v2", None, 128, 72),
               ("phi3.5-moe-42b-a6.6b", 16, 2048, 16),
               ("qwen3-moe-235b-a22b", 8, 2048, 8),
               ("internvl2-76b", 16, 2048, 16),
               ("xlstm-1.3b", None, 2048, 0)]
FAMILY_B, FAMILY_SRC, FAMILY_BUDGET_S = 8, 2048, 200.0
#: Phase 15: full-width steps, batch (sequences of TinyLlama's 2,048-token
#: context) and microbatches; the mid-size run's steps before and after the
#: resume; the budget of the phase on the card.
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_MB = 8, 8, 2048, 2
MID_STEPS, MID_RESUME, TRAIN_BUDGET_S = 24, 30, 150.0


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    """``(fn(), host seconds)``, with the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn``, by CUDA events around ``reps`` calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def steady_ms(fn, window_ms: float = 10.0, min_reps: int = 5):
    """``(milliseconds a call, calls timed)``: after a warm call and one
    timed call, ``event_ms`` over enough calls (at least ``min_reps``) that
    the timed window lasts about ``window_ms``, so that a kernel of a few
    tens of microseconds is not read off a handful of launches."""
    fn()
    reps = max(min_reps, math.ceil(window_ms / event_ms(fn, 1)))
    return event_ms(fn, reps), reps


#: The largest |kernel - plain| each flash kernel showed in this run.
FA_MAX_ERR = {"sm90_bf16": 0.0, "simt_fp32": 0.0}


def fa_vs_plain(label, q, k, v, causal, window, quiet=False, phase=7):
    """One launch of the flash kernel of ``q``'s dtype against its plain
    version on the same inputs (atol = rtol 2e-2 in bf16, 1e-5 in fp32).
    Raises unless the kernel launched once, its output is finite and every
    element agrees. Returns max|kernel - plain|."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    kernel = fa.kernel_for(q.dtype)
    before = fa.launches_by_kernel[kernel]
    got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if fa.launches_by_kernel[kernel] != before + 1:
        raise AssertionError(f"{label} did not launch {kernel}")
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-5
    err = float((got.float() - want.float()).abs().max())
    bad = int((~torch.isclose(got.float(), want.float(), atol=tol,
                              rtol=tol)).sum())
    FA_MAX_ERR[kernel] = max(FA_MAX_ERR[kernel], err)
    if not quiet or bad:
        log(f"[{phase}] {label} ({kernel}): max|kernel - plain| {err:.3e}, "
            f"{bad} elements outside atol=rtol={tol:g}")
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash kernel != plain version on {label}")
    return err


def dense_layer0_qkv(model, tokens, prefix_embeds=None):
    """A dense model's first layer's q/k/v for a fresh prefill of
    ``tokens`` (after ``prefix_embeds``), rotated: what the prefill's
    first flash kernel launch is given."""
    import torch

    from repro_torch.models.common import apply_rope

    with torch.inference_mode():
        h = model._with_prefix(model._embed(tokens), prefix_embeds)
        B, S = h.shape[:2]
        pos = torch.arange(S, device=h.device).expand(B, S)
        q, k, v = model._qkv(model._norm(h, 0, "ln1"), 0)
        return (apply_rope(q, pos, model.inv_freq, model.rot),
                apply_rope(k, pos, model.inv_freq, model.rot), v)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on a GPU and has no CPU mode", file=sys.stderr)
        return 1

    from repro_torch.core import (build_flow_table, extract_flows,
                                  order_coflows, run_fast, sample_instance,
                                  synth_fb_trace, tail_cct, validate)
    from repro_torch.core.coflow import col_loads, row_loads
    from repro_torch.core.engine import (FlowTable, _ccts_from_times,
                                         _times_for_table)
    from repro_torch.kernels import _build
    from repro_torch.kernels import coflow_assign as ca
    from repro_torch.kernels.hazards import KINDS, hazard_stream
    from repro_torch.kernels.ops import coflow_assign

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(f"[1] nvidia-smi: {smi}")

    # ---- 2. build (both kernels start now, one nvcc each) ----------------
    builds = {}

    def build(name):
        t_b = time.perf_counter()
        try:
            _build.load(name)
            builds[name] = time.perf_counter() - t_b
        except BaseException as exc:  # re-raised by the phase that waits
            builds[name] = exc

    threads = {n: threading.Thread(target=build, args=(n,))
               for n in ("coflow_assign_sm90", "coflow_assign",
                         "flash_attention", "flash_attention_sm90")}
    for t in threads.values():
        t.start()

    def built(name):
        threads[name].join()
        if isinstance(builds[name], BaseException):
            raise builds[name]
        return builds[name]

    for name in ("coflow_assign_sm90", "coflow_assign"):
        log(f"[2] built {name}.cu in {built(name):.2f} s "
            f"({' '.join(_build.nvcc_flags(name))})")
        # one line per instance: the chain kernel has one per K and bitmap
        # place (mangled as ILi<K>ELb<shared>), the warp kernel one per place
        instance, spills = "", ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                k = re.search(r"ILi(\d)E", line)
                instance = (f"K={k.group(1)}, " if k else "") + "bitmap " + (
                    "shared" if "Lb1E" in line else "global")
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line:
                log(f"[2]   {name} {instance}: {line.split(':', 1)[1].strip()}"
                    f"; {spills}")
    smem_main, _ = ca._chain_smem_layout(len(RATES), N_PORTS)
    log(f"[2] chain kernel dynamic shared memory (not in ptxas' lines) at "
        f"K={len(RATES)}, N={N_PORTS}: {smem_main:,} B")

    max_err = {"chain_sm90": 0, "warp": 0}

    def kernel_vs_plain(label, fi, fj, sz, rates, delta, n_ports, phase=3,
                        kernel=None, quiet=False):
        name = kernel or ca.kernel_for(rates.numel())
        before = ca.launches_by_kernel[name]
        got = ca.coflow_assign_cuda(fi, fj, sz, rates, delta, n_ports=n_ports,
                                    kernel=kernel)
        torch.cuda.synchronize()
        if got.numel() and ca.launches_by_kernel[name] != before + 1:
            raise AssertionError(f"{label} did not launch the {name} kernel")
        want, plain_s = sync_time(lambda: ca.coflow_assign_plain(
            fi, fj, sz, rates, delta, n_ports=n_ports))
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        n_diff = int((got != want).sum())
        if not quiet or n_diff:
            log(f"[{phase}] {label} ({name}): F={fi.numel()} K={rates.numel()} "
                f"N={n_ports} delta={delta}: {n_diff} choices differ "
                f"(plain version {plain_s:.3f} s)")
        if n_diff:
            raise AssertionError(f"{name} kernel != plain version on {label}")
        return plain_s

    def on_card(fi, fj, sz, rates):
        return (torch.as_tensor(np.asarray(fi, np.int32), device=dev),
                torch.as_tensor(np.asarray(fj, np.int32), device=dev),
                torch.as_tensor(np.asarray(sz, np.float32), device=dev),
                torch.as_tensor(np.asarray(rates, np.float32), device=dev))

    # ---- 3. kernel vs plain version on the card -----------------------
    for F, K, N, delta in CASES:
        rng = np.random.default_rng(F + K)
        fi = rng.integers(0, N, F)
        fj = rng.integers(0, N, F)
        sz = rng.exponential(50, F)
        rates = np.sort(rng.uniform(5, 30, K))
        kernel_vs_plain(f"case {(F, K, N, delta)}", *on_card(fi, fj, sz, rates),
                        delta, N)
    empty = on_card([], [], [], [10.0, 20.0])
    out = ca.coflow_assign_cuda(*empty, 2.0, n_ports=8)
    if out.shape != (0,) or out.dtype != torch.int32:
        raise AssertionError("F=0 must return an empty int32 tensor")
    log("[3] F=0: empty int32 result, no launch")
    rng = np.random.default_rng(0)
    fi, fj = rng.integers(0, 8, 5), rng.integers(0, 8, 5)
    sz = rng.exponential(20, 5) + 0.1
    kernel_vs_plain("single block F=5", *on_card(fi, fj, sz, [10, 20, 30]), 4.0, 8)
    for N in (150, 512):
        rng = np.random.default_rng(N)
        ports = rng.choice(N, size=48, replace=False)  # repeats set nz bits
        fi = ports[rng.integers(0, 48, 4096)]
        fj = ports[rng.integers(0, 48, 4096)]
        sz = rng.exponential(50, 4096)
        rates = np.sort(rng.uniform(5, 30, 8))
        where = "shared" if ca._smem_layout(8, N)[3] else "global"
        kernel_vs_plain(f"K=8 N={N} (nz bitmap in {where} memory)",
                        *on_card(fi, fj, sz, rates), 8.0, N)

    n_streams = 0
    t_hz = time.perf_counter()
    for stream in KINDS:
        for K in range(1, ca.CHAIN_MAX_CORES + 1):
            for N in (8, 150, 512):
                fi, fj, sz, rates, delta = hazard_stream(stream, K, N)
                kernel_vs_plain(f"hazard stream {stream}",
                                *on_card(fi, fj, sz, rates), delta, N,
                                quiet=True)
                n_streams += 1
    log(f"[3] {n_streams} hazard streams ({len(KINDS)} kinds: ports repeated "
        f"at distances 1..4, runs of one port, ties, zero sizes; K=1..8; "
        f"N=8/150/512; 300 flows each): the chain kernel equals the plain "
        f"version on every one ({time.perf_counter() - t_hz:.1f} s)")
    for K in (9, 32):
        for stream in ("cell@1", "col@2", "mixed", "ties"):
            fi, fj, sz, rates, delta = hazard_stream(stream, K, N_PORTS)
            kernel_vs_plain(f"hazard stream {stream}",
                            *on_card(fi, fj, sz, rates), delta, N_PORTS)

    trace = synth_fb_trace(TRACE_COFLOWS, seed=TRACE_SEED)
    inst526, t_inst526 = sync_time(lambda: sample_instance(
        trace, N=N_PORTS, M=TRACE_COFLOWS, rates=RATES, delta=DELTA, seed=0,
        device=dev))
    _pos, _cid, fi526, fj526, sz526 = extract_flows(inst526, order_coflows(inst526))
    rates32 = inst526.rates.float()
    first = (fi526[:4096].int(), fj526[:4096].int(), sz526[:4096].float(),
             rates32)
    plain_4096_s = kernel_vs_plain(
        "first 4,096 pi-ordered flows of the M=526 trace instance", *first,
        DELTA, N_PORTS)
    kernel_vs_plain("first 4,096 pi-ordered flows of the M=526 trace "
                    "instance", *first, DELTA, N_PORTS, kernel="warp")

    # ---- 4. main path -----------------------------------------------------
    inst, t_inst = sync_time(lambda: sample_instance(
        trace, N=N_PORTS, M=M_MAIN, rates=RATES, delta=DELTA, seed=0, device=dev))
    log(f"[4] instance: M={inst.M} N={inst.N} K={inst.K} delta={inst.delta}; "
        f"sampled and moved to the card in {t_inst:.2f} s")
    ca.launches = 0
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)
    sched, t_run = sync_time(lambda: run_fast(inst, backend="kernel"))
    main_launches = dict(ca.launches_by_kernel)
    if main_launches != {"chain_sm90": 1, "warp": 0} or ca.launches != 1:
        raise AssertionError(f"run_fast must launch the chain kernel once and "
                             f"the warp kernel never; counted {main_launches}")
    _, t_val = sync_time(lambda: validate(sched))
    F = sched.n_flows
    ccts = sched.ccts
    if ccts.shape != (inst.M,) or not bool(torch.isfinite(ccts).all()) \
            or not bool((ccts > 0).all()):
        raise AssertionError("CCTs must be finite and positive, one per coflow")
    lb = inst.delta + torch.maximum(row_loads(inst.demand).amax(1),
                                    col_loads(inst.demand).amax(1)) / inst.R
    if not bool((ccts >= lb * (1 - 1e-12)).all()):
        raise AssertionError("a CCT is below its Lemma 1 lower bound")
    wcct, p95, p99 = sched.total_weighted_cct, tail_cct(sched, 0.95), tail_cct(sched, 0.99)
    log(f"[4] run_fast: {F} flows, assignment kernel launches {main_launches}, "
        f"{t_run:.3f} s end to end; validate passed in {t_val:.3f} s")
    log(f"[4] weighted CCT {wcct!r}  p95 CCT {p95!r}  p99 CCT {p99!r}  "
        f"(every CCT >= delta + rho/R)")

    # the same pipeline stage by stage, synchronised around each stage
    (pi, flows), t_extract = sync_time(
        lambda: (lambda p: (p, extract_flows(inst, p)))(order_coflows(inst)))
    pos, cid, fi, fj, size = flows
    core, t_kernel = sync_time(lambda: coflow_assign(
        fi, fj, size, inst.rates, inst.delta, n_ports=inst.N))
    table = FlowTable(pos=pos, cid=cid, fi=fi, fj=fj, core=core.long(), size=size)
    (t_est, srv), t_loop = sync_time(lambda: _times_for_table(inst, pi, table))
    ccts2, t_ccts = sync_time(lambda: _ccts_from_times(inst, pi, table, t_est, srv))
    if not torch.equal(ccts2, ccts):
        raise AssertionError("stage-by-stage CCTs differ from run_fast's")
    log(f"[4] stages: order+extract {t_extract:.4f} s | kernel {t_kernel:.4f} s "
        f"| host event loop (with copies) {t_loop:.3f} s | CCTs {t_ccts:.4f} s "
        f"| referee {t_val:.3f} s")

    small_trace = synth_fb_trace(200, seed=7)
    small = {d: sample_instance(small_trace, N=24, M=60, rates=RATES,
                                delta=DELTA, seed=3, device=d)
             for d in ("cuda", "cpu")}
    s_gpu, s_cpu = (run_fast(small[d], backend="kernel")
                    for d in ("cuda", "cpu"))
    validate(s_gpu)
    same = torch.equal(s_gpu.core.cpu(), s_cpu.core) and torch.equal(
        s_gpu.t_establish.cpu(), s_cpu.t_establish) and torch.equal(
        s_gpu.ccts.cpu(), s_cpu.ccts)
    if not same:
        raise AssertionError("small instance: GPU run differs from CPU run")
    log(f"[4] small instance (N=24, M=60, {s_gpu.n_flows} flows): GPU run "
        f"equals the CPU run (plain version) in choices, t_establish, CCTs")

    fi32, fj32, sz32 = fi.int(), fj.int(), size.float()
    plain_main_s = kernel_vs_plain("main path flows", fi32, fj32, sz32,
                                   inst.rates.float(), DELTA, N_PORTS, phase=4)
    warp_core = ca.coflow_assign_cuda(fi32, fj32, sz32, inst.rates.float(),
                                      DELTA, n_ports=N_PORTS, kernel="warp")
    if not torch.equal(warp_core, core):
        raise AssertionError("the warp kernel's choices differ on the main path")
    log("[4] the warp kernel (PRs 11-13's main path) makes the same 191,551 "
        "choices, so run_fast's weighted, p95 and p99 CCT are those it gave")

    # ---- 5. the whole trace ---------------------------------------------
    table526, t_table526 = sync_time(lambda: build_flow_table(
        inst526, order_coflows(inst526), backend="kernel"))
    if not bool(((table526.core >= 0) & (table526.core < inst526.K)).all()):
        raise AssertionError("a choice is outside [0, K)")
    args526 = (fi526.int(), fj526.int(), sz526.float(), rates32)
    chain526 = ca.coflow_assign_cuda(*args526, DELTA, n_ports=N_PORTS)
    warp526 = ca.coflow_assign_cuda(*args526, DELTA, n_ports=N_PORTS,
                                    kernel="warp")
    n_diff = int((chain526 != warp526).sum())
    log(f"[5] M=526: instance {t_inst526:.2f} s; build_flow_table "
        f"{t_table526:.3f} s for {table526.n_flows} flows, every choice in "
        f"[0, {inst526.K}); chain kernel vs warp kernel on all "
        f"{chain526.numel()} flows: {n_diff} choices differ")
    if n_diff:
        raise AssertionError("chain kernel != warp kernel on the M=526 trace")

    # Both kernels in turns (warp, chain, chain, warp) at both lengths, the
    # SM clock read beside each timing.
    def sm_clock_mhz() -> float:
        return float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True, timeout=60).stdout.split()[0])

    turns = {}
    for label, args in (("F=191,551", (fi32, fj32, sz32, inst.rates.float())),
                        ("F=443,943", args526)):
        n = args[0].numel()
        ca.coflow_assign_cuda(*args, DELTA, n_ports=N_PORTS)  # warm
        for kernel in ("warp", "chain_sm90", "chain_sm90", "warp"):
            t_ms = event_ms(lambda: ca.coflow_assign_cuda(
                *args, DELTA, n_ports=N_PORTS, kernel=kernel), reps=5)
            mhz = sm_clock_mhz()
            turns.setdefault((label, kernel), []).append((t_ms, mhz))
            log(f"[5] {label} {kernel}: {t_ms:.3f} ms, {1e6 * t_ms / n:.1f} "
                f"ns and {1e3 * t_ms * mhz / n:.0f} cycles per flow (SM clock "
                f"{mhz:.0f} MHz; {smi})")
        bytes_s = (BYTES_PER_FLOW * n + 4 * inst.K) / HBM_BYTES_PER_S
        ops_s = OPS_PER_FLOW_CORE * n * inst.K / FP32_OPS_PER_S
        floor_cycles = CHAIN_CYCLES_PER_OP * chain_dependent_ops(inst.K)
        floor_ms = floor_cycles * n / (1e3 * mhz)
        log(f"[5] {label}: roofline bound {1e3 * max(bytes_s, ops_s):.6f} ms "
            f"({'bytes' if bytes_s >= ops_s else 'operations'}); chain floor "
            f"{floor_ms:.3f} ms (derived: {chain_dependent_ops(inst.K)} "
            f"dependent instructions x {CHAIN_CYCLES_PER_OP} cycles = "
            f"{floor_cycles} cycles a flow at {mhz:.0f} MHz)")
    ms = sum(t for t, _ in turns[("F=191,551", "chain_sm90")]) / 2
    warp_ms = sum(t for t, _ in turns[("F=191,551", "warp")]) / 2
    if ms >= warp_ms:
        log(f"[5] the chain kernel ({ms:.3f} ms) is not faster than the warp "
            f"kernel ({warp_ms:.3f} ms) at F=191,551")
    bytes_s = (BYTES_PER_FLOW * F + 4 * inst.K) / HBM_BYTES_PER_S
    ops_s = OPS_PER_FLOW_CORE * F * inst.K / FP32_OPS_PER_S
    bound_ms = 1e3 * max(bytes_s, ops_s)
    log(f"[5] plain version: {1e3 * plain_main_s:.1f} ms at F={F}, "
        f"{1e3 * plain_4096_s:.1f} ms at 4,096 flows")

    fa_rows = serve_phases(torch, dev, built)
    log(f"[8] phases 1-8 took {time.perf_counter() - t_start:.1f} s")
    online_launches, oinst, ccts64, ogrid, offline64 = online_phases(
        torch, dev, kernel_vs_plain, trace, inst, sched)
    log(f"[10] phases 1-10 took {time.perf_counter() - t_start:.1f} s")
    stream_launches = stream_phases(torch, dev, oinst, ccts64, ogrid, sched)
    log(f"[12] phases 1-12 took {time.perf_counter() - t_start:.1f} s")
    oracle_launches = oracle_phases(torch, dev, trace, inst, sched,
                                    offline64)
    log(f"[13] phases 1-13 took {time.perf_counter() - t_start:.1f} s")
    family_launches, family_rows = family_phases(torch, dev)
    log(f"[14] phases 1-14 took {time.perf_counter() - t_start:.1f} s")
    train_launches = train_phases(torch, dev)
    log(f"[15] phases 1-15 took {time.perf_counter() - t_start:.1f} s")
    for row in fa_rows:  # phase 8's launches, phase 14's and phase 15's
        kernel = "sm90_bf16" if row["name"] == "flash_attention" \
            else "simt_fp32"
        row["launches"] += family_launches[kernel] + train_launches[kernel]
        row["max_abs_err"] = FA_MAX_ERR[kernel]  # over phases 7, 14, 15

    assign_row = {"route": "cuda",
                  "replaces": "src/repro/kernels/coflow_assign.py:38",
                  "plain_ms": 1e3 * plain_main_s, "bound_ms": bound_ms,
                  "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                  "library_ms": None}
    log(json.dumps({"kernels": [
        {"name": "coflow_assign",
         "source": "src/repro_torch/kernels/csrc/coflow_assign_sm90.cu",
         "launches": main_launches["chain_sm90"]
         + online_launches["chain_sm90"] + stream_launches["chain_sm90"]
         + oracle_launches["chain_sm90"],
         "max_abs_err": float(max_err["chain_sm90"]), "ms": ms, **assign_row},
        {"name": "coflow_assign_warp",
         "source": "src/repro_torch/kernels/csrc/coflow_assign.cu",
         "launches": main_launches["warp"] + online_launches["warp"]
         + stream_launches["warp"] + oracle_launches["warp"],
         "max_abs_err": float(max_err["warp"]), "ms": warp_ms, **assign_row},
        *fa_rows, *family_rows]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def online_phases(torch, dev, kernel_vs_plain, trace, inst, sched):
    """Phases 9-10: the online path at full width and the ablation grid.
    Returns phase 9's assignment-kernel launches by kernel, its online
    instance, the fp64 backend's online CCTs on it, phase 10's online
    instance, and phase 4's instance offline in fp64: ``(pi, flows,
    choices, CCTs)``."""
    from repro_torch.core import (ALGORITHMS, BACKENDS, assign_fast,
                                  extract_flows, online_orders,
                                  order_coflows, run_batch, run_fast,
                                  run_fast_metrics, run_fast_online,
                                  sample_instance, sample_online_instance,
                                  synth_fb_trace, tail_cct, validate,
                                  weighted_sum)
    from repro_torch.core.coflow import col_loads, row_loads
    from repro_torch.core.engine import (FlowTable, _ccts_from_times,
                                         _times_for_table)
    from repro_torch.kernels import coflow_assign as ca
    from repro_torch.kernels.ops import coflow_assign

    # ---- 9. the online path at full width ------------------------------
    span = float(sched.ccts.max())
    oinst, t_inst = sync_time(lambda: sample_online_instance(
        trace, N=N_PORTS, M=M_MAIN, rates=RATES, delta=DELTA, span=span,
        seed=0, device=dev))
    if not torch.equal(oinst.inst.demand, inst.demand):
        raise AssertionError("the online instance must hold phase 4's coflows")
    rel = oinst.releases
    log(f"[9] online instance: phase 4's {inst.M} coflows released over "
        f"[0, {span!r}] (phase 4's makespan) from the trace's arrival "
        f"stamps; sampled and moved to the card in {t_inst:.2f} s")
    ca.launches = 0
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)
    osched, t_run = sync_time(lambda: run_fast_online(oinst,
                                                      backend="kernel"))
    launches = dict(ca.launches_by_kernel)
    if launches != {"chain_sm90": 1, "warp": 0} or ca.launches != 1:
        raise AssertionError(f"run_fast_online must launch the chain kernel "
                             f"once and the warp kernel never; counted "
                             f"{launches}")
    _, t_val = sync_time(lambda: validate(osched, releases=rel))
    F = osched.n_flows
    ccts = osched.ccts
    if ccts.shape != (inst.M,) or not bool(torch.isfinite(ccts).all()) \
            or not bool((ccts > 0).all()):
        raise AssertionError("online CCTs must be finite and positive")
    lb = rel + (inst.delta + torch.maximum(row_loads(inst.demand).amax(1),
                                           col_loads(inst.demand).amax(1))
                / inst.R)
    if not bool((ccts >= lb * (1 - 1e-12)).all()):
        raise AssertionError("an online CCT is below release + delta + rho/R")
    wcct = osched.total_weighted_cct
    p95, p99 = tail_cct(osched, 0.95), tail_cct(osched, 0.99)
    log(f"[9] run_fast_online: {F} flows, assignment kernel launches "
        f"{launches}, {t_run:.3f} s end to end; validate(releases=) passed "
        f"in {t_val:.3f} s")
    log(f"[9] weighted CCT {wcct!r}  p95 CCT {p95!r}  p99 CCT {p99!r}  "
        f"(every CCT >= release + delta + rho/R); price of arrival "
        f"{wcct / sched.total_weighted_cct!r} (online / phase 4's weighted "
        f"CCT)")

    # the same pipeline stage by stage, synchronised around each stage
    (arrival, flows), t_order = sync_time(lambda: (lambda a: (
        a, extract_flows(inst, a)))(online_orders(inst, rel)[0]))
    pos, cid, fi, fj, size = flows
    core, t_kernel = sync_time(lambda: coflow_assign(
        fi, fj, size, inst.rates, inst.delta, n_ports=inst.N))
    table = FlowTable(pos=pos, cid=cid, fi=fi, fj=fj, core=core.long(),
                      size=size)
    (t_est, srv), t_loop = sync_time(lambda: _times_for_table(
        inst, arrival, table, releases=rel))
    ccts2, t_ccts = sync_time(lambda: _ccts_from_times(
        inst, arrival, table, t_est, srv))
    if not torch.equal(ccts2, ccts):
        raise AssertionError("stage-by-stage CCTs differ from run_fast_online's")
    log(f"[9] stages: online order+extract {t_order:.4f} s | kernel "
        f"{t_kernel:.4f} s | host event loop (with copies) {t_loop:.3f} s | "
        f"CCTs {t_ccts:.4f} s | referee {t_val:.3f} s")

    fi32, fj32, sz32 = fi.int(), fj.int(), size.float()
    rates32 = inst.rates.float()
    warp = ca.coflow_assign_cuda(fi32, fj32, sz32, rates32, DELTA,
                                 n_ports=N_PORTS, kernel="warp")
    n_diff = int((warp != core).sum())
    log(f"[9] chain kernel vs warp kernel on all {F} arrival-ordered flows: "
        f"{n_diff} choices differ")
    if n_diff:
        raise AssertionError("chain kernel != warp kernel on the online flows")
    kernel_vs_plain("first 4,096 arrival-ordered flows", fi32[:4096],
                    fj32[:4096], sz32[:4096], rates32, DELTA, N_PORTS, phase=9)
    # The kernel keeps its state in fp32 (the Pallas kernel's contract);
    # the fp64 host backend is the reference's default. Their agreement and
    # the weighted-CCT drift it causes are printed beside the reference's
    # stated contract (>= 97%, < 2%), which its stress test checks at
    # F of about 4,000: one flipped near-tie changes every later prefix
    # state, so the agreement is printed by prefix too.
    fp64, t_fp64 = sync_time(lambda: assign_fast(inst, arrival, flows=flows))
    same = fp64 == table.core
    prefixes = "; ".join(f"first {n:,}: {float(same[:n].float().mean()):.4%}"
                         for n in (4096, 16384, 65536) if n < F) or "-"
    first_diff = int(torch.nonzero(~same)[0, 0]) if not bool(same.all()) else F
    log(f"[9] kernel (fp32 state) vs the fp64 host backend on the online "
        f"flows: {int(same.sum())} of {F} choices agree "
        f"({float(same.float().mean()):.4%}; the reference's contract: >= "
        f"97%); {prefixes}; first difference at flow {first_diff}; the fp64 "
        f"backend took {t_fp64:.3f} s")
    off_pi = order_coflows(inst)
    off_flows = extract_flows(inst, off_pi)
    off_choices = assign_fast(inst, off_pi, flows=off_flows)
    off_same = off_choices == coflow_assign(
        *off_flows[2:], inst.rates, inst.delta, n_ports=inst.N).long()
    log(f"[9] the same offline (phase 4's pi-ordered flows): "
        f"{int(off_same.sum())} of {F} agree "
        f"({float(off_same.float().mean()):.4%})")
    fp64_ccts = {}
    for mode, w32, releases in (("online", wcct, rel),
                                 ("offline", sched.total_weighted_cct, None)):
        (ccts64, _), t_run64 = sync_time(lambda: run_fast_metrics(
            inst, releases=releases, backend="numpy"))
        fp64_ccts[mode] = ccts64
        w64 = weighted_sum(inst.weights, ccts64)
        log(f"[9] weighted CCT {mode} with the fp64 backend's choices "
            f"{w64!r} ({t_run64:.3f} s); drift of the kernel's "
            f"{abs(w32 - w64) / w64:.4%} (the reference's contract: < 2%)")

    # ---- 10. the ablation grid -----------------------------------------
    t10 = time.perf_counter()
    policies = ("work-conserving", "priority-guard", "reserving")
    grid = sample_instance(trace, N=N_PORTS, M=M_GRID, rates=RATES,
                           delta=DELTA, seed=0, device=dev)
    kw = dict(schedulings=policies, materialize="metrics", check="none")
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)
    # the online releases span the offline makespan of ours work-conserving,
    # the grid's first point: run it alone first, then both grids together
    first = run_batch([grid], ("ours",), backend="numpy",
                      **{**kw, "schedulings": policies[:1]}).rows[0]
    span_g = first.makespan
    ogrid = sample_online_instance(trace, N=N_PORTS, M=M_GRID, rates=RATES,
                                   delta=DELTA, span=span_g, seed=0,
                                   device=dev)
    host, t_pool = sync_time(lambda: run_batch(
        [grid, ogrid], ALGORITHMS, backend="numpy", workers=WORKERS, **kw))
    host_launches = dict(ca.launches_by_kernel)
    kern, t_kpool = sync_time(lambda: run_batch(
        [grid, ogrid], ("ours", "sunflow-core"), backend="kernel",
        workers=WORKERS, **kw))
    grid_launches = dict(ca.launches_by_kernel)
    offline, online = host.filter(instance=0), host.filter(instance=1)
    if dataclasses.replace(first, wall_s=0.0) != dataclasses.replace(
            offline.rows[0], wall_s=0.0):
        raise AssertionError("the pool's first point differs from its "
                             "serial run")
    # the pool against serial runs of the grid's four cheapest points
    cheap = sorted(host.rows, key=lambda r: r.wall_s)[:4]
    for r in cheap:
        one = run_batch([(grid, ogrid)[r.instance]], (r.algorithm,),
                        seeds=(r.seed,), backend="numpy", **{
                            **kw, "schedulings": (r.scheduling,)}).rows[0]
        if dataclasses.replace(one, instance=r.instance, wall_s=0.0) != \
                dataclasses.replace(r, wall_s=0.0):
            raise AssertionError(f"pool row {r} != serial row {one}")
    t10 = time.perf_counter() - t10
    if host_launches != {"chain_sm90": 0, "warp": 0} or grid_launches != {
            "chain_sm90": len(kern), "warp": 0}:
        raise AssertionError(f"the host backend must launch nothing and each "
                             f"kernel point the chain kernel once; counted "
                             f"{host_launches}, then {grid_launches}")
    log(f"[10] ablation grid on the M={M_GRID}, N={N_PORTS} trace instance "
        f"({offline.rows[0].n_flows} flows; online releases over its offline "
        f"makespan {span_g!r}): {len(host) + len(kern)} points in {t10:.1f} "
        f"s through run_batch(workers={WORKERS}) (spawn pool; fp64 grid "
        f"{len(host)} points in {t_pool:.1f} s, kernel grid {len(kern)} in "
        f"{t_kpool:.1f} s), chain kernel launches {grid_launches} counted in "
        f"the workers (one per kernel point, none on the host backend); the "
        f"four cheapest fp64 points equal their serial runs but for wall_s")
    for mode, idx, tab in (("offline", 0, offline), ("online", 1, online)):
        base = tab.filter(algorithm="ours",
                          scheduling="work-conserving").rows[0].weighted_cct
        rows = [("numpy", r) for r in tab] + [
            ("kernel", r) for r in kern.filter(instance=idx)]
        for backend, r in rows:
            log(f"[10]   {mode:7s} {backend:6s} {r.algorithm:12s} "
                f"{r.scheduling:15s} weighted CCT {r.weighted_cct!r} "
                f"({r.weighted_cct / base:.4f} x ours work-conserving fp64)"
                f"  p99 {r.p99!r}  wall {r.wall_s:.3f} s")
    if t10 > 150:
        log(f"[10] the grid took {t10:.1f} s, more than 150 s: cut M_GRID")

    small_trace = synth_fb_trace(200, seed=7)
    small = {d: sample_instance(small_trace, N=24, M=60, rates=RATES,
                                delta=DELTA, seed=3, device=d)
             for d in (dev, "cpu")}
    span_s = float(run_fast(small["cpu"], backend="kernel").ccts.max())
    osmall = {d: sample_online_instance(small_trace, N=24, M=60, rates=RATES,
                                        delta=DELTA, span=span_s, seed=3,
                                        device=d)
              for d in (dev, "cpu")}
    n_points = 0
    for backend in BACKENDS:
        for alg in ALGORITHMS:
            for sched_ in (("sunflow",) if "sunflow" in alg else policies):
                kw = dict(seed=3, scheduling=sched_, backend=backend)
                for mode in ("offline", "online"):
                    if mode == "offline":
                        gpu = run_fast(small[dev], alg, **kw)
                        cpu = run_fast(small["cpu"], alg, **kw)
                        validate(gpu)
                    else:
                        gpu = run_fast_online(osmall[dev], alg, **kw)
                        cpu = run_fast_online(osmall["cpu"], alg, **kw)
                        validate(gpu, releases=osmall[dev].releases)
                    for name in ("pi", "core", "t_establish", "ccts"):
                        if not torch.equal(getattr(gpu, name).cpu(),
                                           getattr(cpu, name)):
                            raise AssertionError(
                                f"small instance, {mode} {alg} {sched_} "
                                f"{backend}: GPU {name} differs from CPU")
                    n_points += 1
    log(f"[10] small instance (N=24, M=60, {cpu.n_flows} flows): all "
        f"{n_points} grid points (5 algorithms x their policies x "
        f"{len(BACKENDS)} backends x offline/online) equal on GPU and CPU in "
        f"choices, t_establish and CCTs, and pass validate")
    return launches, oinst, fp64_ccts["online"], ogrid, (
        off_pi, off_flows, off_choices, fp64_ccts["offline"])


def fault_events(span: float) -> list:
    """Phase 12's scripted churn over a stream of span ``span``: core 2 down
    and back up, a port flap on core 1, core 0's delay drifting to 12."""
    from repro_torch.core import CoreDown, CoreUp, DeltaDrift, PortFlap

    return [CoreDown(t=0.25 * span, core=2), CoreUp(t=0.5 * span, core=2),
            PortFlap(t=0.6 * span, t_end=0.62 * span, core=1, port=0),
            DeltaDrift(t=0.7 * span, core=0, delta=12.0)]


def late_fault(span: float, T: float):
    """The fault reported after phase 12's middle tick, discovered late:
    core 2, back since half the span, failed again a twentieth of the span
    before that tick, so circuits committed on it since are retro-aborted."""
    from repro_torch.core import CoreDown

    return CoreDown(t=T - 0.05 * span, core=2)


def tick_batches(oinst, n_ticks: int):
    """The tick partition of ``examples/serve_fabric.py``: ``n_ticks``
    evenly spaced ticks over the arrival span, each with the
    ``arrival_stream`` pairs ``(coflow, release)`` released in
    ``(previous tick, T]``. Yields ``(x, T, batch, span)``."""
    from repro_torch.core import arrival_stream

    arrivals = list(arrival_stream(oinst))
    span = float(oinst.releases.max())
    nxt = 0
    for x, T in enumerate(np.linspace(span / n_ticks, span, n_ticks)):
        end = nxt
        while end < len(arrivals) and arrivals[end][1] <= T:
            end += 1
        yield x, float(T), arrivals[nxt:end], span
        nxt = end


def serve_stream(mgr, oinst, n_ticks: int, late=None, on_tick=None) -> list:
    """The service loop: every coflow of a tick's batch ``submit``ted, then
    the ``tick``, over :func:`tick_batches`, then ``flush``. ``late(span,
    T)`` gives a fault reported after the middle tick. Returns the tick
    reports (the flush's last)."""
    reports = []
    for x, T, batch, span in tick_batches(oinst, n_ticks):
        for arrival in batch:
            mgr.submit(*arrival)
        reports.append(mgr.tick(T))
        if on_tick is not None:
            on_tick(reports[-1])
        if late is not None and x == n_ticks // 2:
            mgr.report_fault(late(span, T))
    reports.append(mgr.flush())
    if on_tick is not None:
        on_tick(reports[-1])
    return reports


def drive_state(st, oinst, n_ticks: int, late=None) -> list:
    """``FabricState`` alone over :func:`tick_batches`, the late fault
    applied after the middle tick. Returns every ``TickCommit``, the
    finalize tick's last."""
    commits = []
    for x, T, batch, span in tick_batches(oinst, n_ticks):
        commits.append(st.step([c for c, _ in batch],
                               np.array([r for _, r in batch], np.float64),
                               T))
        if late is not None and x == n_ticks // 2:
            st.apply_fault(late(span, T))
    commits.append(st.finalize())
    return commits


def span_totals(records: list) -> dict:
    """Host seconds per span name over a trace (each span ends in a device
    synchronise)."""
    out: dict = {}
    for r in records:
        if r["kind"] == "span":
            out[r["name"]] = out.get(r["name"], 0.0) + r["dur"]
    return out


def stream_phases(torch, dev, oinst, ccts64, foinst, sched):
    """Phases 11-12: the streaming fabric manager at full width on phase 9's
    online instance ``oinst``, the one-shot plane on phase 4's instance,
    held to phase 4's ``run_fast(backend="kernel")`` schedule ``sched``, and
    the fault plane on ``foinst`` (phase 10's online instance). ``ccts64``
    are phase 9's fp64 online CCTs by coflow id. Returns phase 11's
    assignment-kernel launches by kernel."""
    from repro_torch.core import FabricState, FaultInjector
    from repro_torch.core import run_fast_metrics, sample_online_instance
    from repro_torch.core import run_fast_online, synth_fb_trace, weighted_sum
    from repro_torch.kernels import coflow_assign as ca
    from repro_torch.obs import Tracer
    from repro_torch.service import FabricConfig, FabricManager
    from repro_torch.service import compile_schedule

    # ---- 11. the streaming service at full width -------------------------
    t11 = time.perf_counter()
    inst = oinst.inst
    M = inst.M
    rel = oinst.releases.cpu().numpy()
    span = float(rel.max())
    F = int((inst.demand > 0).sum())
    tracer = Tracer()
    cfg = dict(rates=RATES, delta=DELTA, N=N_PORTS, max_queue_depth=M)
    mgr = FabricManager(FabricConfig(**cfg), tracer=tracer, device=dev)
    log(f"[11] streaming service: phase 9's {M} coflows ({F} flows, "
        f"released over [0, {span!r}]), {STREAM_TICKS} ticks, then flush")

    def show(phase):
        def one(rep):
            log(f"[{phase}]   tick t={rep.t_now!r}: admitted {rep.admitted}, "
                f"committed {rep.committed_flows}, finalized "
                f"{rep.finalized}, backlog {rep.pending_flows} flows, "
                f"components touched {rep.components_touched} of "
                f"{rep.components_total}, aborted {rep.aborted}, wall "
                f"{rep.wall_s:.3f} s")
        return one

    ca.launches = 0
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)
    reports = serve_stream(mgr, oinst, STREAM_TICKS, on_tick=show(11))
    stream_launches = dict(ca.launches_by_kernel)
    summ = mgr.summary()
    if (summ["flows_committed"], summ["pending_flows"],
            summ["coflows_finalized"]) != (F, 0, M):
        raise AssertionError(f"the stream must commit all {F} flows of "
                             f"{M} coflows; summary {summ}")
    if stream_launches != {"chain_sm90": 0, "warp": 0}:
        raise AssertionError(f"the streaming plane assigns on the fp64 host "
                             f"backend and launches nothing; counted "
                             f"{stream_launches}")
    # the replay: coflows in admission order (= release order)
    order = np.argsort(rel, kind="stable")
    order_t = torch.from_numpy(order).to(dev)
    got = mgr.ccts()
    if np.unique(rel).size == M:
        want = ccts64[order_t]
        how = ("phase 9's fp64 run_fast_metrics(releases=), in admission "
               "order (the releases are untied)")
    else:
        replay = dataclasses.replace(inst, demand=inst.demand[order_t],
                                     weights=inst.weights[order_t],
                                     cids=inst.cids[order_t])
        want, _ = run_fast_metrics(replay, releases=rel[order],
                                   backend="numpy")
        how = "an fp64 run_fast_online replay in admission order"
    if not torch.equal(got, want):
        bad = int(torch.nonzero(got != want)[0, 0])
        raise AssertionError(f"stream CCT of admission {bad} "
                             f"{float(got[bad])!r} != replay "
                             f"{float(want[bad])!r}")
    program = mgr.program()
    _, t_val = sync_time(program.validate)
    if program.n_segments != F or program.device.type != torch.device(
            dev).type:
        raise AssertionError("the program of record must hold every flow, "
                             "on the card")
    walls = [r.wall_s for r in reports]
    log(f"[11] {summ['ticks']} ticks ({len(reports) - 1} + flush) committed "
        f"all {F} flows; CCTs equal {how}, bit for bit; program().validate() "
        f"passed on the card in {t_val:.3f} s; assignment kernel launches "
        f"{stream_launches}")
    log(f"[11] summary: ticks {summ['ticks']}, rows reused "
        f"{summ['tent_reused']} / recomputed {summ['tent_recomputed']} "
        f"(reuse {summ['tent_reuse_fraction']:.4%}), components "
        f"{summ['components_touched']} touched of "
        f"{summ['components_total']}, backlog peak "
        f"{max(r.pending_flows for r in reports)} flows, decision latency "
        f"p50 {summ['decision_latency_p50_s']:.3f} s p99 "
        f"{summ['decision_latency_p99_s']:.3f} s, {summ['coflows_per_s']:.2f} "
        f"coflows/s; tick wall total {sum(walls):.3f} s, max "
        f"{max(walls):.3f} s")
    spans = span_totals(tracer.records)
    log("[11] host seconds by span (each ends in a synchronise): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                           key=lambda kv: -kv[1])))
    ca.launches = 0
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)
    (p1, hit1), t_miss = sync_time(
        lambda: mgr.schedule_instance(sched.inst, backend="kernel"))
    after_miss = dict(ca.launches_by_kernel)
    (p2, hit2), t_hit = sync_time(
        lambda: mgr.schedule_instance(sched.inst, backend="kernel"))
    oneshot_launches = dict(ca.launches_by_kernel)
    if (hit1, hit2) != (False, True) or after_miss != {
            "chain_sm90": 1, "warp": 0} or oneshot_launches != after_miss:
        raise AssertionError(f"the one-shot plane must launch the chain "
                             f"kernel once on the miss and not on the hit; "
                             f"hits {(hit1, hit2)}, launches {after_miss} "
                             f"then {oneshot_launches}")
    fields = ("core", "ingress", "egress", "cid", "size", "t_establish",
              "t_complete")
    if not all(torch.equal(getattr(p1, f), getattr(p2, f)) for f in fields):
        raise AssertionError("the cache hit's program differs from the miss's")
    # segments sort by (core, t_establish, ingress), a unique key: equal
    # arrays mean the same (coflow, ingress, egress) -> core and times
    want1 = compile_schedule(sched)
    if not all(torch.equal(getattr(p1, f), getattr(want1, f))
               for f in fields):
        raise AssertionError("the one-shot plane's program differs from "
                             "phase 4's run_fast(backend=\"kernel\")")
    _, t_val1 = sync_time(p1.validate)
    t11 = time.perf_counter() - t11
    log(f"[11] one-shot plane, backend=\"kernel\", phase 4's instance: miss "
        f"{t_miss:.3f} s (chain kernel launches {after_miss}), hit "
        f"{t_hit:.4f} s (none more), byte-identical {p1.n_segments}-segment "
        f"programs equal to phase 4's schedule, validated in {t_val1:.3f} s; "
        f"phase 11 took {t11:.1f} s")

    # ---- 12. the fault plane -------------------------------------------
    t12 = time.perf_counter()
    finst = foinst.inst
    fM, fF = finst.M, int((finst.demand > 0).sum())
    frel = foinst.releases.cpu().numpy()
    fspan = float(frel.max())
    log(f"[12] the faulted stream is phase 10's M={fM} online instance "
        f"({fF} flows, released over [0, {fspan!r}]), cut from phase 11's "
        f"M={M}, where phases 11-12 can overrun their "
        f"{STREAM_BUDGET_S:.0f} s budget (PERF.md section 5)")
    mgr2 = FabricManager(FabricConfig(
        **{**cfg, "max_queue_depth": fM},
        faults=FaultInjector(fault_events(fspan))), device=dev)
    reports2 = serve_stream(mgr2, foinst, STREAM_TICKS, late=late_fault,
                            on_tick=show(12))
    summ2 = mgr2.summary()
    if summ2["faults_applied"] != 5 or summ2["pending_flows"] \
            or summ2["coflows_finalized"] != fM:
        raise AssertionError(f"the faulted stream must apply 5 faults and "
                             f"finalize all {fM} coflows; summary {summ2}")
    program2 = mgr2.program()
    _, t_val2 = sync_time(program2.validate)
    forder = torch.from_numpy(np.argsort(frel, kind="stable")).to(dev)
    sent = torch.zeros_like(finst.demand)
    sent.index_put_((program2.cid, program2.ingress, program2.egress),
                    program2.size, accumulate=True)
    if not torch.equal(sent, finst.demand[forder]):
        raise AssertionError("the faulted program of record does not deliver "
                             "each coflow's demand exactly once")
    ccts2 = mgr2.ccts()
    if not bool(torch.isfinite(ccts2).all()) or not bool((ccts2 > 0).all()):
        raise AssertionError("a faulted stream's CCT is not finite")
    for fr in mgr2.fault_reports:
        log(f"[12]   {fr.event}: aborted {fr.aborted}, requeued "
            f"{fr.requeued}, reassigned {fr.reassigned_pending}, "
            f"unfinalized {len(fr.unfinalized)}, teardowns "
            f"{len(fr.teardowns)}")
    log(f"[12] faulted stream ({fM} coflows, {fF} flows, 4 injected faults "
        f"+ 1 reported late): {program2.n_segments} segments of record "
        f"(aborted ones dropped) validated on the card in {t_val2:.3f} s, "
        f"every coflow's bytes delivered exactly once, every CCT finite; "
        f"circuits aborted {summ2['circuits_aborted']}, flows requeued "
        f"{summ2['flows_requeued']}, rows invalidated "
        f"{summ2['tent_invalidated']}; weighted CCT (summed in admission "
        f"order) {weighted_sum(mgr2.state.weights(), mgr2.ccts())!r}; "
        f"tick wall total {sum(r.wall_s for r in reports2):.3f} s")
    trace = synth_fb_trace(526, seed=2026)
    off = sample_online_instance(trace, N=16, M=80, rates=RATES, delta=DELTA,
                                 span=0.0, seed=7, device="cpu")
    s_span = float(run_fast_online(off).ccts.max())
    commits = {}
    for d in (dev, "cpu"):
        so = sample_online_instance(trace, N=16, M=80, rates=RATES,
                                    delta=DELTA, span=s_span, seed=7,
                                    device=d)
        st = FabricState(rates=RATES, delta=DELTA, N=16, device=d,
                         faults=FaultInjector(fault_events(s_span)))
        commits[d] = (drive_state(st, so, 12, late=late_fault), st)
    (gc, gst), (cc, cst) = commits[dev], commits["cpu"]
    for x, (g, c) in enumerate(zip(gc, cc)):
        same = all(torch.equal(getattr(g, f).cpu(), getattr(c, f))
                   for f in ("gid", "cid", "fi", "fj", "core", "size",
                             "t_establish", "t_complete"))
        same &= (g.finalized, g.n_pending, g.unfinalized) == (
            c.finalized, c.n_pending, c.unfinalized)
        same &= (g.delta_f is None) == (c.delta_f is None) and (
            g.delta_f is None or torch.equal(g.delta_f.cpu(), c.delta_f))
        same &= [a.aborted for a in g.faults] == [a.aborted for a in c.faults]
        if not same:
            raise AssertionError(f"small faulted stream: tick {x} commits "
                                 f"differ between the card and the CPU")
    if not torch.equal(gst.ccts().cpu(), cst.ccts()) or \
            gst.aborted_keys() != cst.aborted_keys():
        raise AssertionError("small faulted stream: CCTs differ")
    t12 = time.perf_counter() - t12
    log(f"[12] small faulted stream (N=16, M=80, {sum(c.n_flows for c in gc)} "
        f"commits over {len(gc)} ticks, {len(gst.fault_log)} faults, "
        f"{sum(a.n_aborted for a in gst.fault_log)} circuits aborted): every "
        f"TickCommit equal on the card and the CPU; phase 12 took {t12:.1f} s")
    log(f"[12] phases 11-12 took {t11 + t12:.1f} s (budget "
        f"{STREAM_BUDGET_S:.0f} s)")
    if t11 + t12 > STREAM_BUDGET_S:
        log(f"[12] over the budget even so: phase 11 alone took {t11:.1f} s")
    return {k: stream_launches[k] + oneshot_launches[k] for k in ca.KERNELS}


def oracle_phases(torch, dev, trace, inst, sched, offline64):
    """Phase 13: the paper's guarantee and its oracles. ``inst`` and
    ``sched`` are phase 4's instance and kernel schedule, ``offline64`` its
    fp64 ``(pi, flows, choices, CCTs)`` from phase 9. Returns the phase's
    assignment-kernel launches by kernel."""
    from repro_torch.core import (ALGORITHMS, assignment_from_choices,
                                  check_lemma1, check_lemma2, check_lemma3,
                                  check_theorem1, check_theorem2,
                                  cross_check, cross_check_online,
                                  extract_flows, gamma_w, order_coflows,
                                  online_orders, run, run_batch, run_fast,
                                  sample_instance, sample_online_instance,
                                  schedule_all_cores, synth_fb_trace,
                                  validate)
    from repro_torch.core.engine import _choices_of, _kernel_divergence
    from repro_torch.kernels import coflow_assign as ca

    t13 = time.perf_counter()
    ca.launches = 0
    ca.launches_by_kernel = dict.fromkeys(ca.KERNELS, 0)

    # ---- 13a. the certificates at full width and depth -------------------
    pi, flows, choices, ccts64 = offline64
    a, t_a = sync_time(lambda: assignment_from_choices(inst, pi, flows,
                                                       choices))
    s64, t_s = sync_time(lambda: schedule_all_cores(inst, pi, a))
    if not torch.equal(s64.ccts, ccts64):
        bad = int(torch.nonzero(s64.ccts != ccts64)[0, 0])
        raise AssertionError(f"schedule_all_cores CCT of coflow {bad} "
                             f"{float(s64.ccts[bad])!r} != phase 9's fp64 "
                             f"{float(ccts64[bad])!r}")
    _, t_v = sync_time(lambda: validate(s64))
    log(f"[13a] phase 9's offline fp64 choices on phase 4's instance "
        f"({s64.n_flows} flows): assignment_from_choices {t_a:.3f} s, "
        f"schedule_all_cores {t_s:.3f} s, validate {t_v:.3f} s; CCTs equal "
        f"phase 9's fp64 run_fast_metrics bit for bit; weighted CCT "
        f"{s64.total_weighted_cct!r}")
    certs, t_c = {}, {}
    for name, fn in (("lemma1", check_lemma1), ("lemma2", check_lemma2),
                     ("theorem1", check_theorem1),
                     ("lemma3", lambda x: check_lemma3(x, strict=False)),
                     ("theorem2", lambda x: check_theorem2(x, strict=False))):
        certs[name], t_c[name] = sync_time(lambda: fn(s64))

    def lemma1_line(res):
        ccts, lbs = res["ccts"].cpu().numpy(), res["lbs"].cpu().numpy()
        pos = lbs > 0
        ratio = float((ccts[pos] / lbs[pos]).min())
        return (f"min CCT / (delta + rho/R) {ratio!r} (bound 1, "
                f"{int(pos.sum())} coflows)")

    def theorem_line(res):
        return (f"sum w T / sum w T_LB {res['empirical_ratio']!r} against "
                f"its bound {float(res['bound'])!r}")

    l2 = max(lhs / rhs for lhs, rhs in certs["lemma2"]["pairs"] if rhs > 0)
    l3 = certs["lemma3"]
    l3_worst = float(max(t / b for t, b in l3["pairs"] if b > 0))
    t2 = certs["theorem2"]
    t2_holds = t2["empirical_ratio"] <= t2["bound"]
    log(f"[13a] Lemma 1 holds: {lemma1_line(certs['lemma1'])} "
        f"({t_c['lemma1']:.3f} s)")
    log(f"[13a] Lemma 2 holds: max_m max_k T_LB^k(D^k_1:m) / (rho_1:m/r_max "
        f"+ tau_1:m delta) {l2!r} (bound 1; {t_c['lemma2']:.3f} s)")
    log(f"[13a] Theorem 1 holds: {theorem_line(certs['theorem1'])} "
        f"({t_c['theorem1']:.3f} s)")
    log(f"[13a] Lemma 3 (strict=False): violated at {len(l3['violations'])} "
        f"of {inst.M} positions; worst T_pi(m) / (2 max_k T_LB^k) "
        f"{l3_worst!r} (bound 1; {t_c['lemma3']:.3f} s)")
    log(f"[13a] Theorem 2 (strict=False): "
        f"{'holds' if t2_holds else 'violated'}: {theorem_line(t2)} "
        f"({t_c['theorem2']:.3f} s); gamma_w {gamma_w(inst.weights)!r}, psi "
        f"{inst.psi}")
    k1, k_t1 = check_lemma1(sched), check_theorem1(sched)
    log(f"[13a] phase 4's kernel schedule: Lemma 1 holds: {lemma1_line(k1)}; "
        f"Theorem 1 holds: {theorem_line(k_t1)}")
    # the kernel gate's assignment half at full depth (its legacy replay
    # does not fit the phase): phase 4's kernel choices vs assign_ref
    (kd, ka), t_kd = sync_time(lambda: _kernel_divergence(
        inst, flows, _choices_of(sched, pi, flows, "phase 4")))
    log(f"[13a] the kernel gate at full depth: {kd} of {s64.n_flows} of "
        f"phase 4's kernel choices differ from assign_ref at fp32 inputs "
        f"(allowance {ka}), so cross_check(backend=\"kernel\") at "
        f"M={inst.M} would {'raise' if kd > ka else 'pass'} its assignment "
        f"gate "
        f"({t_kd:.3f} s)")
    t13a = time.perf_counter() - t13

    # ---- 13b. the oracle gates, backend="kernel" -------------------------
    t13b = time.perf_counter()
    cut = sample_instance(trace, N=N_PORTS, M=M_ORACLE, rates=RATES,
                          delta=DELTA, seed=0, device=dev)
    gates = {}
    for mode in ("offline", "online"):
        before = dict(ca.launches_by_kernel)
        if mode == "offline":
            fast, t_g = sync_time(lambda: cross_check(cut, "ours",
                                                      backend="kernel"))
            gi, order = cut, order_coflows(cut)
            oinst = sample_online_instance(
                trace, N=N_PORTS, M=M_ORACLE, rates=RATES, delta=DELTA,
                span=float(fast.ccts.max()), seed=0, device=dev)
        else:
            fast, t_g = sync_time(lambda: cross_check_online(
                oinst, "ours", backend="kernel"))
            gi = oinst.inst
            order = online_orders(gi, oinst.releases)[0]
        n = {k: ca.launches_by_kernel[k] - before[k] for k in ca.KERNELS}
        if n != {"chain_sm90": 1, "warp": 0}:
            raise AssertionError(f"cross_check ({mode}, kernel) must launch "
                                 f"the chain kernel once; counted {n}")
        fl = extract_flows(gi, order)
        diverged, allowed = _kernel_divergence(
            gi, fl, _choices_of(fast, order, fl, mode))
        gates[mode] = t_g
        log(f"[13b] cross_check{'_online' if mode == 'online' else ''}"
            f"(backend=\"kernel\") at M={M_ORACLE}, N={N_PORTS} "
            f"({fast.n_flows} flows): passed in {t_g:.3f} s, launches {n}; "
            f"kernel vs assign_ref at fp32 inputs: {diverged} of "
            f"{fast.n_flows} choices diverge (allowance {allowed})")
    t13b = time.perf_counter() - t13b
    log(f"[13b] the gates at M_ORACLE={M_ORACLE} took {t13b:.1f} s (offline "
        f"{gates['offline']:.1f} s, online {gates['online']:.1f} s); the "
        f"legacy loops rescan every pending flow at every event, so this "
        f"depth is what the phase cuts when it overruns its "
        f"{ORACLE_BUDGET_S:.0f} s budget (PERF.md section 5)")

    # ---- 13c. the grid under the oracle ----------------------------------
    t13c = time.perf_counter()
    policies = ("work-conserving", "priority-guard", "reserving")
    small_trace = synth_fb_trace(200, seed=7)
    small = {d: sample_instance(small_trace, N=24, M=60, rates=RATES,
                                delta=DELTA, seed=3, device=d)
             for d in (dev, "cpu")}
    span_s = float(run_fast(small["cpu"], backend="kernel").ccts.max())
    osmall = sample_online_instance(small_trace, N=24, M=60, rates=RATES,
                                    delta=DELTA, span=span_s, seed=3,
                                    device=dev)
    kw = dict(seeds=(3,), schedulings=policies, check="oracle")
    before = dict(ca.launches_by_kernel)
    (host, t_host) = sync_time(lambda: run_batch(
        [small[dev], osmall], ALGORITHMS, backend="numpy", workers=WORKERS,
        **kw))
    mid = dict(ca.launches_by_kernel)
    (kern, t_kern) = sync_time(lambda: run_batch(
        [small[dev], osmall], ("ours", "sunflow-core"), backend="kernel",
        workers=WORKERS, **kw))
    n_host = {k: mid[k] - before[k] for k in ca.KERNELS}
    n_kern = {k: ca.launches_by_kernel[k] - mid[k] for k in ca.KERNELS}
    if n_host != {"chain_sm90": 0, "warp": 0} or n_kern != {
            "chain_sm90": len(kern), "warp": 0}:
        raise AssertionError(f"the oracle grid must launch nothing on the "
                             f"host backend and the chain kernel once per "
                             f"kernel point; counted {n_host}, {n_kern}")
    for backend, tab in (("numpy", host), ("kernel", kern)):
        for r in tab:
            log(f"[13c]   {'online' if r.instance else 'offline':7s} "
                f"{backend:6s} {r.algorithm:12s} {r.scheduling:15s} weighted "
                f"CCT {r.weighted_cct!r}  wall {r.wall_s:.3f} s")
    log(f"[13c] run_batch(check=\"oracle\") on the small instance (N=24, "
        f"M=60, {host.rows[0].n_flows} flows), offline and online: "
        f"{len(host)} fp64 points in {t_host:.1f} s and {len(kern)} kernel "
        f"points in {t_kern:.1f} s (workers={WORKERS}), every point held to "
        f"the oracles and the referee; chain kernel launches {n_kern} (one "
        f"per kernel point, counted in the workers)")
    before = ca.launches_by_kernel["chain_sm90"]
    pts = {dev: cross_check(small[dev], "ours", seed=3, backend="kernel")}
    if ca.launches_by_kernel["chain_sm90"] != before + 1:
        raise AssertionError("the card's point must launch the chain kernel")
    pts["cpu"] = cross_check(small["cpu"], "ours", seed=3, backend="kernel")
    for name in ("pi", "core", "t_establish", "ccts"):
        if not torch.equal(getattr(pts[dev], name).cpu(),
                           getattr(pts["cpu"], name)):
            raise AssertionError(f"13c point: card {name} != CPU {name}")
    oracle = {d: run(small[d], "ours") for d in (dev, "cpu")}
    for name in ("pi", "core", "t_establish", "ccts"):
        if not torch.equal(getattr(oracle[dev], name).cpu(),
                           getattr(oracle["cpu"], name)):
            raise AssertionError(f"13c oracle run: card {name} != CPU {name}")
    for fn in (check_lemma1, check_lemma2, check_theorem1,
               lambda x: check_lemma3(x, strict=False),
               lambda x: check_theorem2(x, strict=False)):
        got, want = fn(oracle[dev]), fn(oracle["cpu"])
        got = {k: v.cpu() if torch.is_tensor(v) else v for k, v in got.items()}
        same = got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) if torch.is_tensor(want[k])
            else got[k] == want[k] for k in want)
        if not same:
            raise AssertionError("13c: a certificate's dict differs between "
                                 "the card and the CPU")
    t13c = time.perf_counter() - t13c
    log(f"[13c] one point (ours, work-conserving, backend=\"kernel\") "
        f"through cross_check and the oracle run(\"ours\") with all five "
        f"certificates: card == CPU in choices, t_establish, CCTs and every "
        f"certificate's dict; 13c took {t13c:.1f} s")
    launches = dict(ca.launches_by_kernel)
    t13 = time.perf_counter() - t13
    log(f"[13] phase 13 took {t13:.1f} s (13a {t13a:.1f}, 13b {t13b:.1f}, "
        f"13c {t13c:.1f}; budget {ORACLE_BUDGET_S:.0f} s); assignment kernel "
        f"launches {launches}")
    if t13 > ORACLE_BUDGET_S:
        log(f"[13] over the budget: cut M_ORACLE (13b took {t13b:.1f} s)")
    return launches


def visible_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(q, k) pairs of one head the masks leave visible: the work of an
    attention that skips what it masks."""
    qp = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros_like(qp)
    hi = np.minimum(qp, Sk - 1) if causal else np.full_like(qp, Sk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def family_phases(torch, dev):
    """Phase 14: the other model families at full width, one at a time.
    Returns the flash kernels' launches over the prefills and decodes, by
    kernel, and the kernel table's rows at the new shapes."""
    import gc

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.api import build_model, model_class
    from repro_torch.models.common import (layer_norm, param_count, rms_norm,
                                           tree_bytes)
    from repro_torch.serve.engine import build_decode, build_prefill

    t14 = time.perf_counter()
    launches = dict.fromkeys(fa.KERNELS, 0)
    rows = []

    def time_shape(label, q, k, v, causal, window):
        """The sm90 kernel against its plain version at one shape of the
        main path, and its, the plain version's and SDPA's times there."""
        err = fa_vs_plain(f"{label} {tuple(q.shape)} / {tuple(k.shape)}",
                          q, k, v, causal, window, phase=14)
        ms, reps = steady_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, window=window))
        plain_ms = event_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        Sq, Sk = q.shape[1], k.shape[1]
        mask = None
        if window:  # SDPA takes a window only as an explicit mask
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Sk, device=dev)[None, :]
            mask = (kp > qp - window) & ((kp <= qp) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        backend = "none"
        for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                   SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([be]):
                    sdpa()
                backend = be.name
                break
            except RuntimeError:
                continue
        sdpa_ms, sdpa_reps = steady_ms(sdpa)
        B, _, H, Dh = q.shape
        flops = 4.0 * Dh * B * H * visible_pairs(Sq, Sk, causal, window)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops_s, bytes_s = flops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(ops_s, bytes_s)
        bound_by = "operations" if ops_s >= bytes_s else "bytes"
        log(f"[14] {label}: kernel {ms:.4f} ms (CUDA events over {reps} "
            f"launches after a warm one, {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound_ms / ms:.1%} of its bound, {ms / sdpa_ms:.2f}x SDPA); "
            f"plain version {plain_ms:.3f} ms; SDPA {sdpa_ms:.4f} ms (over "
            f"{sdpa_reps} calls; backend: "
            f"{backend}, the first of flash, efficient, cudnn, math that "
            f"takes the call{'; an explicit boolean mask' if window else ''});"
            f" bound {bound_ms:.4f} ms ({bound_by}: {flops:.4e} FLOP of "
            f"{visible_pairs(Sq, Sk, causal, window):,} visible pairs a head "
            f"at 989 TFLOP/s, {n_bytes:,} B at 3.35 TB/s)")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": sdpa_ms,
                "max_abs_err": err}

    def layer0_checks(model, cfg, batch):
        """The sm90 kernel against its plain version at every shape this
        model's prefill gives it, on its first attention layer's q/k/v; the
        kernel table's rows, timed, at RecurrentGemma's and Seamless's."""
        with torch.inference_mode():
            tokens = batch["tokens"]
            T = tokens.shape[1]
            if cfg.family in ("dense", "moe", "vlm"):
                q, k, v = dense_layer0_qkv(model, tokens,
                                           batch.get("prefix_embeds"))
                fa_vs_plain(f"{cfg.name}: layer 0's q/k/v {tuple(q.shape)} / "
                            f"{tuple(k.shape)} (causal)", q, k, v, True,
                            cfg.window or None, phase=14)
                return {}
            if cfg.family == "hybrid":
                slot = model.pattern.index("attn")
                lp = model._layer(f"slot{slot}", 0)
                pos = torch.arange(T, device=dev).expand(FAMILY_B, T)
                q, k, v = model._qkv(rms_norm(model._embed(tokens),
                                              lp["ln"]), lp, pos)
                return {"recurrentgemma-9b prefill": time_shape(
                    "first attention layer's q/k/v (Dh=256, causal, window "
                    f"{cfg.window})", q, k, v, True, cfg.window)}
            if cfg.family != "audio":
                return {}
            lp = model._lp("enc", 0)
            src = batch["src_frames"].to(cfg.dtype)
            q, k, v = model._qkv(layer_norm(src, lp["sa_ln"], lp["sa_lnb"]),
                                 lp["sa_wq"], lp["sa_wk"], lp["sa_wv"])
            enc = time_shape("encoder layer 0's self-attention (non-causal)",
                             q, k, v, False, None)
            enc_out = model.encode(batch["src_frames"])
            lp = model._lp("dec", 0)
            h = model._embed(tokens)
            pos = torch.arange(T, device=dev).expand(FAMILY_B, T)
            q, k, v = model._self_qkv(h, lp, pos)
            fa_vs_plain(f"decoder layer 0's self-attention {tuple(q.shape)} "
                        f"(causal)", q, k, v, True, None, phase=14)
            h = layer_norm(h, lp["ca_ln"], lp["ca_lnb"])
            qc = model._heads(h @ lp["ca_wq"], cfg.n_heads)
            kc, vc = model._cross_kv(enc_out, lp)
            cross = time_shape("decoder layer 0's cross-attention (Sq != Sk, "
                               "non-causal)", qc, kc, vc, False, None)
            return {"seamless-m4t-large-v2 prefill; cross-attention, Sq=128, "
                    "Sk=2,048": cross, "seamless-m4t-large-v2 prefill; "
                    "encoder, S=2,048": enc}

    def run_one(arch, depth, S, want_launches):
        """One configuration: its rows of the kernel table, if any."""
        spec = get_arch(arch)
        cfg = dataclasses.replace(spec.config, attention_impl="pallas",
                                  **({"n_layers": depth} if depth else {}))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_arch = time.perf_counter()
        model, t_build = sync_time(lambda: build_model(
            cfg, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0)))
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab, (FAMILY_B, S),
                                         device=dev, generator=gen)}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.randn(
                (FAMILY_B, cfg.n_prefix_tokens, cfg.d_model), device=dev,
                generator=gen).to(cfg.dtype)
        if cfg.family == "audio":
            batch["src_frames"] = torch.randn(
                (FAMILY_B, FAMILY_SRC, cfg.d_model), device=dev,
                generator=gen).to(cfg.dtype)
        cut = (f"{cfg.n_layers} of {spec.config.n_layers} layers" if depth
               else f"all {cfg.n_layers} layers"
               + (f" ({cfg.enc_layers} + {cfg.dec_layers})"
                  if cfg.family == "audio" else ""))
        log(f"[14] {arch} ({cfg.family}): {cut}, d_model {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, vocab "
            f"{cfg.vocab}, {cfg.dtype}; {param_count(model):,} weights "
            f"({tree_bytes(model) / 2**30:.2f} GiB) drawn on the card in "
            f"{t_build:.2f} s; B={FAMILY_B} x {S} tokens"
            + (f" after {cfg.n_prefix_tokens} prefix embeddings"
               if cfg.n_prefix_tokens else "")
            + (f", {FAMILY_SRC} source frames" if cfg.family == "audio"
               else ""))
        shapes = layer0_checks(model, cfg, batch)

        # the main path: one prefill, 16 greedy decode steps
        prefill, decode = build_prefill(model), build_decode(model)
        s_max = S + cfg.n_prefix_tokens + SERVE_STEPS
        kw = {"s_src": FAMILY_SRC} if cfg.family == "audio" else {}
        cache = model.make_caches(FAMILY_B, s_max, **kw)
        fa.launches = 0
        fa.launches_by_kernel = dict.fromkeys(fa.KERNELS, 0)
        (logits, cache), t_prefill = sync_time(lambda: prefill(cache, batch))
        pre = dict(fa.launches_by_kernel)
        steps, step_s, seq = [logits], [], batch["tokens"]
        for _ in range(SERVE_STEPS):
            nxt = steps[-1][:, -1].argmax(-1)[:, None]
            seq = torch.cat([seq, nxt], dim=1)
            (logits, cache), t_step = sync_time(lambda: decode(cache, nxt))
            steps.append(logits)
            step_s.append(t_step)
        served = dict(fa.launches_by_kernel)
        for name in launches:
            launches[name] += served[name]
        peak = torch.cuda.max_memory_allocated()
        log(f"[14] {arch}: prefill {t_prefill:.3f} s, flash kernel launches "
            f"{pre}; {SERVE_STEPS} greedy decode steps "
            f"{', '.join(f'{1e3 * t:.1f}' for t in step_s)} ms, "
            f"{1e3 * sum(step_s) / SERVE_STEPS:.2f} ms a step; launches over "
            f"prefill + decode {served}; peak max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
        want = {"sm90_bf16": want_launches, "simt_fp32": 0}
        if pre != want or served != want:
            raise AssertionError(f"{arch}: the prefill must launch the sm90 "
                                 f"kernel once per attention layer "
                                 f"({want_launches}) and the SIMT kernel "
                                 f"never, and decode neither; counted {pre} "
                                 f"and {served}")
        if not all(bool(torch.isfinite(lg).all()) for lg in steps) or \
                logits.shape != (FAMILY_B, 1, cfg.vocab):
            raise AssertionError(f"{arch}: serving logits must be finite, "
                                 f"(B, 1, vocab)")
        if int(cache.length.min()) != S + cfg.n_prefix_tokens + SERVE_STEPS:
            raise AssertionError(f"{arch}: the cache must count prompt + "
                                 f"decoded tokens")

        # Agreement. bf16 rounding alone moves some of these models' logits
        # by more than 6e-2 at full width, the reference's as the port's
        # (tests/test_torch_families.py::test_bf16_*_is_the_references). So
        # (a) the bf16 main path against the bf16 reference path is
        # printed; (b) 6e-2 is held in fp32, on the same weights widened
        # (exact), prompts 0-1 and the bf16 run's tokens; (c) the bf16 main
        # path is held to (b)'s fp32 serving run: its distance from it at
        # most twice the bf16 "xla" path's plus 1e-2, the rule by which the
        # CPU tests hold the port's bf16 gap to the reference's. An MoE
        # model in fp32 would not fit the card at its serving depth, so its
        # (b) and (c) run the first half of its layers, prefill only.
        def compare(what, got, ref):
            err = float((got - ref).abs().max())
            bad = int((~torch.isclose(got, ref, atol=SERVE_TOL,
                                      rtol=SERVE_TOL)).sum())
            log(f"[14] {arch}: {what}: max|diff| {err:.4f}, {bad} of "
                f"{ref.numel():,} outside atol=rtol={SERVE_TOL}; logits "
                f"|max| {float(ref.abs().max()):.3f}")
            return bad

        moe = cfg.family == "moe"
        keep = cfg.n_layers // 2 if moe else cfg.n_layers
        b2 = {k: v[:2] for k, v in batch.items()}

        def serve2(m):
            """Last logits of prompts 0-1 through ``m``'s serving path: the
            prefill, then (but for MoE) the bf16 run's decoded tokens."""
            c = m.make_caches(2, s_max, **kw)
            lg, c = m.prefill(c, b2)
            for t in range(0 if moe else SERVE_STEPS):
                lg, c = m.decode_step(c, seq[:2, S + t:S + t + 1])
            return lg[:, -1].float()

        state = dict(model.state_dict())
        xla_cfg = dataclasses.replace(cfg, attention_impl="xla")
        if moe:
            xla = model_class("moe").from_state(xla_cfg, state)
            with torch.inference_mode():
                ref, _ = xla.prefill(xla.make_caches(FAMILY_B, s_max), batch)
            compare("bf16 prefill logits under \"pallas\" vs \"xla\" on the "
                    "same weights and prompts (measured)",
                    steps[0][:, -1].float(), ref[:, -1].float())
            del xla, ref
            half = {name: t[:keep] if name.startswith("blocks.") else t
                    for name, t in state.items()}
            cut = dataclasses.replace(cfg, n_layers=keep)
            bf16_main = serve2(model_class("moe").from_state(cut, half))
            bf16_xla = serve2(model_class("moe").from_state(
                dataclasses.replace(cut, attention_impl="xla"), half))
            del half
        else:
            full = model._forward_train({**batch, "tokens": seq}, last=True)
            compare(f"bf16 last decode logits vs bf16 _forward_train on all "
                    f"{seq.shape[1]} tokens (last position; measured)",
                    logits[:, -1].float(), full[:, -1, :cfg.vocab].float())
            del full
            bf16_main = logits[:2, -1].float()
            bf16_xla = serve2(model_class(cfg.family).from_state(xla_cfg,
                                                                 state))
        del model, prefill, decode, cache, steps, logits
        state = {name: (state.pop(name)[:keep] if moe and name.startswith(
            "blocks.") else state.pop(name)).float() for name in list(state)}
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32, n_layers=keep)
        m32 = model_class(cfg.family).from_state(cfg32, state)
        lg32 = serve2(m32)
        if moe:
            x32 = model_class("moe").from_state(
                dataclasses.replace(cfg32, attention_impl="xla"), state)
            what = (f"fp32 prefill logits under \"pallas\" vs \"xla\" ({keep} "
                    f"of the {cfg.n_layers} layers widened, prompts 0-1)")
            bad = compare(what, lg32, serve2(x32))
            del x32
        else:
            full = m32._forward_train({**b2, "tokens": seq[:2]}, last=True)
            what = (f"fp32 last decode logits vs fp32 _forward_train on all "
                    f"{seq.shape[1]} tokens (last position; the same weights "
                    f"widened, prompts 0-1, the bf16 run's tokens)")
            bad = compare(what, lg32, full[:, -1, :cfg.vocab].float())
            del full
        del m32, state
        e_main = float((bf16_main - lg32).abs().max())
        e_xla = float((bf16_xla - lg32).abs().max())
        limit = 2 * e_xla + 1e-2
        log(f"[14] {arch}: bf16 vs the fp32 serving run ("
            + (f"prefill, {keep} layers" if moe else "last decode logits")
            + f", prompts 0-1): max|diff| {e_main:.4f} on the main path "
            f"(\"pallas\"), {e_xla:.4f} on \"xla\"; held to 2 x {e_xla:.4f} "
            f"+ 0.01 = {limit:.4f}")
        log(f"[14] {arch}: {time.perf_counter() - t_arch:.1f} s for this "
            f"configuration")
        if bad:
            raise AssertionError(f"{arch}: {what} disagree")
        if e_main > limit:
            raise AssertionError(f"{arch}: the bf16 main path is {e_main:.4f} "
                                 f"from the fp32 run, more than {limit:.4f}")
        # the new shapes' rows; launches: the sm90 kernel's in the prefill
        return [{"name": f"flash_attention ({name})", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/"
                           "flash_attention_sm90.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:32",
                 "launches": pre["sm90_bf16"], **row}
                for name, row in shapes.items() if "encoder" not in name]

    for arch, depth, S, want_launches in FAMILY_RUNS:
        rows += run_one(arch, depth, S, want_launches)
        gc.collect()
        torch.cuda.empty_cache()
    t14 = time.perf_counter() - t14
    log(f"[14] phase 14 took {t14:.1f} s (budget {FAMILY_BUDGET_S:.0f} s); "
        f"flash kernel launches over the prefills and decodes {launches}")
    if t14 > FAMILY_BUDGET_S:
        log(f"[14] over the budget: qwen3-moe's depth is the first cut")
    return launches, rows


def _grad_gap(torch, got: dict, want: dict) -> tuple[float, str]:
    """The largest |got - want| / max|want| over the leaves, and its leaf."""
    worst, where = 0.0, ""
    for k, w in want.items():
        scale = float(w.abs().max()) or 1.0
        gap = float((got[k].to(w.device) - w).abs().max()) / scale
        if gap > worst:
            worst, where = gap, k
    return worst, where


def train_phases(torch, dev):
    """Phase 15: training on the card. Returns the flash kernels' launches
    in 15(c)'s serving, by kernel."""
    import gc
    import shutil

    from repro_torch.analysis import hw
    from repro_torch.analysis.roofline import count_params, model_flops
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data.pipeline import PackedLoader, SyntheticCorpus
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import train_loop
    from repro_torch.models.api import build_model, model_class
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import build_train_step, loss_and_grads

    t15 = time.perf_counter()
    full = dataclasses.replace(get_arch("tinyllama-1.1b").config,
                               attention_impl="chunked")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 15a. TinyLlama-1.1B at full width and depth -------------------
    n_params = count_params(full)[0]
    B, cut = TRAIN_B, "none"
    for attempt in (dict(), dict(remat_policy="full"),
                    dict(remat_policy="full", half=True)):
        cfg = dataclasses.replace(
            full, **{k: v for k, v in attempt.items() if k != "half"})
        B = TRAIN_B // 2 if attempt.get("half") else TRAIN_B
        free()
        torch.cuda.reset_peak_memory_stats()
        try:
            run = train_loop(cfg, steps=TRAIN_STEPS, global_batch=B,
                             seq_len=TRAIN_S, microbatches=TRAIN_MB,
                             opt_cfg=OptimizerConfig(
                                 lr=1e-3, warmup_steps=1,
                                 total_steps=TRAIN_STEPS),
                             log_every=0, device=dev, seed=0)
            break
        except torch.cuda.OutOfMemoryError as exc:
            cut = f"{attempt}: {str(exc).splitlines()[0]}"
            log(f"[15a] out of memory with {attempt or 'no remat'} at B={B}; "
                f"trying the next fallback")
            run = None
    else:
        raise AssertionError("TinyLlama-1.1B does not train on this card even "
                             "with full remat at half the batch")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = model_flops(cfg, ShapeSpec("train", "train", TRAIN_S, B))
    log(f"[15a] TinyLlama-1.1B at full width and depth ({cfg.n_layers} "
        f"layers, d={cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"kv, d_ff={cfg.d_ff}, V={cfg.vocab}; {n_params:,.0f} parameters), "
        f"bf16, attention_impl=\"chunked\", remat {cfg.remat_policy}, "
        f"B={B} x S={TRAIN_S} in {TRAIN_MB} microbatches, AdamW lr 1e-3, "
        f"{TRAIN_STEPS} steps of train_loop (fallback taken: {cut}); "
        f"model_flops {flops:.4e} a step")
    for i, (h, dt) in enumerate(zip(run.history, run.step_s)):
        rate = flops / dt
        log(f"[15a]   step {i + 1}: {dt:.3f} s, {B * TRAIN_S / dt:,.0f} "
            f"tokens/s, {rate / 1e12:.1f} TFLOP/s = "
            f"{rate / hw.PEAK_FLOPS_BF16:.2%} of the {hw.PEAK_FLOPS_BF16 / 1e12:.0f} "
            f"TFLOP/s bf16 peak; loss {h['loss']!r}, grad norm "
            f"{h['grad_norm']!r}, lr {h['lr']!r}")
    steady = sorted(run.step_s[1:])[len(run.step_s[1:]) // 2]
    log(f"[15a] median step after the first {steady:.3f} s "
        f"({flops / steady / hw.PEAK_FLOPS_BF16:.2%} of peak); peak "
        f"max_memory_allocated {peak:.2f} GiB; stragglers {run.stragglers}")
    losses = [h["loss"] for h in run.history]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"15a: the loss must be finite and fall: "
                             f"{losses}")
    # one more step under the profiler: where the device time goes
    step_fn = build_train_step(run.model, OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MB)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in PackedLoader(
        SyntheticCorpus(cfg.vocab, seed=0), global_batch=B,
        seq_len=TRAIN_S)._make_batch(TRAIN_STEPS).items()}
    wall_ms, kinds, top = device_time_by_kind(
        torch, lambda: step_fn(run.params, run.opt_state, batch))
    busy = sum(kinds.values())
    log(f"[15a] one more step under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.3f}): "
        f"matrix products {kinds['matmul']:.1f} ms, other "
        f"{kinds['other']:.1f} ms")
    for name, ms, calls in top:
        log(f"[15a]   {ms:9.1f} ms  {calls:6d} calls  {name}")
    del run, step_fn, batch
    free()

    # ---- 15b. card against host, fp32 two-layer cut ---------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    cut2 = dataclasses.replace(full, n_layers=2, dtype=torch.float32)
    host = build_model(cut2, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    state = {k: p.detach() for k, p in host.named_parameters()}
    arrays = PackedLoader(SyntheticCorpus(cut2.vocab, seed=0),
                          global_batch=1, seq_len=TRAIN_S)._make_batch(0)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    cls = model_class(cut2.family)
    card = cls.from_state(cut2, {k: v.to(dev) for k, v in state.items()})
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    def grads(model, batch):
        loss, g = loss_and_grads(model, lambda: model.loss(batch))
        return float(loss), g

    (loss_c, g_c), t_card = sync_time(lambda: grads(card, dbatch))
    t0 = time.perf_counter()
    loss_h, g_h = grads(host, batch)
    t_host = time.perf_counter() - t0
    xla = cls.from_state(dataclasses.replace(cut2, attention_impl="xla"),
                         {k: v.to(dev) for k, v in state.items()})
    loss_x, g_x = grads(xla, dbatch)
    gap_h, where_h = _grad_gap(torch, g_c, g_h)
    gap_x, where_x = _grad_gap(torch, g_c, g_x)
    rel_h, rel_x = abs(loss_c - loss_h) / abs(loss_h), \
        abs(loss_c - loss_x) / abs(loss_x)
    log(f"[15b] fp32 two-layer cut at full width, B=1 x S={TRAIN_S} "
        f"(\"chunked\" engages): loss card {loss_c!r}, host {loss_h!r} "
        f"(relative {rel_h:.2e}), card \"xla\" {loss_x!r} ({rel_x:.2e}); "
        f"largest gradient gap / max|g|: card vs host {gap_h:.2e} "
        f"({where_h}), chunked vs xla {gap_x:.2e} ({where_x}); backward "
        f"{t_card:.3f} s on the card, {t_host:.3f} s on the host")
    if rel_h > 1e-5 or rel_x > 1e-5 or gap_h > 1e-4 or gap_x > 1e-4:
        raise AssertionError("15b: the card's loss or gradients leave the "
                             "host's or the xla path's (1e-5 / 1e-4)")
    del host, card, xla, g_c, g_h, g_x, state
    free()

    # ---- 15c. train, checkpoint, resume, serve -------------------------
    mid = dataclasses.replace(full, name="tinyllama-mid", d_model=512,
                              n_heads=8, n_kv_heads=4, d_ff=1408,
                              n_layers=4)
    ckpt_dir = ROOT / "chiprun_out" / "phase15_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(global_batch=TRAIN_B, seq_len=TRAIN_S, ckpt_dir=str(ckpt_dir),
              ckpt_every=8, log_every=0, device=dev)
    run = train_loop(mid, steps=MID_STEPS, opt_cfg=OptimizerConfig(
        lr=1e-3, total_steps=MID_STEPS, warmup_steps=2), **kw)
    first = float(np.mean([h["loss"] for h in run.history[:6]]))
    last = float(np.mean([h["loss"] for h in run.history[-6:]]))
    run2 = train_loop(mid, steps=MID_RESUME, opt_cfg=OptimizerConfig(
        lr=1e-3, total_steps=MID_RESUME, warmup_steps=2), **kw)
    resumed = float(np.mean([h["loss"] for h in run2.history[:3]]))
    saved = sorted(p.name for p in ckpt_dir.iterdir())
    log(f"[15c] mid size (d=512, 8 heads, 4 layers, V=32,000, B={TRAIN_B} x "
        f"{TRAIN_S}): {MID_STEPS} steps, mean loss of the first 6 {first!r}, "
        f"last 6 {last!r}; resumed from step {MID_STEPS} to {MID_RESUME}: "
        f"first 3 {resumed!r}; checkpoints kept {saved}; step "
        f"{np.median(run.step_s):.3f} s (median)")
    if not (last < first and resumed < first and run2.steps_done ==
            MID_RESUME and len(run2.history) == MID_RESUME - MID_STEPS):
        raise AssertionError("15c: train -> checkpoint -> resume failed")
    served_cfg = dataclasses.replace(mid, attention_impl="pallas")
    served = model_class(mid.family).from_state(
        served_cfg, {k: v.to(served_cfg.dtype) for k, v in
                     run2.params.items()})
    prompts = torch.from_numpy(PackedLoader(
        SyntheticCorpus(mid.vocab, seed=1), global_batch=2,
        seq_len=TRAIN_S)._make_batch(0)["tokens"]).to(dev)
    fa.launches = 0
    fa.launches_by_kernel = dict.fromkeys(fa.KERNELS, 0)
    cache = served.make_caches(2, TRAIN_S + 4)
    logits, cache = served.prefill(cache, {"tokens": prompts})
    prefill_launches = dict(fa.launches_by_kernel)
    outs, seq = [logits], prompts
    for _ in range(4):
        tok = outs[-1][:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = served.decode_step(cache, tok)
        outs.append(logits)
    torch.cuda.synchronize()
    launches = dict(fa.launches_by_kernel)
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    log(f"[15c] served the trained weights (attention_impl=\"pallas\"): "
        f"prefill of 2 x {TRAIN_S} tokens, flash launches {prefill_launches} "
        f"(one sm90 launch per layer), then 4 decode steps "
        f"(launches {launches}), logits finite {finite}, shape "
        f"{tuple(outs[-1].shape)}")
    if prefill_launches != {"sm90_bf16": mid.n_layers, "simt_fp32": 0} or \
            launches != prefill_launches or not finite or \
            tuple(outs[-1].shape) != (2, 1, mid.vocab):
        raise AssertionError("15c: serving the trained model failed")
    # the kernel at this prefill's shape, and the served logits against
    # the model's forward pass over the same tokens (as phase 8)
    q, k, v = dense_layer0_qkv(served, prompts)
    fa_vs_plain(f"the served model's layer-0 q/k/v {tuple(q.shape)} / "
                f"{tuple(k.shape)} (causal)", q, k, v, True,
                mid.window or None, phase="15c")
    full_logits = served._forward_train({"tokens": seq}, last=True)
    got, ref = logits[:, -1].float(), full_logits[:, -1, :mid.vocab].float()
    err = float((got - ref).abs().max())
    bad = int((~torch.isclose(got, ref, atol=SERVE_TOL,
                              rtol=SERVE_TOL)).sum())
    log(f"[15c] last decode logits vs _forward_train on all {seq.shape[1]} "
        f"tokens: max|diff| {err:.4f}, {bad} of {ref.numel():,} outside "
        f"atol=rtol={SERVE_TOL}; logits |max| {float(ref.abs().max()):.3f}")
    if bad:
        raise AssertionError("15c: the served model's decode logits differ "
                             "from its forward pass")
    del run, run2, served, cache, q, k, v, full_logits
    shutil.rmtree(ckpt_dir, ignore_errors=True)  # 3 x 0.6 GB
    free()
    t15 = time.perf_counter() - t15
    log(f"[15] phase 15 took {t15:.1f} s (budget {TRAIN_BUDGET_S:.0f} s)")
    if t15 > TRAIN_BUDGET_S:
        log("[15] over the budget: 15a's steps are the first cut")
    return launches


def device_time_by_kind(torch, fn):
    """Run ``fn`` under ``torch.profiler``; (wall ms, {kind: device ms},
    [(kernel, device ms, calls)] top 8). Kinds: the flash kernel, matrix
    products (cuBLAS's nvjet, GEMM and GEMV kernels), everything else."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us or getattr(ev, "device_type", None) is not None and \
                "CUDA" not in str(ev.device_type):
            continue
        name = ev.key
        low = name.lower()
        if "flash_attention_kernel" in name:
            kind = "flash_attention"
        elif any(w in low for w in ("nvjet", "gemm", "gemv", "cutlass",
                                    "xmma", "sm90_", "splitk")):
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += us / 1e3
        rows.append((name[:70], us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, kinds, rows[:8]


def serve_phases(torch, dev, built):
    """Phases 6-8: the flash-attention kernels and the serving path; the
    kernel table's rows of the sm90 and the SIMT kernel."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.hazards import FLASH_SHAPES
    from repro_torch.models.common import param_count
    from repro_torch.models.dense import DenseLM
    from repro_torch.serve.engine import build_decode, build_prefill

    # ---- 6. build -------------------------------------------------------
    for name in ("flash_attention_sm90", "flash_attention"):
        log(f"[6] built {name}.cu in {built(name):.2f} s "
            f"({' '.join(_build.nvcc_flags(name))})")
        for line in _build.build_log(name).splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[6]   {line.strip()}")
    lib = _build.load("flash_attention_sm90")
    smem, block_k = (lib.flash_attention_sm90_smem_bytes,
                     lib.flash_attention_sm90_block_k)
    for fn in (smem, block_k):
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    log("[6] flash_attention_sm90.cu dynamic shared memory per CTA (not in "
        "ptxas' lines) and kv tile rows: " + ", ".join(
            f"{smem(dh):,} B and {block_k(dh)} rows at Dh={dh}"
            for dh in fa.HEAD_DIMS))

    # ---- 7. kernel vs plain version on the card ------------------------
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    def qkv(B, S, H, KVH, Dh, dtype):
        rng = np.random.default_rng(S * H + Dh)
        return (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev).to(dtype)
            for shape in ((B, S, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh)))

    for B, S, H, KVH, Dh, causal, window, dt in FA_CASES:
        fa_vs_plain(f"case {(B, S, H, KVH, Dh, causal, window, dt)}",
                    *qkv(B, S, H, KVH, Dh, dtypes[dt]), causal, window)
    edge_err = max(fa_vs_plain(f"edge {case}", *qkv(*case[:5], torch.bfloat16),
                               *case[5:], quiet=True) for case in FA_EDGES)
    log(f"[7] {len(FA_EDGES)} edge cases of the sm90 kernel (S in 1..2064 "
        f"around its 128-row tiles, Dh 64/128, windows 1/70/128/300/none, "
        f"non-causal, GQA groups 1/2/8): max|kernel - plain| {edge_err:.3e}, "
        f"all within 2e-2")
    log("[7] block shapes: the kernels' tiles are fixed (128 rows bf16, 64 "
        "fp32; S need not divide), so there is no block size to vary")

    def qkv2(B, Sq, Sk, H, KVH, Dh, dtype, seed):
        rng = np.random.default_rng(seed)
        return (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev).to(dtype)
            for shape in ((B, Sq, H, Dh), (B, Sk, KVH, Dh), (B, Sk, KVH, Dh)))

    for dt in (torch.bfloat16, torch.float32):
        new_err = max(fa_vs_plain(
            f"new shape {case}", *qkv2(*case[:6], dt, seed=i), *case[6:],
            quiet=True) for i, case in enumerate(FLASH_SHAPES))
        log(f"[7] {len(FLASH_SHAPES)} cases at the other families' shapes in {dt} "
            f"({fa.kernel_for(dt)}: Dh=256 with S in 1..700 around the 64-row "
            f"kv tiles and windows none/1/300/2048; Sq != Sk both ways, causal "
            f"and not, Dh 64/128/256): max|kernel - plain| {new_err:.3e}, all "
            f"within {2e-2 if dt == torch.bfloat16 else 1e-5:g}")

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").config,
                              attention_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    model, t_build = sync_time(lambda: DenseLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    prompts = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    log(f"[7] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, {cfg.dtype}; {param_count(model):,} weights "
        f"drawn on the card in {t_build:.2f} s")
    with torch.inference_mode():
        q, k, v = dense_layer0_qkv(model, prompts)
        fa_vs_plain(f"layer-0 q/k/v of the prefill {tuple(q.shape)} / "
                    f"{tuple(k.shape)}", q, k, v, True, None)
        times = {}
        for label, x in (("bf16", (q, k, v)),
                         ("fp32", tuple(t.float() for t in (q, k, v)))):
            reps = 5
            fa.flash_attention_cuda(*x)  # warm
            ms = event_ms(lambda: fa.flash_attention_cuda(*x), reps)
            plain_ms = event_ms(lambda: fa.flash_attention_plain(*x), 2)
            xt = tuple(t.transpose(1, 2) for t in x)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *xt, is_causal=True, enable_gqa=True)
            sdpa()
            sdpa_ms = event_ms(sdpa, reps)
            times[label] = (ms, plain_ms, sdpa_ms, x[0].element_size())
    B, S, H, Dh = q.shape
    flops = 2.0 * B * H * S * S * Dh  # causal: half of QK^T and of PV
    rows = {}
    for label, peak, kernel in (("bf16", BF16_OPS_PER_S, "sm90_bf16"),
                                ("fp32", FP32_OPS_PER_S, "simt_fp32")):
        ms, plain_ms, sdpa_ms, size = times[label]
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * size
        ops_s, bytes_s = flops / peak, n_bytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(ops_s, bytes_s)
        bound_by = "operations" if ops_s >= bytes_s else "bytes"
        log(f"[7] {kernel} at {(B, S, H, k.shape[2], Dh)} {label} causal: "
            f"kernel {ms:.3f} ms (CUDA events, {reps} launches after a warm "
            f"one, {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of its "
            f"bound, {ms / sdpa_ms:.2f}x SDPA); plain version {plain_ms:.3f} "
            f"ms; SDPA {sdpa_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.4e} FLOP at {peak / 1e12:.0f} TFLOP/s, {n_bytes:,} B at "
            f"3.35 TB/s)")
        rows[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": sdpa_ms,
                        "max_abs_err": FA_MAX_ERR[kernel]}

    # ---- 8. serving at full width ---------------------------------------
    prefill, decode = build_prefill(model), build_decode(model)
    s_max = SERVE_S + SERVE_STEPS
    cache = model.make_caches(SERVE_B, s_max)
    fa.launches = 0
    fa.launches_by_kernel = dict.fromkeys(fa.KERNELS, 0)
    (logits, cache), t_prefill = sync_time(
        lambda: prefill(cache, {"tokens": prompts}))
    prefill_launches = dict(fa.launches_by_kernel)
    steps = [logits]
    seq = prompts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        nxt = steps[-1][:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = decode(cache, nxt)
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    serve_launches = dict(fa.launches_by_kernel)
    log(f"[8] prefill B={SERVE_B} x S={SERVE_S}: {t_prefill:.3f} s, flash "
        f"kernel launches {prefill_launches}; {SERVE_STEPS} greedy "
        f"decode steps: {1e3 * t_decode / SERVE_STEPS:.2f} ms per step "
        f"({1e3 * t_decode / SERVE_STEPS / SERVE_B:.3f} ms per token of the "
        f"batch); launches over prefill + decode: {serve_launches}")
    want = {"sm90_bf16": cfg.n_layers, "simt_fp32": 0}
    if prefill_launches != want or serve_launches != want \
            or fa.launches != cfg.n_layers:
        raise AssertionError(f"the prefill must launch the sm90 kernel once "
                             f"per layer ({cfg.n_layers}) and the SIMT kernel "
                             f"never, and the decode neither; counted "
                             f"{prefill_launches} and {serve_launches}")
    if not all(bool(torch.isfinite(lg).all()) for lg in steps) or \
            logits.shape != (SERVE_B, 1, cfg.vocab):
        raise AssertionError("serving logits must be finite, (B, 1, V)")
    if int(cache.length.min()) != s_max or seq.shape != (SERVE_B, s_max):
        raise AssertionError("the cache must hold prompt + decoded tokens")
    full, t_full = sync_time(lambda: model._forward_train({"tokens": seq}))
    last, ref = logits[:, -1].float(), full[:, -1].float()
    err = float((last - ref).abs().max())
    bad = int((~torch.isclose(last, ref, atol=SERVE_TOL, rtol=SERVE_TOL)).sum())
    log(f"[8] last decode logits vs _forward_train on all {s_max} tokens "
        f"({t_full:.3f} s): max|diff| {err:.4f}, {bad} outside "
        f"atol=rtol={SERVE_TOL}; logits |max| {float(ref.abs().max()):.3f}")
    if bad:
        raise AssertionError("decode logits differ from the forward pass")
    peak = torch.cuda.max_memory_allocated()
    log(f"[8] peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")

    # where the time goes: one more prefill and one decode step, traced
    cache2 = model.make_caches(SERVE_B, s_max)
    _, t_prefill2 = sync_time(lambda: prefill(cache2, {"tokens": prompts}))
    log(f"[8] second prefill (warm): {t_prefill2:.3f} s")
    cache3 = model.make_caches(SERVE_B, s_max)
    for label, fn in (
            ("prefill", lambda: prefill(cache3, {"tokens": prompts})),
            ("decode step", lambda: decode(cache2, seq[:, SERVE_S:SERVE_S + 1]))):
        wall_ms, kinds, top = device_time_by_kind(torch, fn)
        busy = sum(kinds.values())
        if busy == 0:
            log(f"[8] profile {label}: no device time in the trace "
                f"(not measured)")
            continue
        log(f"[8] profile {label}: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms (idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
            + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})"
                        for k, v in kinds.items()))
        for name, kms, calls in top:
            log(f"[8]   {kms:9.3f} ms  {calls:4d}x  {name}")

    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{fa.KERNELS[kernel][0]}.cu",
             "replaces": "src/repro/kernels/flash_attention.py:32",
             "launches": serve_launches[kernel], **rows[kernel]}
            for name, kernel in (("flash_attention", "sm90_bf16"),
                                 ("flash_attention_fp32", "simt_fp32"))
            ]


if __name__ == "__main__":
    sys.exit(main())
