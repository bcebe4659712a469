"""Quickstart on the port: the paper's scheduler, then the framework.

Part 1 schedules a hand-built multi-coflow instance on a 3-core OCS network
with Algorithm 1 and checks the paper's guarantees. Part 2 trains a tiny
LM for a few steps and serves one batched generation. The port of
``examples/quickstart.py``; it runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The last line is a JSON summary of what the lines above it print.
"""
import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import (
    Coflow, check_lemma1, check_lemma2, check_theorem1,
    instance_from_coflows, run, validate,
)
from repro_torch.launch.train import train_loop
from repro_torch.models.api import model_class
from repro_torch.train.optimizer import OptimizerConfig


def paper(dev: torch.device) -> dict:
    """Part 1: Algorithm 1 and its four baselines on eight coflows."""
    rng = np.random.default_rng(0)
    coflows = []
    for cid in range(8):
        D = rng.exponential(20, (6, 6)) * (rng.random((6, 6)) < 0.4)
        coflows.append(Coflow(cid=cid, demand=D,
                              weight=float(rng.integers(1, 5))))
    inst = instance_from_coflows(coflows, np.array([10., 20., 30.]), 2.0,
                                 device=dev)

    schedule = run(inst, "ours")          # Algorithm 1, all three phases
    validate(schedule)                    # port exclusivity / timing / conservation
    check_lemma1(schedule)                # T_m >= delta + rho_m / R
    check_lemma2(schedule)                # assignment-phase prefix bound
    check_theorem1(schedule)              # 2 M (wmax/wmin) psi bound
    wcct = schedule.total_weighted_cct
    makespan = float(schedule.ccts.max())
    print(f"[paper] weighted CCT = {wcct:.2f}, makespan = {makespan:.2f}")
    ratios = {}
    for alg in ("rho-assign", "rand-assign", "sunflow-core", "rand-sunflow"):
        s = run(inst, alg)
        validate(s)
        ratios[alg] = s.total_weighted_cct / wcct
        print(f"[paper] {alg:13s} normalized wCCT = {ratios[alg]:.2f}x")
    return {"weighted_cct": wcct, "makespan": makespan, "ratios": ratios}


def framework(dev: torch.device) -> dict:
    """Part 2: 30 training steps of TinyLlama's smoke config, then greedy
    decoding of two prompts from the trained weights."""
    cfg = get_arch("tinyllama-1.1b").smoke
    run_out = train_loop(cfg, steps=30, global_batch=4, seq_len=128,
                         opt_cfg=OptimizerConfig(lr=1e-3, total_steps=30,
                                                 warmup_steps=3),
                         log_every=10, device=dev)
    first, last = run_out.history[0]["loss"], run_out.history[-1]["loss"]
    print(f"[framework] loss {first:.3f} -> {last:.3f} over 30 steps")

    model = model_class(cfg.family).from_state(
        cfg, {k: v.to(cfg.dtype) for k, v in run_out.params.items()})
    cache = model.make_caches(2, 64)
    prompt = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    logits, cache = model.prefill(cache, {"tokens": prompt})
    toks = []
    for _ in range(8):
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        toks.append(nxt[:, 0].cpu().numpy())
        logits, cache = model.decode_step(cache, nxt)
    generated = np.stack(toks, 1).tolist()
    print(f"[framework] generated tokens: {generated}")
    return {"loss_first": first, "loss_last": last, "tokens": generated,
            "config": dataclasses.asdict(cfg)["name"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = {"device": str(dev), **paper(dev), **framework(dev)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
