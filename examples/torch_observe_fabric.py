"""Fabric observatory demo on the port: trace a streamed service run, then
inspect it.

  PYTHONPATH=src python examples/torch_observe_fabric.py [OUT_DIR] [--device cpu]

Streams a trace-derived arrival sequence through ``FabricManager`` with a
``repro_torch.obs`` tracer attached (including a mid-stream core failure,
so the ``fault/recover`` span shows up), writes the span trace as JSONL
plus a Perfetto-loadable Chrome trace, and prints the same per-phase wall
breakdown ``python -m repro_torch.obs summarize`` would. The port of
``examples/observe_fabric.py``; the demands live on CUDA unless
``--device cpu``. The last line is a JSON summary: the records and their
schema check, the program of record, every coflow's CCT, and whether
every byte of demand is in the program exactly once.

Inspect interactively afterwards:

  python -m repro_torch.obs summarize OUT_DIR/trace.jsonl
  python -m repro_torch.obs export-chrome OUT_DIR/trace.jsonl -o chrome.json
  # then load chrome.json at https://ui.perfetto.dev
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (CoreDown, arrival_stream, run_fast_online,
                              sample_online_instance, synth_fb_trace)
from repro_torch.obs import Tracer
from repro_torch.obs.cli import summarize, validate_records
from repro_torch.service import FabricConfig, FabricManager
from torch_serve_fabric import bytes_conserved

N, M, TICKS = 16, 60, 10
RATES, DELTA = (10.0, 20.0, 30.0), 8.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", nargs="?", default="obs_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    trace = synth_fb_trace(526, seed=2026)
    offline = sample_online_instance(trace, N=N, M=M, rates=RATES,
                                     delta=DELTA, span=0.0, seed=7,
                                     device=dev)
    makespan = float(run_fast_online(offline, "ours").ccts.max())
    oinst = sample_online_instance(trace, N=N, M=M, rates=RATES, delta=DELTA,
                                   span=makespan, seed=7, device=dev)

    tracer = Tracer(out_dir / "trace.jsonl")
    mgr = FabricManager(FabricConfig(rates=RATES, delta=DELTA, N=N,
                                     validate_every_tick=True), tracer=tracer,
                        device=dev)

    arrivals = list(arrival_stream(oinst))  # in release order
    nxt = 0
    ticks = np.linspace(makespan / TICKS, makespan, TICKS)
    print(f"tracing N={N} M={M} stream over {TICKS} ticks "
          f"-> {out_dir / 'trace.jsonl'}")
    for i, T in enumerate(ticks):
        while nxt < len(arrivals) and arrivals[nxt][1] <= T:
            mgr.submit(*arrivals[nxt])
            nxt += 1
        mgr.tick(float(T))
        if i == TICKS // 2:  # mid-stream churn: a core fails and recovers
            rep = mgr.report_fault(CoreDown(t=float(T), core=1))
            print(f"  t={T:7.1f}  core 1 down: aborted {rep.aborted}, "
                  f"requeued {rep.requeued}")
    mgr.flush()
    tracer.close()

    problems = validate_records(tracer.records)
    if problems or tracer.open_spans:
        raise RuntimeError(f"trace schema: {problems}, {tracer.open_spans} "
                           f"spans left open")

    chrome = out_dir / "chrome_trace.json"
    with open(chrome, "w", encoding="utf-8") as fh:
        json.dump(tracer.to_chrome_trace(), fh)

    summ = summarize(tracer.records)
    print(f"\n{len(tracer.records)} records, schema OK; phase breakdown:")
    for name in sorted(summ["phases"],
                       key=lambda n: -summ["phases"][n]["total_s"]):
        st = summ["phases"][name]
        print(f"  {name:<20} x{int(st['count']):<5} total "
              f"{st['total_s']:.4f}s")
    print(f"events: {summ['events'] or '(none)'}")
    print(f"\nwrote {chrome} — load it at https://ui.perfetto.dev")
    print(f"summary: {json.dumps(mgr.summary(), default=float)[:160]}...")

    program = mgr.program()
    program.validate()
    out = {"device": str(dev), "records": len(tracer.records),
           "phases": {n: int(st["count"]) for n, st in summ["phases"].items()},
           "segments": program.n_segments, "validated": True,
           "bytes_conserved": bytes_conserved(program, arrivals),
           "coflows_finalized": mgr.summary()["coflows_finalized"],
           "ccts": mgr.ccts().tolist()}
    print(json.dumps(out))
    return {**out, "manager": mgr}


if __name__ == "__main__":
    main()
