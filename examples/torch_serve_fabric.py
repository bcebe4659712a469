"""Fabric-manager service demo on the port: stream trace-derived coflow
arrivals through the admission queue, schedule them incrementally against
committed circuits, and emit validated per-tick circuit programs.

  PYTHONPATH=src python examples/torch_serve_fabric.py [--device cpu]

The port of ``examples/serve_fabric.py``: the same stream, ticks and
printed lines; the demands live on CUDA unless ``--device cpu``. The
last line is a JSON summary: the program's size and makespan, every
coflow's CCT, and whether every byte of demand is in the program.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import (
    arrival_stream,
    run_fast_online,
    sample_online_instance,
    synth_fb_trace,
)
from repro_torch.service import FabricConfig, FabricManager

N, M, TICKS = 16, 80, 12
RATES, DELTA = (10.0, 20.0, 30.0), 8.0


def bytes_conserved(program, arrivals) -> bool:
    """Every nonzero demand cell of every submitted coflow is one circuit
    segment of ``program``, of exactly its size. A program labels a
    coflow by its admission id, which is its place in the submission order
    under the default admission policy."""
    cells = []
    for gid, (coflow, _) in enumerate(arrivals):
        demand = coflow.demand.cpu().numpy()
        i, j = np.nonzero(demand)
        cells += [(gid, a, b, float(demand[a, b]))
                  for a, b in zip(i.tolist(), j.tolist())]
    got = zip(program.cid.tolist(), program.ingress.tolist(),
              program.egress.tolist(), program.size.tolist())
    return sorted(cells) == sorted(got)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args(argv).device)

    trace = synth_fb_trace(526, seed=2026)
    offline = sample_online_instance(trace, N=N, M=M, rates=RATES,
                                     delta=DELTA, span=0.0, seed=7,
                                     device=dev)
    makespan = float(run_fast_online(offline, "ours").ccts.max())
    oinst = sample_online_instance(trace, N=N, M=M, rates=RATES, delta=DELTA,
                                   span=makespan, seed=7, device=dev)

    mgr = FabricManager(FabricConfig(rates=RATES, delta=DELTA, N=N,
                                     validate_every_tick=True), device=dev)
    arrivals = list(arrival_stream(oinst))
    nxt = 0
    print(f"serving N={N} M={M} stream over {TICKS} ticks "
          f"(arrival span = offline makespan = {makespan:.0f})")
    for T in np.linspace(makespan / TICKS, makespan, TICKS):
        while nxt < len(arrivals) and arrivals[nxt][1] <= T:
            mgr.submit(*arrivals[nxt])
            nxt += 1
        rep = mgr.tick(float(T))
        print(f"  t={rep.t_now:7.1f}  admitted {rep.admitted:3d}  "
              f"committed {rep.committed_flows:5d} circuits  "
              f"finalized {rep.finalized:3d}  backlog {rep.pending_flows:5d}")
    rep = mgr.flush()
    print(f"  flush     committed {rep.committed_flows:5d} circuits  "
          f"finalized {rep.finalized:3d}")

    program = mgr.program()
    program.validate()
    summary = mgr.summary()
    print(f"\nmerged program: {program.n_segments} circuit segments, "
          f"makespan {program.makespan:.1f} (validated)")
    print(f"decision latency p50/p99: "
          f"{summary['decision_latency_p50_s']*1e3:.1f}/"
          f"{summary['decision_latency_p99_s']*1e3:.1f} ms; "
          f"throughput {summary['coflows_per_s']:.0f} coflows/s")
    events = list(program.events())
    print("first switch actions:")
    for ev in events[:6]:
        print(f"  t={ev.t:8.2f} core {ev.core}  {ev.kind:9s} "
              f"{ev.ingress:2d} -> {ev.egress:2d}  (coflow {ev.cid})")
    out = {"device": str(dev), "segments": program.n_segments,
           "makespan": program.makespan, "validated": True,
           "bytes_conserved": bytes_conserved(program, arrivals),
           "coflows_finalized": summary["coflows_finalized"],
           "ccts": mgr.ccts().tolist()}
    print(json.dumps(out))
    return {**out, "manager": mgr}


if __name__ == "__main__":
    main()
