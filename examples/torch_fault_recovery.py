"""Fault-recovery demo on the port: kill an OCS core mid-stream and watch
the fabric manager abort in-flight circuits, re-queue their demand over the
surviving cores, and keep every emitted program referee-valid.

  PYTHONPATH=src python examples/torch_fault_recovery.py [--device cpu]

The port of ``examples/fault_recovery.py``: the control plane's story
(``CoreDown`` mid-stream, ``CoreUp`` three ticks later), with the same
stream, ticks and printed lines; the demands live on CUDA unless
``--device cpu``. The last line is a JSON summary: the program of
record, the abort and re-serve counts, every coflow's CCT, and whether
every byte of demand is in the program exactly once.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import (CoreDown, CoreUp, arrival_stream,
                              run_fast_online, sample_online_instance,
                              synth_fb_trace)
from repro_torch.service import FabricConfig, FabricManager
from torch_serve_fabric import bytes_conserved

N, M, TICKS = 16, 80, 12
RATES, DELTA = (10.0, 20.0, 30.0), 8.0


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
    arrivals = list(arrival_stream(oinst))  # in release order
    ticks = np.linspace(makespan / TICKS, makespan, TICKS)
    fail_tick = TICKS // 2
    nxt = 0
    print(f"serving N={N} M={M} stream over {TICKS} ticks; "
          f"core 2 dies after tick {fail_tick}, returns after tick "
          f"{fail_tick + 3}")
    for i, T in enumerate(ticks):
        while nxt < len(arrivals) and arrivals[nxt][1] <= T:
            mgr.submit(*arrivals[nxt])
            nxt += 1
        rep = mgr.tick(float(T))
        print(f"  t={rep.t_now:7.1f}  admitted {rep.admitted:3d}  "
              f"committed {rep.committed_flows:4d}  "
              f"finalized {rep.finalized:3d}"
              f"  backlog {rep.pending_flows:4d}  cores up "
              f"{mgr.summary()['cores_up']}")
        if i == fail_tick:
            fault = mgr.report_fault(CoreDown(t=float(T) + 1.0, core=2))
            print(f"  !! core 2 DOWN at t={float(T)+1.0:.1f}: "
                  f"{fault.aborted} in-flight circuits aborted, "
                  f"{fault.requeued} flows re-queued, "
                  f"{fault.reassigned_pending} tentative flows reassigned, "
                  f"{len(fault.unfinalized)} final CCTs retracted, "
                  f"{fault.cache_purged} cache entries purged")
            for ev in fault.teardowns[:3]:
                print(f"     teardown core {ev.core}  {ev.ingress:2d} -> "
                      f"{ev.egress:2d}  (coflow {ev.cid})")
        if i == fail_tick + 3:
            mgr.report_fault(CoreUp(t=float(T) + 1.0, core=2))
            print(f"  !! core 2 UP at t={float(T)+1.0:.1f}")
    rep = mgr.flush()
    print(f"  flush     committed {rep.committed_flows:4d}  "
          f"finalized {rep.finalized:3d}")

    program = mgr.program()  # program of record: aborted segments excluded
    program.validate()
    s = mgr.summary()
    print(f"\nprogram of record: {program.n_segments} circuit segments, "
          f"makespan {program.makespan:.1f} (referee-validated)")
    print(f"all {s['coflows_finalized']}/{M} coflows finalized exactly once; "
          f"{s['circuits_aborted']} circuits aborted, "
          f"{s['flows_requeued']} flows re-served after the fault")
    if s["coflows_finalized"] != M:
        raise RuntimeError(f"{s['coflows_finalized']} of {M} coflows "
                           f"finalized")
    out = {"device": str(dev), "segments": program.n_segments,
           "makespan": program.makespan, "validated": True,
           "bytes_conserved": bytes_conserved(program, arrivals),
           "coflows_finalized": s["coflows_finalized"],
           "circuits_aborted": s["circuits_aborted"],
           "flows_requeued": s["flows_requeued"],
           "ccts": mgr.ccts().tolist()}
    print(json.dumps(out))
    return {**out, "manager": mgr}


if __name__ == "__main__":
    main()
