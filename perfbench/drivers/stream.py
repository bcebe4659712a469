"""Streaming traffic: the fabric manager's control loop over an endless
stream of coflows.

Arrivals come from ``gen.fb_trace.arrival_stream`` at the traffic's mean
rate (coflows per stream time unit). Ticks fall every
``traffic["tick_period"]`` stream units and are driven back to back in wall
time: before the tick at stream time T every coflow released by T is
submitted (``FabricManager.submit``), then ``FabricManager.tick(T)`` runs.
Set-up plays the stream up to ``traffic["warm_span"]``, so the window
starts with a backlog in flight; the window starts no tick after
``--seconds``.

``tick_p95_s`` is the 95th percentile (numpy's linear interpolation) of
the wall time of every ``tick`` call of the window, each ending in a
synchronise; ``stream_flows_per_s`` is the circuits all the window's ticks
committed over the window's wall time. A traced run records the program's
own spans (``obs/trace.py``) through a recording tracer.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench import obs as pobs
from perfbench.gen import fb_trace
from perfbench.reference import stream as ref_stream


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core import Coflow
    from repro_torch.service import FabricConfig, FabricManager

    cfg, tr = ctx.config, ctx.traffic
    rates = np.asarray(cfg["rates"], dtype=np.float64)
    delta = float(cfg["delta"])
    N = int(cfg["N"])
    trace = fb_trace.synth_fb_trace(cfg["trace"]["coflows"],
                                    cfg["trace"]["seed"])
    pool = fb_trace.demand_pool(trace, N, ctx.seed)
    ids = fb_trace.nonempty(pool)
    pool_dev = torch.from_numpy(pool).to(ctx.device)
    arrivals = fb_trace.arrival_stream(trace, ids,
                                       fb_trace.flow_counts(pool), ctx.seed,
                                       tr["rate"], tuple(cfg["weights"]),
                                       tr["block"], tr["stride"])
    tracer = pobs.prof_tracer() if ctx.trace else None
    mgr = FabricManager(FabricConfig(N=N, rates=tuple(rates.tolist()),
                                     delta=delta),
                        tracer=tracer, device=ctx.device)
    period = float(tr["tick_period"])
    submitted: list[tuple[int, float, float]] = []  # (coflow, release, w)
    nxt = next(arrivals)
    state = {"k": 0, "nxt": nxt}

    def tick():
        state["k"] += 1
        t_now = state["k"] * period
        c, rel, w = state["nxt"]
        with torch.profiler.record_function("stream.submit"):
            while rel <= t_now:
                g = len(submitted)
                mgr.submit(Coflow(cid=g, demand=pool_dev[c], weight=w), rel)
                submitted.append((c, rel, w))
                c, rel, w = next(arrivals)
        state["nxt"] = (c, rel, w)
        t0 = time.perf_counter()
        rep = mgr.tick(t_now)
        ctx.sync()
        return time.perf_counter() - t0, rep

    while state["k"] * period < tr["warm_span"]:
        tick()
    if tracer is not None:
        tracer.records.clear()
    walls, committed, backlog = [], 0, []
    with ctx.window():
        while time.perf_counter() - ctx.window.t0 < ctx.seconds:
            wall, rep = tick()
            walls.append(wall)
            committed += rep.committed_flows
            backlog.append(rep.pending_flows)
    t_last = state["k"] * period
    ctx.obs["n_units"] = len(walls)
    ctx.obs["counters"].update(tick_wall_s=walls, backlog_flows=backlog)
    if tracer is not None:
        ctx.obs["spans"] = [r for r in tracer.records
                            if r["kind"] == "span"
                            and r["ts"] >= ctx.window.t0]
    prog = mgr.program()
    ans = {"g": prog.cid, "i": prog.ingress, "j": prog.egress,
           "core": prog.core, "size": prog.size, "t_est": prog.t_establish,
           "t_comp": prog.t_complete, "ccts": mgr.ccts()}
    ans = {k: v.cpu().numpy() for k, v in ans.items()}
    del mgr, prog, pool_dev
    torch.cuda.empty_cache()
    cs = np.array([s[0] for s in submitted], dtype=np.int64)
    rel = np.array([s[1] for s in submitted])
    ws = np.array([s[2] for s in submitted])

    def judge() -> dict:
        want = ref_stream.replay(pool[cs], ws, rel, rates, delta, t_last,
                                 tr["precision"])
        return check.combine([check.stream(ans, want, rates, delta, N)])

    half = len(walls) // 2
    note = (f"{len(walls)} ticks to stream time {t_last}, {len(submitted)} "
            f"coflows submitted, {ans['g'].size} circuits committed; backlog "
            f"mean {np.mean(backlog):.0f} max {max(backlog)} flows; mean tick "
            f"wall {np.mean(walls[:half]):.4f} s in the first half of the "
            f"window, {np.mean(walls[half:]):.4f} s in the second")
    return {"metrics": {"tick_p95_s": float(np.percentile(walls, 95)),
                        "stream_flows_per_s": committed / ctx.window.seconds},
            "attempted": len(walls), "failed": 0, "check": judge,
            "note": note}
