"""Online planning traffic: a closed loop of one planner that submits a
stretch of arrivals, waits for its online schedule and submits the next.

A request is the next ``traffic["block"]`` arrivals of
``gen.fb_trace.arrival_stream`` at the traffic's rate (one block: one
coflow of every size stratum, the widest at fixed places), with releases
rebased to the block's first arrival. Every block's gaps are the trace's
own, so every request of every seed has one release vector, taken from
the first block: a later block's arrival times, rebased, differ from it
only in the rounding of the stream's running clock. The seed picks the members, their weights, the ports and the
shares. A request goes through ``online_instance_from_arrays`` and
``run_fast_online`` with the traffic's algorithm, scheduling and backend,
and ends when the weighted CCT is on the host and the device is
synchronised. The window starts no request after ``--seconds`` and ends
when the last one completes.

``sched_flows_per_s`` is the flows of every schedule of the window over
the window's wall time. A traced run records the program's own spans
(``obs/trace.py``) through a recording tracer installed as the
process-wide one, and restores the previous tracer at the end.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench import obs as pobs
from perfbench.drivers.offline import answer_of
from perfbench.gen import fb_trace
from perfbench.reference import online as ref_online


def requests(pool: np.ndarray, trace: list[dict], config: dict,
             traffic: dict, seed: int):
    """Endless ``(pick, weights, releases)`` requests of the traffic: the
    coflows of each block of the arrival stream, their weights, and the
    first block's releases rebased to its first arrival."""
    block = int(traffic["block"])
    arrivals = fb_trace.arrival_stream(
        trace, fb_trace.nonempty(pool), fb_trace.flow_counts(pool), seed,
        traffic["rate"], tuple(config["weights"]), block, traffic["stride"])
    rel = None
    while True:
        got = [next(arrivals) for _ in range(block)]
        pick = np.array([c for c, _, _ in got], dtype=np.int64)
        w = np.array([w for _, _, w in got], dtype=np.float64)
        if rel is None:
            t = np.array([r for _, r, _ in got])
            rel = t - t[0]
        yield pick, w, rel


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core import (online_instance_from_arrays,
                                  run_fast_online, weighted_cct)
    from repro_torch.obs.trace import set_tracer

    cfg, tr = ctx.config, ctx.traffic
    rates = np.asarray(cfg["rates"], dtype=np.float64)
    delta = float(cfg["delta"])
    trace = fb_trace.synth_fb_trace(cfg["trace"]["coflows"],
                                    cfg["trace"]["seed"])
    pool = fb_trace.demand_pool(trace, cfg["N"], ctx.seed)
    stream = requests(pool, trace, cfg, tr, ctx.seed)

    def request():
        pick, w, rel = next(stream)
        oinst = online_instance_from_arrays(pool[pick], w, pick, rates,
                                            delta, rel, device=ctx.device)
        sched = run_fast_online(oinst, tr["algorithm"],
                                scheduling=tr["scheduling"],
                                backend=tr["backend"])
        wc = weighted_cct(sched)
        ctx.sync()
        return pick, w, rel, sched, wc

    tracer = pobs.prof_tracer() if ctx.trace else None
    prev = set_tracer(tracer) if tracer is not None else None
    try:
        for _ in range(tr["warm_requests"]):
            request()
        if tracer is not None:
            tracer.records.clear()
        done = []
        with ctx.window():
            while time.perf_counter() - ctx.window.t0 < ctx.seconds:
                with torch.profiler.record_function("online.request"):
                    done.append(request())
    finally:
        if tracer is not None:
            set_tracer(prev)
    flows = [d[3].n_flows for d in done]
    ctx.obs["n_units"] = len(done)
    if tracer is not None:
        ctx.obs["spans"] = [r for r in tracer.records
                            if r["kind"] == "span"
                            and r["ts"] >= ctx.window.t0]
    # the answers judged: a sample drawn from the seed, with the largest
    rng = np.random.default_rng([ctx.seed, 3])
    n = min(tr["check_requests"], len(done))
    idx = {int(np.argmax(flows))} if done else set()
    rest = [i for i in rng.permutation(len(done)).tolist() if i not in idx]
    idx.update(rest[:max(0, n - len(idx))])
    judged = [(done[i][0], done[i][1], done[i][2],
               answer_of(done[i][3], done[i][4])) for i in sorted(idx)]
    del done
    torch.cuda.empty_cache()

    def judge() -> dict:
        nums = []
        for pick, w, rel, ans in judged:
            want = ref_online.schedule(pool[pick], w, rel, rates, delta,
                                       tr["precision"])
            num = check.offline(ans, want, rates, delta, cfg["N"])
            num["early"] = check.referee(
                ans["core"], ans["i"], ans["j"], ans["size"], ans["t_est"],
                ans["t_comp"], rates, delta, cfg["N"],
                rel=rel[ans["order"][ans["pos"]]])["early"]
            nums.append(num)
        return check.combine(nums)

    note = (f"{len(flows)} schedules, {sum(flows)} flows (mean "
            f"{np.mean(flows) if flows else 0:.0f}, max "
            f"{max(flows, default=0)}); releases span "
            f"{float(judged[0][2][-1]) if judged else 0.0:.1f}; "
            f"{len(judged)} judged")
    return {"metrics": {"sched_flows_per_s": sum(flows) / ctx.window.seconds},
            "attempted": len(flows), "failed": 0, "check": judge,
            "note": note}
