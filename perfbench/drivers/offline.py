"""Offline planning traffic: a closed loop of one planner that submits a
batch of coflows, waits for its schedule and submits the next.

A request is ``traffic["coflows"]`` distinct coflows of the configuration's
trace (``gen.fb_trace.RequestDeck``), turned into a device instance by
``instance_from_arrays`` and scheduled by ``run_fast`` with the traffic's
algorithm, scheduling and backend; it ends when the weighted CCT is on the
host and the device is synchronised. The window starts no request after
``--seconds`` and ends when the last one completes.

``sched_flows_per_s`` is the flows of every schedule of the window over the
window's wall time. A traced run also times the engine's layers from here,
around the names ``core/engine.py`` calls (a name the program no longer has
is skipped, and its metric left out).
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench.gen import fb_trace
from perfbench.reference import offline as ref_offline

#: (engine attribute, layer name, how it is timed): ``host`` is the host
#: clock between two synchronisations; ``events`` is CUDA events around the
#: call, with the call's flow count.
LAYERS = (("extract_flows", "offline.extract", "host"),
          ("coflow_assign", "offline.assign", "events"),
          ("_times_for_table", "offline.event_loop", "host"),
          ("_schedule_from_times", "offline.schedule", "host"))


def _wrap(ctx, engine, attr: str, layer: str, how: str, events: list):
    torch = ctx.torch
    fn = getattr(engine, attr, None)
    if fn is None:
        return None

    def host_timed(*a, **k):
        with torch.profiler.record_function(layer):
            ctx.sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            ctx.sync()
            ctx.record(layer, time.perf_counter() - t0)
        return out

    def event_timed(*a, **k):
        with torch.profiler.record_function(layer):
            if ctx.device.type != "cuda":  # the CPU tests: the host clock
                t0 = time.perf_counter()
                out = fn(*a, **k)
                ms = (time.perf_counter() - t0) * 1e3
                events.append((lambda: ms, int(a[0].shape[0])))
                return out
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events.append((lambda: e0.elapsed_time(e1), int(a[0].shape[0])))
        return out

    setattr(engine, attr, host_timed if how == "host" else event_timed)
    return fn


def answer_of(sched, wcct: float) -> dict:
    """A schedule's answer on the host, in the reference's terms."""
    h = {k: getattr(sched, k).cpu().numpy() for k in (
        "pi", "pos", "fi", "fj", "core", "size", "t_establish",
        "t_complete", "ccts")}
    return {"order": h["pi"], "pos": h["pos"], "i": h["fi"], "j": h["fj"],
            "core": h["core"], "size": h["size"], "t_est": h["t_establish"],
            "t_comp": h["t_complete"], "ccts": h["ccts"], "wcct": wcct}


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core import engine
    from repro_torch.core import instance_from_arrays, run_fast, weighted_cct

    cfg, tr = ctx.config, ctx.traffic
    rates = np.asarray(cfg["rates"], dtype=np.float64)
    delta = float(cfg["delta"])
    trace = fb_trace.synth_fb_trace(cfg["trace"]["coflows"],
                                    cfg["trace"]["seed"])
    pool = fb_trace.demand_pool(trace, cfg["N"], ctx.seed)
    deck = fb_trace.RequestDeck(fb_trace.nonempty(pool),
                                fb_trace.flow_counts(pool), tr["coflows"],
                                ctx.seed, tuple(cfg["weights"]))

    def request():
        pick, w = deck.next()
        inst = instance_from_arrays(pool[pick], w, pick, rates, delta,
                                    device=ctx.device)
        sched = run_fast(inst, tr["algorithm"], scheduling=tr["scheduling"],
                         backend=tr["backend"])
        wc = weighted_cct(sched)
        ctx.sync()
        return pick, w, sched, wc

    events: list = []
    saved = {}
    if ctx.trace:
        for attr, layer, how in LAYERS:
            fn = _wrap(ctx, engine, attr, layer, how, events)
            if fn is not None:
                saved[attr] = fn
    try:
        for _ in range(tr["warm_requests"]):
            request()
        ctx.obs["layers"].clear()
        events.clear()
        done = []
        with ctx.window():
            while time.perf_counter() - ctx.window.t0 < ctx.seconds:
                with torch.profiler.record_function("offline.request"):
                    done.append(request())
    finally:
        for attr, fn in saved.items():
            setattr(engine, attr, fn)
    flows = [d[2].n_flows for d in done]
    ctx.obs["n_units"] = len(done)
    if events:
        ctx.obs["counters"]["assign_ms"] = [ms() for ms, _ in events]
        ctx.obs["counters"]["assign_flows"] = [f for _, f in events]
    # the answers judged: a sample drawn from the seed, with the largest
    rng = np.random.default_rng([ctx.seed, 3])
    n = min(tr["check_requests"], len(done))
    idx = {int(np.argmax(flows))} if done else set()
    rest = [i for i in rng.permutation(len(done)).tolist() if i not in idx]
    idx.update(rest[:max(0, n - len(idx))])
    judged = [(done[i][0], done[i][1], answer_of(done[i][2], done[i][3]))
              for i in sorted(idx)]
    del done, events
    torch.cuda.empty_cache()

    def judge() -> dict:
        nums = []
        for pick, w, ans in judged:
            want = ref_offline.schedule(pool[pick], w, rates, delta,
                                        tr["precision"])
            nums.append(check.offline(ans, want, rates, delta, cfg["N"]))
        return check.combine(nums)

    note = (f"{len(flows)} schedules, {sum(flows)} flows (mean "
            f"{np.mean(flows) if flows else 0:.0f}, max "
            f"{max(flows, default=0)}); {len(judged)} judged")
    return {"metrics": {"sched_flows_per_s": sum(flows) / ctx.window.seconds},
            "attempted": len(flows), "failed": 0, "check": judge,
            "note": note}
