"""The benchmark harness: one run of one cell, driven by ``BENCHMARK.json``.

Everything that belongs to one item is found by its name: a cell's
configuration is the file its ``configs`` entry names, its traffic mix is
``perfbench/traffic/<traffic>.json`` (whose ``driver`` names the module of
``perfbench/drivers/`` that serves that kind of traffic), and a per-layer
metric is read by ``perfbench/metrics/<metric>.py``. No code here knows a
cell, a configuration or a metric by name.

A run: check for the chips the cell asks for, set up (load, build, warm),
measure for ``--seconds``, read the device's peak memory, free the
program's state, reduce the trace (``--trace 1``), judge the window's
answers against the plain reference, check that no JAX module was loaded,
and print one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

#: Top-level module names that may not be loaded: the JAX stack and the
#: JAX package the program was ported from. Compared whole.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: Where the program keeps what it builds (inside the checkout); a run that
#: adds a file there during set-up built something, and says so.
BUILD_DIRS = (ROOT / "src",)


class Window:
    """The measured window: host clock, and with ``trace`` the profiler and
    a ``perfbench.window`` range in its trace. Drivers open it once with
    ``with ctx.window():`` after their set-up. Python's cyclic garbage
    collector is run before the window and kept off inside it, so that no
    collection of set-up's objects lands in the timed work."""

    def __init__(self, torch, device, trace: bool) -> None:
        self.torch = torch
        self.device = device
        self.trace = trace
        self.t0 = self.t1 = None
        self.prof = None
        self.memory_peak = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self):
        torch = self.torch
        self.sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            rf = torch.profiler.record_function("perfbench.window")
            rf.__enter__()
        gc.collect()
        gc.disable()
        self.t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.sync()
            self.t1 = time.perf_counter()
            gc.enable()
            if self.trace:
                rf.__exit__(None, None, None)
                self.prof.__exit__(None, None, None)
            if self.device.type == "cuda":
                self.memory_peak = int(torch.cuda.max_memory_allocated(
                    self.device))

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Context:
    """What a driver gets: the cell's configuration and traffic, the run's
    arguments, the device, the window, and ``obs``, where it leaves what
    the per-layer readers read."""

    def __init__(self, config, traffic, args, torch, device) -> None:
        self.config = config
        self.traffic = traffic
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.torch = torch
        self.device = device
        self.window = Window(torch, device, self.trace)
        self.obs: dict = {"layers": {}, "spans": [], "counters": {}}

    def sync(self) -> None:
        """Wait for the device's pending work."""
        self.window.sync()

    def record(self, layer: str, seconds: float) -> None:
        """One call of ``layer`` took ``seconds`` (traced runs)."""
        self.obs["layers"].setdefault(layer, []).append(seconds)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic and metrics,
    each read from the file its name leads to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(m: dict) -> bool:
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in e2e_names]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The ``read(obs)`` function of ``perfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of
    ``FORBIDDEN_MODULES``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def built_files() -> set[str]:
    """The files under ``BUILD_DIRS``, bytecode caches left out."""
    return {str(p) for d in BUILD_DIRS if d.is_dir() for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def pin_host_thread(torch, device) -> None:
    """Keep the calling thread (the one that drives the timed work) on one
    fixed core of those the process may use, the last, once the device's
    context and its threads exist, so that they stay free to run
    elsewhere."""
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict | None = None,
                setup_built: bool = False) -> dict:
    """The result's JSON object. ``setup_built`` says that set-up built
    something of the program (a first run in a checkout), so that its
    ``setup_s`` is read apart; ``checks`` (each number compared beside its
    limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_built"] = bool(setup_built)
    out["checks"] = checks
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number against its limit (each must be at most its limit and
    not NaN); ``(correct, {name: {"value", "limit"}})``."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and not math.isnan(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def run(args, *, torch, device, bench: dict | None = None,
        t_start: float | None = None, config=None, traffic=None) -> dict:
    """One run of ``args.workload`` on ``device``, past the look for a
    chip; returns the result object. ``config``/``traffic`` replace the
    cell's files (the CPU tests run small sizes this way)."""
    t_start = time.perf_counter() if t_start is None else t_start
    before = built_files()
    bench = load_benchmark() if bench is None else bench
    spec = resolve(bench, args.workload)
    config = spec["config"] if config is None else config
    traffic = spec["traffic"] if traffic is None else traffic
    ctx = Context(config, traffic, args, torch, device)
    drv = driver(traffic["driver"])
    out = drv.run(ctx)  # set-up, the window, the answers on the host
    setup_s = ctx.window.t0 - t_start
    setup_built = bool(built_files() - before)
    values = dict(out["metrics"], setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    breakdown = None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": ctx.window.memory_peak}
    if ctx.trace:
        from perfbench import profile
        prof = profile.reduce(ctx.window.prof, ctx.window.seconds)
        ctx.obs["profile"] = prof
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
        wanted = spec["per_layer"]
        values = {}
        for m in wanted:
            v = reader(m["name"])(ctx.obs)
            if v is not None:
                values[m["name"]] = v
    else:
        wanted = spec["end_to_end"]
    metrics = {m["name"]: {"value": float(values[m["name"]]),
                           "unit": units[m["name"]]}
               for m in wanted if m["name"] in values}
    t_check = time.perf_counter()
    numbers = out["check"]()
    print(f"perfbench: the reference took "
          f"{time.perf_counter() - t_check:.3f} s; {out['note']}",
          file=sys.stderr)
    correct, checks = judge(numbers, traffic["limits"])
    return result_line(correct=correct and out["failed"] == 0,
                       attempted=out["attempted"], failed=out["failed"],
                       metrics=metrics, device=dev, checks=checks,
                       breakdown=breakdown, setup_built=setup_built)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_benchmark()
    cell = resolve(bench, args.workload)["cell"]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    pin_host_thread(torch, device)
    res = run(args, torch=torch, device=device, bench=bench,
              t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: modules of the JAX stack or package loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0
