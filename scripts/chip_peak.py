#!/usr/bin/env python3
"""Where phase 15(a)'s peak memory goes, and what ``MemTracker`` (the dry
run's peak estimate, ``launch/dryrun.py::_peak``) sees of it.

On one card: TinyLlama-1.1B at full width (15a's config, B=8 x 2,048, 2
microbatches, seeded weights), one warm step, then

  - one step with ``torch.cuda.max_memory_allocated`` and the caching
    allocator's history (``torch.cuda.memory._record_memory_history``)
    replayed to the moment of the peak: the live bytes then, grouped by
    the innermost frame in ``repro_torch`` (or the innermost frame) that
    allocated them, largest first;
  - ``MemTracker`` on the next real step, by category;
  - ``MemTracker`` under ``FakeTensorMode`` on the same step of a ``meta``
    model, without DTensors.

(``chip_smoke.py``'s 17(a) holds the dry run's estimate on the step's meta
DTensors against 15(a)'s peak.) Run from the root of the repository on a
machine with an H100:

    python3 scripts/chip_peak.py

It prints its lines and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GIB = 2 ** 30


def _site(frames: list) -> str:
    for f in frames:
        if "repro_torch" in f["filename"]:
            name = f["filename"].split("repro_torch/")[-1]
            return f"{name}:{f['line']} {f['name']}"
    f = frames[0] if frames else {"filename": "?", "line": 0, "name": "?"}
    return f"{f['filename']}:{f['line']} {f['name']}"


def live_at_peak(trace: list) -> tuple[int, dict]:
    """(peak bytes, {site: bytes live at the peak}) of an allocator trace."""
    live, total, peak, at = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            total += e["size"]
            if total > peak:
                peak, at = total, i
        elif e["action"] == "free_completed" and e["addr"] in live:
            total -= live.pop(e["addr"])
    sites, live = defaultdict(int), {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _site(e.get("frames", [])))
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    for size, site in live.values():
        sites[site] += size
    return peak, dict(sites)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_peak: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # puts src/ on the path
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import PackedLoader, SyntheticCorpus
    from repro_torch.models.api import build_model
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.step import build_train_step

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").config,
                              attention_impl="chunked")
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = init_opt_state(params)
    step = build_train_step(model, OptimizerConfig(
        lr=1e-3, warmup_steps=1, total_steps=chip_smoke.TRAIN_STEPS),
        microbatches=chip_smoke.TRAIN_MB)
    loader = PackedLoader(SyntheticCorpus(cfg.vocab, seed=0),
                          global_batch=chip_smoke.TRAIN_B,
                          seq_len=chip_smoke.TRAIN_S)

    def batch(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in loader._make_batch(i).items()}

    params, opt, _ = step(params, opt, batch(0))  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=2_000_000)
    params, opt, _ = step(params, opt, batch(1))
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    measured = torch.cuda.max_memory_allocated()
    trace = snap["device_traces"][0]
    peak, sites = live_at_peak(trace)
    print(f"[peak] 15a's step 2 (B={chip_smoke.TRAIN_B} x "
          f"{chip_smoke.TRAIN_S}, {chip_smoke.TRAIN_MB} microbatches): "
          f"max_memory_allocated {measured / GIB:.2f} GiB; allocated before "
          f"the step {base / GIB:.2f} GiB; the trace's {len(trace)} events "
          f"replayed: {peak / GIB:.2f} GiB allocated during the step at its "
          f"peak, by site:", flush=True)
    for site, size in sorted(sites.items(), key=lambda kv: -kv[1])[:25]:
        print(f"[peak]   {size / GIB:8.3f} GiB  {site}")

    tracker = MemTracker()
    tracker.track_external(model, *params.values(),
                           *(t for g in ("master", "m", "v")
                             for t in opt[g].values()))
    torch.cuda.reset_peak_memory_stats()
    with tracker:
        params, opt, _ = step(params, opt, batch(2))
    torch.cuda.synchronize()
    snap = tracker.get_tracker_snapshot("peak")
    for d, s in snap.items():
        print(f"[peak] MemTracker on the real step 3, {d}: " + ", ".join(
            f"{str(k).split('.')[-1]} {v / GIB:.2f}" for k, v in s.items())
            + f" GiB; max_memory_allocated of that step "
            f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB")
    del model, params, opt, step, tracker
    torch.cuda.empty_cache()

    # the dry run's estimate, without DTensors: a meta model under
    # FakeTensorMode
    from torch._subclasses.fake_tensor import FakeTensorMode

    meta = build_model(cfg, device="meta")
    m_params = {k: p.detach() for k, p in meta.named_parameters()}
    m_opt = init_opt_state(m_params)
    m_opt["step"] = torch.zeros((), dtype=torch.int32)  # read on the host
    m_batch = {k: torch.empty((chip_smoke.TRAIN_B, chip_smoke.TRAIN_S),
                              dtype=torch.int32, device="meta")
               for k in ("tokens", "labels")}
    m_step = build_train_step(meta, OptimizerConfig(),
                              microbatches=chip_smoke.TRAIN_MB)
    tracker = MemTracker()
    with FakeTensorMode(allow_non_fake_inputs=True):
        tracker.track_external(meta, *m_params.values(), *(
            t for g in ("master", "m", "v") for t in m_opt[g].values()),
            *m_batch.values())
        with tracker:
            m_step(m_params, m_opt, m_batch)
    for d, s in tracker.get_tracker_snapshot("peak").items():
        print(f"[peak] MemTracker under FakeTensorMode, meta model, no "
              f"mesh, {d}: " + ", ".join(
                  f"{str(k).split('.')[-1]} {v / GIB:.2f}"
                  for k, v in s.items()) + " GiB", flush=True)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
