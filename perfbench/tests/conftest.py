"""CPU tests of the benchmark harness. Run from the repository's root:
``python -m pytest -q perfbench/tests`` (``-m cuda`` on a machine with a
card). The program is imported from ``src``."""
import copy
import json
import sys
from argparse import Namespace
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def with_pending() -> dict:
    """``BENCHMARK.json`` with the entries of the cells kept out of it
    (``perfbench/pending/<cell>.json``) merged in, so that their drivers,
    references and readers stay tested."""
    from perfbench import harness
    bench = harness.load_benchmark()
    for f in sorted((ROOT / "perfbench" / "pending").glob("*.json")):
        extra = json.loads(f.read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


def small(workload: str, **traffic):
    """The cell's configuration and traffic cut to a CPU test's size: 16
    ports, 8 coflows a request, a short warm stream."""
    from perfbench import harness
    spec = harness.resolve(with_pending(), workload)
    cfg = copy.deepcopy(spec["config"])
    tr = copy.deepcopy(spec["traffic"])
    cfg["N"] = 16
    if tr["driver"] == "offline":
        tr.update(coflows=8, warm_requests=1, check_requests=3)
    else:
        tr.update(warm_span=512.0, block=16)
    tr.update(traffic)
    return cfg, tr


def run_small(workload: str, *, seed: int = 2 ** 31 + 5, seconds=0.5,
              trace: int = 0, config=None, traffic=None):
    """One run of the harness on the CPU, past its look for a chip."""
    import torch
    from perfbench import harness
    cfg, tr = small(workload)
    args = Namespace(workload=workload, seed=seed, seconds=seconds,
                     trace=trace)
    return harness.run(args, torch=torch, device=torch.device("cpu"),
                       bench=with_pending(), config=config or cfg,
                       traffic=traffic or tr)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
