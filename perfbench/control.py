"""The control and the planted faults: the timed path broken on purpose, so
that the comparison that decides ``correct`` can be seen to fail.

    python3 perfbench/control.py --workload <cell> --seed <n> --seconds <s> \
        --break <lowprec|altered|half|stale>

runs one cell as ``run.py`` does, with the program broken underneath, and
prints the result line (``correct`` has to read false). The benchmark's own
runs never do this; ``perfbench/tests/test_perfbench_control.py`` does it on
the CPU at a small size.

- ``lowprec`` (the control): the reference's assignment, one precision below
  the configuration's, in the program's place: bfloat16 for the offline
  kernel's float32 state, float32 for the stream's float64 host state.
- ``altered``: one core choice of each assignment call changed where it is
  produced.
- ``half``: half of each batch of coflows left out.
- ``stale``: each step returns the state it was given: the offline request
  answers with the first request's schedule; the stream's ticks admit and
  commit nothing.
"""
from __future__ import annotations

import contextlib
import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_root), str(_root / "src")]

BREAKS = ("lowprec", "altered", "half", "stale")


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _offline(kind: str, precision: str):
    import torch

    import repro_torch.core as core
    from repro_torch.core import engine
    from perfbench.reference import common

    if kind in ("lowprec", "altered"):
        assign = engine.coflow_assign

        def broken(fi, fj, sizes, rates, delta, *, n_ports):
            if kind == "altered":
                out = assign(fi, fj, sizes, rates, delta, n_ports=n_ports)
                out = out.clone()
                out[0] = (out[0] + 1) % rates.shape[0]
                return out
            ch = common.assign(fi.cpu().numpy(), fj.cpu().numpy(),
                               sizes.cpu().numpy(), rates.cpu().numpy(),
                               float(delta), n_ports, precision)
            return torch.from_numpy(ch).to(device=fi.device,
                                            dtype=torch.int32)

        return _patched(engine, "coflow_assign", broken)
    if kind == "half":
        build = core.instance_from_arrays

        def half(demand, weights, cids, rates, delta, **kw):
            m = max(1, len(demand) // 2)
            return build(demand[:m], weights[:m], cids[:m], rates, delta, **kw)

        return _patched(core, "instance_from_arrays", half)
    run_fast = core.run_fast
    first = []

    def stale(inst, *a, **kw):
        if not first:
            first.append(run_fast(inst, *a, **kw))
        return first[0]

    return _patched(core, "run_fast", stale)


def _stream(kind: str, precision: str):
    import numpy as np
    import torch

    from repro_torch.core import fabric
    from perfbench.reference import common

    if kind == "lowprec":
        class LowPrecision:
            def __init__(self, policy, rates, delta, n_ports, **kw):
                self.ref = common.Assigner(np.asarray(rates, np.float64),
                                           float(delta), int(n_ports),
                                           precision)

            def assign(self, fi, fj, sizes, *, up=None):
                ch = self.ref.assign(fi.numpy(), fj.numpy(), sizes.numpy())
                return torch.from_numpy(ch).to(fi.device)

        return _patched(fabric, "FlatAssignState", LowPrecision)
    step = fabric.FabricState.step
    if kind == "altered":
        def altered(self, coflows, releases, t_now):
            assign = self._assign.assign

            def flip(fi, fj, sizes, **kw):
                out = assign(fi, fj, sizes, **kw).clone()
                if out.numel():
                    out[0] = (out[0] + 1) % self.K
                return out

            self._assign.assign = flip
            try:
                return step(self, coflows, releases, t_now)
            finally:
                del self._assign.assign

        return _patched(fabric.FabricState, "step", altered)
    if kind == "half":
        def half(self, coflows, releases, t_now):
            keep = len(coflows) // 2
            return step(self, list(coflows)[:keep],
                        np.asarray(releases)[:keep], t_now)

        return _patched(fabric.FabricState, "step", half)

    def stale(self, coflows, releases, t_now):
        return step(self, (), np.zeros(0), self.t_now)

    return _patched(fabric.FabricState, "step", stale)


def broken(driver: str, kind: str, config: dict):
    """A context manager under which the program is broken by ``kind`` for
    a cell of ``driver`` whose configuration is ``config``."""
    if kind not in BREAKS:
        raise ValueError(f"break must be one of {BREAKS}")
    lower = {"float32": "bfloat16", "float64": "float32"}
    if driver == "offline":
        return _offline(kind, lower["float32"])
    return _stream(kind, lower["float64"])


def main(argv) -> int:
    import argparse

    import torch

    from perfbench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--break", dest="kind", choices=BREAKS, required=True)
    args = p.parse_args(argv)
    args.trace = 0
    spec = harness.resolve(harness.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    with broken(spec["traffic"]["driver"], args.kind, spec["config"]):
        res = harness.run(args, torch=torch, device=device,
                          t_start=T_START)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
