#!/usr/bin/env python3
"""The lanes assignment kernel against the kernels of an earlier checkout.

Builds this tree's chain and lanes kernels (``kernels/csrc/
coflow_assign_sm90.cu``, ``coflow_assign_lanes_sm90.cu``) and, with
``--parent DIR``, the warp kernel of an earlier checkout
(``kernels/csrc/coflow_assign.cu``, the K > 8 kernel the lanes kernel
replaced), through that checkout's own ``kernels`` package loaded under
another name. On the trace's offline pi-ordered flows (the 200- and the
526-coflow instances at N=150: F=191,551 and 443,943) at K=3, 16 and 32,
or the K that ``--ks`` names (257 and 512 are the lanes kernel's cores in
memory; the warp kernel served at most 256), with the rates 10/20/30
repeated, so equal-rate cores tie exactly, it checks
that every kernel makes the same choices and times them in turns (warp,
lanes, lanes, warp; at K=3 the chain kernel too) with CUDA events, the SM
clock read beside each timing.

Run from the root of the repository on a machine with an H100, after
unpacking the earlier commit into a git-ignored directory:

    git archive <commit> | tar -x -C scratch_chip/parent
    python3 scripts/chip_lanes.py --parent scratch_chip/parent
    python3 scripts/chip_lanes.py --ks 16,257,512

It prints one line per timing (ms, ns and cycles a flow), the card's name
and power limit, and writes the timings to ``chiprun_out/chip_lanes.json``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

KS = (3, 16, 32)


def parent_kernels(parent: Path):
    """The earlier checkout's ``kernels.coflow_assign``, imported as
    ``parent_kernels.coflow_assign`` (it builds into its own tree)."""
    pkg = parent / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_kernels.coflow_assign")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier checkout with the warp kernel")
    ap.add_argument("--ks", default=",".join(map(str, KS)),
                    help="the cores to time, comma-separated")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "chip_lanes.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import (extract_flows, order_coflows,
                                  sample_instance, synth_fb_trace)
    from repro_torch.kernels import coflow_assign as ca

    if not torch.cuda.is_available():
        print("chip_lanes: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    old = parent_kernels(args.parent.resolve()) if args.parent else None
    kernels = {"chain_sm90": lambda *a: ca.coflow_assign_cuda(
                   *a, cs.DELTA, n_ports=cs.N_PORTS, kernel="chain_sm90"),
               "lanes_sm90": lambda *a: ca.coflow_assign_cuda(
                   *a, cs.DELTA, n_ports=cs.N_PORTS, kernel="lanes_sm90")}
    if old is not None:
        kernels["warp"] = lambda *a: old.coflow_assign_cuda(
            *a, cs.DELTA, n_ports=cs.N_PORTS, kernel="warp")

    trace = synth_fb_trace(cs.TRACE_COFLOWS, seed=cs.TRACE_SEED)
    rows = []
    for M in (cs.M_MAIN, cs.TRACE_COFLOWS):
        inst = sample_instance(trace, N=cs.N_PORTS, M=M, rates=cs.RATES,
                               delta=cs.DELTA, seed=0, device=dev)
        _pos, _cid, fi, fj, sz = extract_flows(inst, order_coflows(inst))
        flows = (fi.int(), fj.int(), sz.float())
        n = flows[0].numel()
        for K in map(int, args.ks.split(",")):
            rates = torch.tensor(np.resize(cs.RATES, K), dtype=torch.float32,
                                 device=dev)
            names = [k for k in ("warp", "chain_sm90", "lanes_sm90")
                     if k in kernels and (k != "chain_sm90"
                                          or K <= ca.CHAIN_MAX_CORES)]
            outs = {k: kernels[k](*flows, rates) for k in names}
            for k in names[1:]:
                if not torch.equal(outs[k], outs[names[0]]):
                    raise AssertionError(f"F={n} K={K}: {k} != {names[0]}")
            for k in names + names[::-1]:
                t_ms = cs.event_ms(lambda: kernels[k](*flows, rates), reps=5)
                mhz = float(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, check=True, timeout=60).stdout.split()[0])
                rows.append({"F": n, "K": K, "kernel": k, "ms": t_ms,
                             "sm_mhz": mhz})
                print(f"F={n} K={K} {k}: {t_ms:.3f} ms, {1e6 * t_ms / n:.1f} "
                      f"ns and {1e3 * t_ms * mhz / n:.0f} cycles per flow (SM "
                      f"clock {mhz:.0f} MHz)", flush=True)
            print(f"F={n} K={K}: {', '.join(names)} make the same choices; "
                  f"lanes kernel floor {cs.CHAIN_CYCLES_PER_OP} x "
                  f"{cs.lanes_dependent_ops(K)} = "
                  f"{cs.CHAIN_CYCLES_PER_OP * cs.lanes_dependent_ops(K)} "
                  f"cycles a flow (derived)", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
