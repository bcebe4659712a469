#!/usr/bin/env python3
"""What the lanes assignment kernel's commit costs, by earlier designs.

Builds ``src/repro_torch/kernels/csrc/coflow_assign_lanes_sm90.cu`` as it
is and two copies with its commit put back the way it was first written,
and times them in turns with CUDA events on the trace's offline pi-ordered
flows (the 200-coflow, 150-port instance, 191,551 flows) at K=16 and K=64,
the rates 10/20/30 repeated. Every copy is a whole, correct kernel: the
script checks that each makes the lanes kernel's choices. The designs:

  branch_commit  the winning lane alone stores its pairs and the choice,
                 inside a branch that only it takes (the tree's kernel
                 has every lane store, the losers to slots of their own);
  atomic_bitmap  branch_commit, and the winner sets its bit of the cell's
                 word with an atomic OR (which nvcc aggregates over the
                 warp with a second redux.sync; a global bitmap is then
                 read past L1) instead of every lane storing the words a
                 ballot gives.

Run from the root of the repository on a machine with an H100:

    python3 scripts/lanes_ladder.py

It prints one line per timing (ms, ns and cycles a flow at the SM clock
that ``nvidia-smi`` reads beside it) and the card's name and power limit.
The copies are built under ``src/repro_torch/kernels/build/ladder/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/coflow_assign_lanes_sm90.cu"
OUT = ROOT / "src/repro_torch/kernels/build/ladder"

BRANCH = ("""      if (kStateShared) {  // no branch: the losers store to their slots
        float2* rdst = won ? row_s + cur.row + lc * kWarp + lane
                           : dummy_pairs + lane;
        float2* cdst = won ? col_s + cur.col + lc * kWarp + lane
                           : dummy_pairs + kWarp + lane;
        int* odst = won ? out_ring + (t & (kRing - 1)) : dummy_out + lane;
        *rdst = make_float2(rld, rt1);
        *cdst = make_float2(cld, ct1);
        *odst = C * lane + lc;
      } else if (won) {""", "      if (won) {")
ATOMIC = ("""      const bool used = !((cur.fresh >> c) & 1u) || (won && lc == c);
      nz[cur.cell + c] = __ballot_sync(kFullMask, used);""",
          """      if (won && lc == c) atomicOr(nz + cur.cell + c, lane_bit);""")
# the atomic lands in L2: a global bitmap is then read past L1
LDCG = ("    f.fresh |= ((~nz[e.z + c] >> lane) & 1u) << c;",
        "    f.fresh |= ((~(kNzShared ? nz[e.z + c] : __ldcg(nz + e.z + c))"
        " >> lane) & 1u) << c;")
VARIANTS = {"lanes": [], "branch_commit": [BRANCH],
            "atomic_bitmap": [BRANCH, ATOMIC, LDCG]}
KS = (16, 64)


def build(name: str) -> Path:
    from repro_torch.kernels import _build

    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old[:50]!r}")
        text = text.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    subprocess.run([_build.nvcc_path(), *_build.nvcc_flags(
        "coflow_assign_lanes_sm90"), "-o", str(lib), str(src)], check=True,
        capture_output=True)
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lanes_ladder: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import (extract_flows, order_coflows,
                                  sample_instance, synth_fb_trace)
    from repro_torch.kernels import coflow_assign as ca

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
    dev = torch.device("cuda")
    inst = sample_instance(synth_fb_trace(526, seed=2026), N=150, M=200,
                           rates=(10.0, 20.0, 30.0), delta=8.0, seed=0,
                           device=dev)
    _pos, _cid, fi, fj, sz = extract_flows(inst, order_coflows(inst))
    n = fi.numel()
    fns = {}
    for name, lib in libs.items():
        fns[name] = ctypes.CDLL(str(lib)).coflow_assign_lanes_launch
        fns[name].restype = ctypes.c_int
        fns[name].argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for K in KS:
        args = (fi.int(), fj.int(), sz.float(), torch.tensor(
            np.resize([10.0, 20.0, 30.0], K), dtype=torch.float32,
            device=dev))
        _c, _smem, state_b, nz_b = ca._lanes_layout(K, 150)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        want = ca.coflow_assign_cuda(*args, 8.0, n_ports=150)

        def launch(name):
            scratch = [torch.zeros(b, dtype=torch.uint8, device=dev)
                       if b else None for b in (state_b, nz_b)]
            err = fns[name](
                *(a.data_ptr() for a in args), 8.0, n, K, 150,
                *(None if b is None else b.data_ptr() for b in scratch),
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with {err}")

        order = list(VARIANTS)
        for name in order + order[::-1]:
            launch(name)
            if not torch.equal(out, want):
                raise AssertionError(f"{name} at K={K}: other choices")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                launch(name)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            mhz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0])
            print(f"{name:14s} {ms:8.3f} ms  {1e6 * ms / n:6.1f} ns  "
                  f"{1e3 * ms * mhz / n:5.0f} cycles a flow at {mhz:.0f} MHz "
                  f"(F={n}, K={K}, N=150)", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
