#!/usr/bin/env python3
"""Where the chain assignment kernel's step spends its time, by subtraction.

Builds ``src/repro_torch/kernels/csrc/coflow_assign_sm90.cu`` as it is and
four copies with a part of the per-flow step cut out, and times each with
CUDA events on the main path's flows (the 200-coflow, 150-port trace
instance, 191,551 flows, K=3). A cut copy gives wrong choices: its time
only says what the part costs. The parts:

  no_gather   the K shuffles that copy each lane's evaluation to every lane
              (each lane keeps its own value);
  no_commit   the commit's stores of load, tau and the bitmap byte;
  no_eval     the evaluation of the flow two steps ahead (cost, gathers and
              both forwards): the chain reuses the last evaluation;
  chain_only  no_eval without the commit and the loads: the argmin, the
              bounds and candidates, the choice's store, and the loop.

Run from the root of the repository on a machine with an H100:

    python3 scripts/chain_ladder.py

It prints one line per variant (ms, ns and cycles a flow at the SM clock
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

SOURCE = ROOT / "src/repro_torch/kernels/csrc/coflow_assign_sm90.cu"
OUT = ROOT / "src/repro_torch/kernels/build/ladder"

GATHER = ("for (int k = 0; k < K; ++k) out[k] = __shfl_sync(kFullMask, v, k);",
          "for (int k = 0; k < K; ++k) out[k] = v + k;")
COMMIT = ("""    if (lane == ks) {
      row_s[cur.row + ks] = make_float2(cur.rld, cur.rt1);
      col_s[cur.col + ks] = make_float2(cur.cld, cur.ct1);
    }
    nz[cur.cell] = static_cast<uint8_t>(cur.nz | (1u << ks));""", "")
LOADS = ("""    loaded_out = load_flow<kNzShared>(ahead, row_s, col_s, nz, core);
    ahead_out = ring[(t + 4) & (kRing - 1)];""",
         "    loaded_out = loaded;\n    ahead_out = ahead;")
EVAL = ("    evaluate(loaded, ks, cur, cur_out, next_out);",
        "    next_out = next;")
VARIANTS = {"full": [], "no_gather": [GATHER], "no_commit": [COMMIT],
            "no_eval": [EVAL], "chain_only": [COMMIT, LOADS, EVAL]}


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
        "coflow_assign_sm90"), "-o", str(lib), str(src)], check=True,
        capture_output=True)
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_ladder: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import (extract_flows, order_coflows,
                                  sample_instance, synth_fb_trace)

    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
    dev = torch.device("cuda")
    inst = sample_instance(synth_fb_trace(526, seed=2026), N=150, M=200,
                           rates=(10.0, 20.0, 30.0), delta=8.0, seed=0,
                           device=dev)
    _pos, _cid, fi, fj, sz = extract_flows(inst, order_coflows(inst))
    args = (fi.int(), fj.int(), sz.float(), inst.rates.float())
    n = fi.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for name in (*VARIANTS, "full"):
        fn = ctypes.CDLL(str(libs[name])).coflow_assign_sm90_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3

        def launch():
            err = fn(*(a.data_ptr() for a in args), 8.0, n, 3, 150, None,
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed with {err}")

        launch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            launch()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 3
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True).stdout.split()[0])
        print(f"{name:10s} {ms:8.3f} ms  {1e6 * ms / n:6.1f} ns  "
              f"{1e3 * ms * mhz / n:5.0f} cycles a flow at {mhz:.0f} MHz "
              f"(F={n}, K=3, N=150)", flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
