#!/usr/bin/env python3
"""The fp32 flash-attention kernel against the one of an earlier checkout.

Builds this tree's fp32 kernel (``kernels/csrc/flash_attention_fp32_sm90.cu``,
``"sm90_fp32"``: a tf32 split pre-pass, then TMA + wgmma in 3xTF32) and,
with ``--parent DIR``, the SIMT kernel of an earlier checkout
(``kernels/csrc/flash_attention.cu``, ``"simt_fp32"``, the fp32 kernel it
replaced), through that checkout's own ``kernels`` package loaded under
another name. At the shapes of the bf16 kernel's rows in PERF.md, in fp32:

  - TinyLlama-1.1B's prefill: B=8, S=2048, H=32, KVH=4, Dh=64, causal;
  - RecurrentGemma-9B's attention: B=8, S=4096, H=16, KVH=1, Dh=256,
    causal, window 2048;
  - Seamless-M4T's cross-attention: B=8, Sq=128, Sk=2048, H=KVH=16, Dh=64;
  - Seamless-M4T's encoder: B=8, S=2048, H=KVH=16, Dh=64, non-causal;

on seeded standard-normal q, k, v, it holds each kernel to the plain
version (atol = rtol 1e-5), times the kernels in turns (simt, sm90, sm90,
simt) with CUDA events, beside the pre-pass alone, the plain version,
SDPA in fp32 and both bounds of the work: 3xTF32 on the tensor cores
(three TF32 products at 495 TFLOP/s) and fp32 FFMA (67 TFLOP/s), each
against the bytes at 3.35 TB/s.

Run from the root of the repository on a machine with an H100, after
unpacking the earlier commit into a git-ignored directory:

    git archive <commit> | tar -x -C scratch_chip/parent
    python3 scripts/chip_flash_fp32.py --parent scratch_chip/parent

It prints one line per timing, the card's name and power limit, and writes
the timings to ``chiprun_out/chip_flash_fp32.json``.
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

#: Launches a timing, after a warm one (chip_smoke.py's phase 7 count).
REPS = 5
#: (label, B, Sq, Sk, H, KVH, Dh, causal, window)
SHAPES = [("tinyllama prefill", 8, 2048, 2048, 32, 4, 64, True, None),
          ("recurrentgemma window", 8, 4096, 4096, 16, 1, 256, True, 2048),
          ("seamless cross", 8, 128, 2048, 16, 16, 64, False, None),
          ("seamless encoder", 8, 2048, 2048, 16, 16, 64, False, None)]


def parent_kernels(parent: Path):
    """The earlier checkout's ``kernels.flash_attention``, imported as
    ``parent_kernels.flash_attention`` (it builds into its own tree)."""
    pkg = parent / "src" / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "parent_kernels", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_kernels.flash_attention")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked earlier checkout with the SIMT kernel")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "chip_flash_fp32.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("chip_flash_fp32: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    old = parent_kernels(args.parent.resolve()) if args.parent else None
    rows = []
    for label, B, Sq, Sk, H, KVH, Dh, causal, window in SHAPES:
        rng = np.random.default_rng(Sq + Sk + Dh)
        q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev) for shape in (
                (B, Sq, H, Dh), (B, Sk, KVH, Dh), (B, Sk, KVH, Dh)))
        kw = dict(causal=causal, window=window)
        kernels = {"sm90_fp32": lambda: fa.flash_attention_cuda(q, k, v, **kw)}
        if old is not None:
            kernels["simt_fp32"] = lambda: old.flash_attention_cuda(
                q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        errs = {}
        for name, fn in kernels.items():
            got = fn()
            torch.cuda.synchronize()
            errs[name] = float((got - want).abs().max())
            bad = int((~torch.isclose(got, want, atol=1e-5, rtol=1e-5)).sum())
            if bad or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: {name} != plain version "
                                     f"({bad} elements outside 1e-5)")
        del got, want
        order = list(kernels)[::-1]  # simt, sm90, sm90, simt
        ms = {name: [] for name in kernels}
        for name in order + order[::-1]:
            ms[name].append(cs.event_ms(kernels[name], REPS))
        prepass_ms = cs.event_ms(lambda: fa.tf32_planes_cuda(k, v), 20)
        plain_ms = cs.event_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                               2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if window:  # SDPA takes a window only as an explicit mask
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Sk, device=dev)[None, :]
            mask = (kp > qp - window) & ((kp <= qp) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)

        sdpa()
        sdpa_ms = cs.event_ms(sdpa, REPS)
        pairs = cs.visible_pairs(Sq, Sk, causal, window)
        flops = 4.0 * Dh * B * H * pairs
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 4
        bytes_s = n_bytes / cs.HBM_BYTES_PER_S
        tc_ms = 1e3 * max(3 * flops / cs.TF32_OPS_PER_S, bytes_s)
        ffma_ms = 1e3 * max(flops / cs.FP32_OPS_PER_S, bytes_s)
        row = {"shape": label, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "KVH": KVH,
               "Dh": Dh, "causal": causal, "window": window, "flops": flops,
               "bytes": n_bytes, "ms": ms, "prepass_ms": prepass_ms,
               "plain_ms": plain_ms, "sdpa_ms": sdpa_ms,
               "bound_ms": tc_ms, "ffma_bound_ms": ffma_ms,
               "max_abs_err": errs}
        rows.append(row)
        for name, times in ms.items():
            mean = sum(times) / len(times)
            print(f"{label} {(B, Sq, Sk, H, KVH, Dh, causal, window)} {name}: "
                  f"{' / '.join(f'{t:.4f}' for t in times)} ms "
                  f"({flops / mean / 1e9:.1f} TFLOP/s; {tc_ms / mean:.1%} of "
                  f"the 3xTF32 bound, {ffma_ms / mean:.1%} of the FFMA bound; "
                  f"max|kernel - plain| {errs[name]:.3e})", flush=True)
        print(f"{label}: pre-pass {prepass_ms:.4f} ms; plain version "
              f"{plain_ms:.3f} ms; SDPA fp32 {sdpa_ms:.4f} ms; bounds "
              f"{tc_ms:.4f} ms (3xTF32: {3 * flops:.4e} FLOP at 495 TFLOP/s) "
              f"and {ffma_ms:.4f} ms (FFMA: {flops:.4e} FLOP at 67 TFLOP/s), "
              f"{n_bytes:,} B at 3.35 TB/s", flush=True)
        if "simt_fp32" in ms:
            ratio = sum(ms["sm90_fp32"]) / sum(ms["simt_fp32"])
            print(f"{label}: sm90_fp32 takes {ratio:.3f} of simt_fp32's time",
                  flush=True)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
