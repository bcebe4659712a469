"""Batched serving example on the port: prefill a batch of prompts, then
decode greedily from the KV cache.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

The port of ``examples/serve_batched.py``: Qwen1.5-0.5B's reduced config
with weights drawn from seed 0, four prompts from numpy's PCG64 seed 0;
on CUDA unless ``--device cpu``. Times are the host clock around work
that ends in a synchronise. The last line is a JSON summary: the shapes,
both times and the generated tokens.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models.api import build_model
from repro_torch.serve.engine import build_decode, build_prefill

ARCH = "qwen1.5-0.5b"
B, PROMPT, GEN = 4, 32, 24


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args(argv).device)

    def synced() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    cfg = get_arch(ARCH).smoke
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (B, PROMPT)),
                              dtype=torch.int32, device=dev)

    cache = model.make_caches(B, PROMPT + GEN + 8)
    prefill = build_prefill(model)
    decode = build_decode(model)

    t0 = synced()
    logits, cache = prefill(cache, {"tokens": prompts})
    t_prefill = synced() - t0

    out = []
    t0 = synced()
    for _ in range(GEN):
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(nxt[:, 0].cpu().numpy())
        logits, cache = decode(cache, nxt)
    t_decode = synced() - t0

    gen = np.stack(out, axis=1)
    print(f"arch={ARCH} (reduced) batch={B} prompt={PROMPT} gen={GEN}")
    print(f"prefill: {t_prefill*1e3:.1f} ms total "
          f"({B*PROMPT/t_prefill:.0f} tok/s)")
    print(f"decode : {t_decode/GEN*1e3:.1f} ms/step "
          f"({B*GEN/t_decode:.0f} tok/s)")
    for b in range(B):
        print(f"  request {b}: {gen[b].tolist()}")
    summary = {"device": str(dev), "arch": ARCH, "batch": B,
               "prompt": PROMPT, "gen": GEN, "prefill_s": t_prefill,
               "decode_s_per_step": t_decode / GEN,
               "tokens": gen.tolist()}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
