"""Seeded flow streams that hit every hazard the assignment kernels forward.

The chain kernel (``csrc/coflow_assign_sm90.cu``) evaluates a flow before the
commits of the flows just ahead of it land in shared memory and forwards
them in registers: a shared ingress port ``i`` (row), egress port ``j``
(col) or cell ``(i, j)`` with the flow 1, 2 or 3 steps before. A random
stream hits these rarely at N = 150 or 512, so the tests and
``chip_smoke.py`` hold the kernels to the plain version on streams built to
hit each of them:

  - ``row@d``, ``col@d``, ``cell@d``: about half the flows repeat the
    port(s) of the flow ``d`` steps before, d in 1..4 (one past the
    pipeline's depth);
  - ``mixed``: each flow repeats a random port set at a random distance;
  - ``run``: long runs of one egress port (a coflow fanning in);
  - ``ties``: equal rates, delta = 0, equal sizes over four ports, so the
    argmin meets exact ties all the time;
  - ``zeros``: half the sizes are 0.

Each is numpy only and made from a seed, so both packages' tests can use it.

``FLASH_SHAPES`` does the same for the flash-attention kernels: the shapes
the RG-LRU hybrid and the enc-dec families bring, around the sm90 kernel's
tile edges, which the tests and ``chip_smoke.py`` both run.
"""
from __future__ import annotations

import numpy as np

__all__ = ["FLASH_SHAPES", "HAZARD_DISTANCES", "KINDS", "hazard_stream"]

#: Distances between a flow and the earlier flow whose ports it repeats.
HAZARD_DISTANCES = (1, 2, 3, 4)
#: Every kind of stream, in a fixed order (part of each stream's seed).
KINDS = tuple(f"{what}@{d}" for what in ("row", "col", "cell")
              for d in HAZARD_DISTANCES) + ("mixed", "run", "ties", "zeros")
#: (B, Sq, Sk, H, KVH, Dh, causal, window): Dh=256 (RecurrentGemma, MQA) at
#: S around the sm90 kernel's 64-row kv tiles with windows none, 1, 300 and
#: 2,048; then Sq != Sk both ways, causal (aligned top-left) and not, at
#: each head dim.
FLASH_SHAPES = [(2, S, S, 4, 1, 256, True, w)
                for S in (1, 63, 64, 65, 127, 128, 129, 700)
                for w in (None, 1, 300, 2048)]
FLASH_SHAPES += [(2, S, S, 4, 2, 256, False, None) for S in (64, 129)]
FLASH_SHAPES += [(2, sq, sk, 4, 2, Dh, causal, None)
                 for Dh in (64, 128, 256)
                 for sq, sk in ((128, 2048), (2048, 128), (1, 300),
                                (77, 200), (200, 77), (129, 65))
                 for causal in (True, False)]


def _repeat(fi: np.ndarray, fj: np.ndarray, t: int, what: str, d: int):
    if what in ("row", "cell"):
        fi[t] = fi[t - d]
    if what in ("col", "cell"):
        fj[t] = fj[t - d]


def hazard_stream(kind: str, k_cores: int, n_ports: int, n_flows: int = 300,
                  seed: int = 0):
    """``(fi, fj, sizes, rates, delta)`` of one stream: int32 ports, fp32
    sizes ``(F,)``, fp32 rates ``(K,)`` sorted, and a float delta."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    rng = np.random.default_rng([seed, k_cores, n_ports, KINDS.index(kind)])
    fi = rng.integers(0, n_ports, n_flows)
    fj = rng.integers(0, n_ports, n_flows)
    sizes = rng.exponential(50.0, n_flows) + 0.1
    rates = np.sort(rng.uniform(5.0, 30.0, k_cores))
    delta = 8.0
    if "@" in kind:
        what, d = kind.split("@")
        hit = rng.random(n_flows) < 0.5
        for t in range(int(d), n_flows):
            if hit[t]:
                _repeat(fi, fj, t, what, int(d))
    elif kind == "mixed":
        whats = rng.choice(("row", "col", "cell"), n_flows)
        dists = rng.choice(HAZARD_DISTANCES, n_flows)
        hit = rng.random(n_flows) < 0.6
        for t in range(n_flows):
            if hit[t] and t >= dists[t]:
                _repeat(fi, fj, t, str(whats[t]), int(dists[t]))
    elif kind == "run":
        t = 0
        while t < n_flows:
            length = int(rng.integers(20, 200))
            fj[t:t + length] = rng.integers(0, n_ports)
            t += length
    elif kind == "ties":
        ports = rng.choice(n_ports, size=min(n_ports, 4), replace=False)
        fi = ports[rng.integers(0, ports.size, n_flows)]
        fj = ports[rng.integers(0, ports.size, n_flows)]
        sizes = np.full(n_flows, 4.0)
        rates = np.full(k_cores, 10.0)
        delta = 0.0
    else:  # zeros
        sizes[rng.random(n_flows) < 0.5] = 0.0
        sizes[:8] = 0.0
    return (fi.astype(np.int32), fj.astype(np.int32),
            sizes.astype(np.float32), rates.astype(np.float32), delta)
