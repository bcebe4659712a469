"""The comparison that decides ``correct``: the program's answers against
the plain reference, and a feasibility referee over the program's
circuits. Every number here is a count of disagreements or violations, or
a relative gap; the traffic mix gives each its limit."""
from __future__ import annotations

import numpy as np


def referee(core, i, j, size, t_est, t_comp, rates, delta: float, N: int,
            rel=None) -> dict:
    """Violations in a set of circuits: ``unfinished`` (a time that is not
    a number), ``infeasible`` (two circuits sharing a port of a core at
    once, or a completion other than ``(t_est + delta) + size / rate``) and
    ``early`` (a circuit established before its coflow's release)."""
    rates = np.asarray(rates, dtype=np.float64)
    bad_t = int(np.isnan(t_est).sum() + np.isnan(t_comp).sum())
    form = int(np.sum(t_comp != (t_est + delta) + size / rates[core]))
    overlap = 0
    for port in (i, j):
        key = core * N + port
        o = np.lexsort((t_est, key))
        k, s, e = key[o], t_est[o], t_comp[o]
        same = k[1:] == k[:-1]
        overlap += int(np.sum(same & (s[1:] < e[:-1])))
    early = 0 if rel is None else int(np.sum(t_est < rel))
    return {"unfinished": bad_t, "infeasible": form + overlap,
            "early": early}


def _match(key_a: np.ndarray, key_b: np.ndarray):
    """``(missing + extra + duplicates, rows of a, rows of b)`` matched by
    key."""
    ua, ca = np.unique(key_a, return_counts=True)
    ub, cb = np.unique(key_b, return_counts=True)
    dup = int((ca - 1).sum() + (cb - 1).sum())
    common, ia, ib = np.intersect1d(key_a, key_b, assume_unique=False,
                                    return_indices=True)
    diff = int(ua.size + ub.size - 2 * common.size) + dup
    return diff, ia, ib


def _rows(ans: dict, want: dict, ia, ib) -> dict:
    return {
        "flow_diff": int(np.sum(ans["size"][ia] != want["size"][ib])),
        "choice_diff": int(np.sum(ans["core"][ia] != want["core"][ib])),
        "time_diff": int(np.sum((ans["t_est"][ia] != want["t_est"][ib])
                                | (ans["t_comp"][ia] != want["t_comp"][ib]))),
    }


def offline(ans: dict, want: dict, rates, delta: float, N: int) -> dict:
    """One schedule's answer against the reference's."""
    M = want["ccts"].size
    order_diff = (int(np.sum(ans["order"] != want["order"]))
                  if ans["order"].shape == want["order"].shape else M)
    ka = (ans["pos"] * N + ans["i"]) * N + ans["j"]
    kw = (want["pos"] * N + want["i"]) * N + want["j"]
    diff, ia, ib = _match(ka, kw)
    rows = _rows(ans, want, ia, ib)
    rows["flow_diff"] += diff
    cct = (int(np.sum(ans["ccts"] != want["ccts"]))
           if ans["ccts"].shape == want["ccts"].shape else M)
    gap = abs(ans["wcct"] - want["wcct"]) / abs(want["wcct"])
    ref = referee(ans["core"], ans["i"], ans["j"], ans["size"],
                  ans["t_est"], ans["t_comp"], rates, delta, N)
    return dict(order_diff=order_diff, **rows, cct_diff=cct,
                wcct_rel_gap=float(gap), infeasible=ref["infeasible"],
                unfinished=ref["unfinished"], answers_missing=0)


def stream(ans: dict, want: dict, rates, delta: float, N: int) -> dict:
    """The committed program of a stream against the reference's replay:
    every circuit the replay establishes by the last tick, and no other,
    on the same core at the same times; the final CCT of every coflow the
    replay completes by then."""
    est = ~np.isnan(want["t_est"])
    w = {k: want[k][est] for k in ("g", "i", "j", "size", "core", "t_est",
                                    "t_comp")}
    ka = (ans["g"] * N + ans["i"]) * N + ans["j"]
    kw = (w["g"] * N + w["i"]) * N + w["j"]
    diff, ia, ib = _match(ka, kw)
    rows = _rows(ans, w, ia, ib)
    rows["flow_diff"] += diff
    done = np.nonzero(~np.isnan(want["ccts"]))[0]
    got = ans["ccts"]
    have = done[done < got.size]
    cct = int(done.size - have.size
              + np.sum(got[have] != want["ccts"][have]))
    rel = want["releases"][np.clip(ans["g"], 0, want["releases"].size - 1)]
    ref = referee(ans["core"], ans["i"], ans["j"], ans["size"],
                  ans["t_est"], ans["t_comp"], rates, delta, N, rel=rel)
    return dict(**rows, cct_diff=cct, infeasible=ref["infeasible"],
                unfinished=ref["unfinished"], early=ref["early"],
                answers_missing=0)


def combine(parts: list[dict]) -> dict:
    """Counts add up over the answers judged; gaps take the largest. No
    answer at all is one missing answer."""
    if not parts:
        return {"answers_missing": 1}
    out = {}
    for k in parts[0]:
        vals = [p[k] for p in parts]
        out[k] = max(vals) if isinstance(vals[0], float) else sum(vals)
    return out
