"""Decode collective replica groups into device-id groups.

Port of ``repro.comm.extract``. A ``CollectiveOp``'s ``metadata`` holds its
groups in one of the reference's two formats:

  explicit : {{0,1,2,3},{4,5,6,7}}     (what ``analysis.collectives`` writes)
  iota v2  : [G,g]<=[d0,d1,...]T(p0,p1,...)   (arange(prod(d)).reshape(d)
                                               .transpose(p).reshape(G,g))

and a collective-permute's ``source_target_pairs`` after ``|st=``.
"""
from __future__ import annotations

import re

import numpy as np

from ..analysis.collectives import CollectiveOp

__all__ = ["decode_groups", "decode_pairs"]

_IOTA_RE = re.compile(r"\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")


def decode_groups(c: CollectiveOp, total_devices: int) -> list[list[int]]:
    """Replica groups as explicit device-id lists."""
    meta = c.metadata.split("|st=")[0]
    if meta.startswith("{{"):
        return [[int(x) for x in grp.split(",") if x != ""]
                for grp in re.findall(r"\{([\d,]+)\}", meta)]
    m = _IOTA_RE.search(meta)
    if m:
        out_shape = [int(x) for x in m.group(1).split(",")]
        in_shape = [int(x) for x in m.group(2).split(",")]
        ids = np.arange(int(np.prod(in_shape))).reshape(in_shape)
        if m.group(3):
            perm = [int(x) for x in m.group(3).split(",")]
            ids = ids.transpose(perm)
        return ids.reshape(out_shape).tolist()
    # no annotation: one flat group over everything
    return [list(range(total_devices))]


def decode_pairs(c: CollectiveOp) -> list[tuple[int, int]]:
    """source_target_pairs of a collective-permute."""
    if "|st=" not in c.metadata:
        return []
    body = c.metadata.split("|st=", 1)[1]
    return [(int(a), int(b))
            for a, b in re.findall(r"\{(\d+),(\d+)\}", body)]
