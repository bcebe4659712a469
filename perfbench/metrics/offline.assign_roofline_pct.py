"""offline.assign_roofline_pct: the assignment call's share of its
roofline: the least time the chip's memory needs for the flows' bytes (16 a
flow, `peaks.ASSIGN_BYTES_PER_FLOW`, at 3.35 TB/s) over the call's device
time, summed over the window's calls. The work is read from the flow count,
whatever implements the call."""
from perfbench import peaks


def read(obs):
    ms = obs["counters"].get("assign_ms")
    flows = obs["counters"].get("assign_flows")
    if not ms or sum(ms) <= 0:
        return None
    least = sum(peaks.bytes_bound_s(peaks.assign_bytes(f)) for f in flows)
    return 100.0 * least / (sum(ms) * 1e-3)
