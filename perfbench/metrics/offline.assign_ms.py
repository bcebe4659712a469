"""offline.assign_ms: device milliseconds of the assignment call
(`coflow_assign`, the whole call) per schedule, by CUDA events."""


def read(obs):
    ms = obs["counters"].get("assign_ms")
    if not ms or not obs.get("n_units"):
        return None
    return sum(ms) / obs["n_units"]
