"""stream.admit_s: self seconds of the program's span `tick/admit` (the
admission queue's drain under the flow budget) per tick of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "tick/admit")
