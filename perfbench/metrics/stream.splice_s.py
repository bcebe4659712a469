"""stream.splice_s: self seconds of the program's span `tick/splice` (the
delta-scheduling splice against the component index) per tick of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "tick/splice")
