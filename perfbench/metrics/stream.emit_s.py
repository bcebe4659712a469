"""stream.emit_s: self seconds of the program's span `tick/program_emit`
(circuit-program compilation) per tick of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "tick/program_emit")
