"""stream.assign_s: self seconds of the program's span `tick/assign` (batch
registration, extraction on the device and the fp64 host assignment) per
tick of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "tick/assign")
