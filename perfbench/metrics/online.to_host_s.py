"""online.to_host_s: self seconds of the program's span `fast/to_host`
(service times and resource ids on the device, the online ordering's
priority ranks, the priority permutation, and the copies to the host) per
schedule of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "fast/to_host")
