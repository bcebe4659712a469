"""online.event_loop_s: self seconds of the program's span `fast/event_loop`
(the release-gated circuit event loop on the host) per schedule of the
window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "fast/event_loop")
