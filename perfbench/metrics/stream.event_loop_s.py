"""stream.event_loop_s: self seconds of the program's span `tick/event_loop`
(the event loop over the touched rows) per tick of the window."""
from perfbench.obs import span_self_per_unit


def read(obs):
    return span_self_per_unit(obs, "tick/event_loop")
