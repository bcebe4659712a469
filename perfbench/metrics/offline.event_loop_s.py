"""offline.event_loop_s: seconds of the circuit event loop
(`_times_for_table`: service times on the device, the host loop, the times
back) per schedule, host clock between two synchronisations."""
from perfbench.obs import per_unit


def read(obs):
    return per_unit(obs, "offline.event_loop")
