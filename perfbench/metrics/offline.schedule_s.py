"""offline.schedule_s: seconds of building the schedule and its CCTs
(`_schedule_from_times`, on the device) per schedule, host clock between two
synchronisations."""
from perfbench.obs import per_unit


def read(obs):
    return per_unit(obs, "offline.schedule")
