"""offline.extract_s: seconds of flow extraction (`extract_flows`, on the
device) per schedule, host clock between two synchronisations."""
from perfbench.obs import per_unit


def read(obs):
    return per_unit(obs, "offline.extract")
