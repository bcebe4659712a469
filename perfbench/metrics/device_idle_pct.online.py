"""device_idle_pct.online: 100 x (1 - the union of the device's
operations / the window), from the profiler's trace."""
from perfbench.obs import idle_pct


def read(obs):
    return idle_pct(obs)
