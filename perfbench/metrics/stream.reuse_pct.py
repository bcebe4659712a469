"""stream.reuse_pct: the delta splice's reuse, the mean over the window's
ticks of the `tick` span's `tent_reuse_fraction`, times 100."""
from perfbench.obs import span_attr_mean


def read(obs):
    v = span_attr_mean(obs, "tick", "tent_reuse_fraction")
    return None if v is None else 100.0 * v
