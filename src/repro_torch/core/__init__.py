"""Algorithm 1's offline control plane on the device: instances, WSPT
ordering, flow extraction, tau-aware assignment (a CUDA kernel), the
all-cores circuit event loop, the feasibility referee and CCT metrics.
Port of ``repro.core``'s offline path."""
from .coflow import (  # noqa: F401
    Instance,
    col_loads,
    extract_flows,
    instance_from_arrays,
    rho,
    row_loads,
    tau,
)
from .engine import (  # noqa: F401
    ALGORITHMS,
    SCHEDULINGS,
    FlowTable,
    build_flow_table,
    run_fast,
    run_fast_metrics,
)
from .lower_bounds import global_lb, per_core_lb  # noqa: F401
from .ordering import order_coflows, priority_scores  # noqa: F401
from .scheduler import Schedule, tail_cct, tail_quantile, weighted_cct  # noqa: F401
from .simulator import validate  # noqa: F401
from .trace import TraceCoflow, sample_instance, synth_fb_trace  # noqa: F401
