"""Algorithm 1's control plane and the baselines of its ablation, offline
and online, on the device: instances, WSPT ordering, flow extraction,
cross-core assignment (the tau-aware CUDA kernel, or the fp64 host backend),
the circuit event loops, the feasibility referee, CCT metrics and the sweep
API, and the streaming engine with its fault plane (``fabric``,
``fault``). Port of ``repro.core``."""
from .assignment import ASSIGN_POLICIES, FlatAssignState, assign_fast  # noqa: F401
from .batch import ResultTable, SweepRow, row_from_ccts, run_batch  # noqa: F401
from .coflow import (  # noqa: F401
    Coflow,
    Instance,
    OnlineInstance,
    col_loads,
    extract_flows,
    instance_from_arrays,
    instance_from_coflows,
    online_instance_from_arrays,
    rho,
    row_loads,
    tau,
)
from .engine import (  # noqa: F401
    BACKENDS,
    SCHEDULINGS,
    FlowTable,
    build_flow_table,
    run_fast,
    run_fast_metrics,
    run_fast_online,
)
from .fabric import (  # noqa: F401
    INCREMENTAL_SCHEDULINGS,
    ComponentIndex,
    FabricState,
    TickCommit,
    cross_check_incremental,
)
from .fault import (  # noqa: F401
    CoreDown,
    CoreUp,
    DeltaDrift,
    FaultInjector,
    PortFlap,
)
from .lower_bounds import global_lb, per_core_lb  # noqa: F401
from .online import online_orders  # noqa: F401
from .ordering import order_coflows, priority_scores  # noqa: F401
from .scheduler import (  # noqa: F401
    ALGORITHMS,
    Schedule,
    tail_cct,
    tail_quantile,
    weighted_cct,
    weighted_sum,
)
from .simulator import validate  # noqa: F401
from .trace import (  # noqa: F401
    TraceCoflow,
    arrival_stream,
    load_fb_trace,
    sample_instance,
    sample_online_instance,
    synth_fb_trace,
)
