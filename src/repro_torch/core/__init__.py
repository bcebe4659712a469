"""Algorithm 1's control plane and the baselines of its ablation, offline
and online, on the device: instances, WSPT ordering, flow extraction,
cross-core assignment (the tau-aware CUDA kernel, or the fp64 host backend),
the circuit event loops, the feasibility referee, CCT metrics and the sweep
API, and the streaming engine with its fault plane (``fabric``,
``fault``). Also the reference's oracles, kept as a second implementation:
the dataclass assignments, the per-core circuit schedulers, ``run``,
``run_online`` and the differential gates ``cross_check*``, and the theory
certificates of the paper's guarantee. Port of ``repro.core``."""
from .assignment import (  # noqa: F401
    ASSIGN_POLICIES,
    AssignedFlow,
    Assignment,
    FlatAssignState,
    assign_fast,
    assign_random,
    assign_rho_only,
    assign_tau_aware,
    assignment_from_choices,
)
from .batch import ResultTable, SweepRow, row_from_ccts, run_batch  # noqa: F401
from .circuit_scheduler import (  # noqa: F401
    ScheduledFlow,
    schedule_core_list,
    schedule_core_sunflow,
)
from .coflow import (  # noqa: F401
    Coflow,
    Flow,
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
    cross_check,
    cross_check_online,
    run_fast,
    run_fast_metrics,
    run_fast_online,
    schedule_all_cores,
)
from .fabric import (  # noqa: F401
    INCREMENTAL_SCHEDULINGS,
    ComponentIndex,
    FabricState,
    TickCommit,
    cross_check_incremental,
)
from .fault import (  # noqa: F401
    AbortedCircuit,
    CoreDown,
    CoreUp,
    DeltaDrift,
    FaultApplication,
    FaultInjector,
    PortFlap,
)
from .lower_bounds import CoreState, global_lb, per_core_lb  # noqa: F401
from .online import online_orders, run_online  # noqa: F401
from .ordering import order_coflows, priority_scores  # noqa: F401
from .scheduler import (  # noqa: F401
    ALGORITHMS,
    Schedule,
    run,
    scheduled_flows,
    tail_cct,
    tail_quantile,
    weighted_cct,
    weighted_sum,
)
from .simulator import validate  # noqa: F401
from .theory import (  # noqa: F401
    check_lemma1,
    check_lemma2,
    check_lemma3,
    check_theorem1,
    check_theorem2,
    gamma_w,
)
from .trace import (  # noqa: F401
    TraceCoflow,
    arrival_stream,
    load_fb_trace,
    sample_instance,
    sample_online_instance,
    synth_fb_trace,
)
