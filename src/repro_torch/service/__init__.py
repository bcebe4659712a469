"""Fabric-manager service of the port: streaming coflow admission,
incremental scheduling over committed circuits, and circuit-program
emission. The port of ``repro.service``:

  - ``admission`` -- bounded request queue, micro-batching, backpressure and
    the overload policy (:class:`AdmissionPolicy`);
  - ``manager`` -- :class:`FabricManager`, the service loop (streaming ticks
    over ``core.fabric.FabricState``, cached one-shot scheduling, and the
    fault plane: :meth:`FabricManager.report_fault`);
  - ``program`` -- :class:`CircuitProgram` establish/teardown artifacts as
    device tensors, self-validating through ``core.simulator.validate``;
  - ``cache`` -- canonical instance hashing + LRU program cache.
"""
from .admission import (  # noqa: F401
    AdmissionPolicy,
    AdmissionQueue,
    ArrivalRequest,
    BackpressureError,
)
from .cache import ProgramCache, instance_key  # noqa: F401
from .manager import (  # noqa: F401
    FabricConfig,
    FabricManager,
    FaultReport,
    TickReport,
)
from .program import (  # noqa: F401
    CircuitEvent,
    CircuitProgram,
    compile_commit,
    compile_schedule,
    merge_programs,
)
