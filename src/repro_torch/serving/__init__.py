"""Serving runtime of the port: the pools, the engine and its lifecycle,
live migration, concurrent PREPARE, the cluster and its clock, and the
elastic control loop (load tracking, scaling policy, autoscaler)."""
from repro_torch.serving.autoscaler import (  # noqa: F401
    Autoscaler,
    ElasticPolicy,
    LoadTracker,
    ScaleDecision,
)
from repro_torch.serving.clock import (  # noqa: F401
    SYSTEM_CLOCK,
    FakeClock,
    SystemClock,
    install_clock,
    installed_clock,
    simulated_time,
)
from repro_torch.serving.cluster import (  # noqa: F401
    DowntimeReport,
    RoutingError,
    ServingCluster,
)
from repro_torch.serving.engine import (  # noqa: F401
    METRIC_KEYS,
    Collective,
    EngineStateError,
    Request,
    ServingEngine,
    compute_metrics,
)
from repro_torch.serving.kvpool import PagedKVPool, PoolOOM  # noqa: F401
from repro_torch.serving.migration import (  # noqa: F401
    MigrationError,
    MigrationRecord,
    SlotSnapshot,
)
from repro_torch.serving.prepare import (  # noqa: F401
    PrepareCancelled,
    PrepareTicket,
    PrepareWorker,
)
