"""Serving runtime of the port: the paged KV pool and the engine."""
from repro_torch.serving.engine import (  # noqa: F401
    METRIC_KEYS,
    EngineStateError,
    Request,
    ServingEngine,
    compute_metrics,
)
from repro_torch.serving.kvpool import PagedKVPool, PoolOOM  # noqa: F401
