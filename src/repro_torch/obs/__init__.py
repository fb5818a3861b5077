"""Flight-recorder observability for the port's serving stack (a copy of
`repro.obs`'s event bus, span trace and metrics registry).

    events.py   structured event bus — typed `Event`s, timestamped on
                the INSTALLED serving clock (non-advancing reads under
                a `FakeClock`), bounded ring with drop counters;
    trace.py    span tracing + Chrome ``trace_event`` exporter;
    metrics.py  counters / gauges / log-bucketed quantile sketches with
                label sets, plus the `RequestAggregate` that gives
                `ServingCluster.metrics_by_label` O(1) accounting.

The engine, migration, PREPARE and cluster modules emit the reference's
events (``request.*``, ``engine.decode``, ``migration.pause``,
``ticket.*``, ``cluster.*``). Recording is opt-in and zero-overhead when
off: every hook guards with ``RECORDER is None``::

    from repro_torch.obs import Recorder, recording
    with recording(Recorder()) as rec:
        ...
    rec.export_chrome("run.trace.json")
"""
from repro_torch.obs.events import (
    Event,
    EventBus,
    Recorder,
    get_recorder,
    install_recorder,
    now,
    recording,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RequestAggregate,
)
from repro_torch.obs.trace import (
    Span,
    TraceBuffer,
    export_chrome,
    overlaps,
    validate_chrome,
)

__all__ = [
    "Event", "EventBus", "Recorder", "get_recorder", "install_recorder",
    "now", "recording",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestAggregate",
    "Span", "TraceBuffer", "export_chrome", "overlaps", "validate_chrome",
]
