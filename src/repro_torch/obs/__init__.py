"""Flight-recorder observability for the port's serving stack (a copy of
`repro.obs`).

Four pieces behind one handle (`Recorder`):

    events.py   structured event bus — typed `Event`s, timestamped on
                the INSTALLED serving clock (non-advancing reads under
                a `FakeClock`), bounded ring with drop counters;
    trace.py    span tracing + Chrome ``trace_event`` exporter;
    metrics.py  counters / gauges / log-bucketed quantile sketches with
                label sets, plus the `RequestAggregate` that gives
                `ServingCluster.metrics_by_label` O(1) accounting;
    slo.py      SLO/downtime ledger — Φ_L targets + the event stream →
                windowed per-label attainment and an exact "who paid
                this pause" breakdown.

Plus the Watchtower layer on top:

    lineage.py  per-request critical-path attribution — `RequestLineage`
                decomposes measured TTFT/TPOT into named components with
                a conservation check and Chrome flow events;
    alerts.py   `AlertEvaluator` — multi-window SLO burn-rate rules,
                estimator-drift alarms, liveness watchdogs, and
                deterministic debug bundles on every fired alert.

The engine, migration, PREPARE and cluster modules emit the reference's
events (``request.*``, ``engine.decode``, ``migration.pause``,
``ticket.*``, ``cluster.*``). Recording is opt-in and zero-overhead when
off: every hook guards with ``RECORDER is None``::

    from repro_torch.obs import Recorder, recording
    with recording(Recorder()) as rec:
        ...
    rec.export_chrome("run.trace.json")
"""
from repro_torch.obs.alerts import (
    Alert,
    AlertEvaluator,
    BurnRateRule,
    bundle_events,
    load_bundle,
    replay_ledger,
)
from repro_torch.obs.events import (
    Event,
    EventBus,
    Recorder,
    get_recorder,
    install_recorder,
    now,
    recording,
)
from repro_torch.obs.lineage import (
    TPOT_COMPONENTS,
    TTFT_COMPONENTS,
    RequestLineage,
    RequestTimeline,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RequestAggregate,
)
from repro_torch.obs.slo import PauseAccount, SLOLedger, WindowAttainment, meets_slo
from repro_torch.obs.trace import (
    Span,
    TraceBuffer,
    export_chrome,
    overlaps,
    validate_chrome,
)

__all__ = [
    "Alert", "AlertEvaluator", "BurnRateRule", "bundle_events",
    "load_bundle", "replay_ledger",
    "Event", "EventBus", "Recorder", "get_recorder", "install_recorder",
    "now", "recording",
    "RequestLineage", "RequestTimeline",
    "TTFT_COMPONENTS", "TPOT_COMPONENTS",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestAggregate",
    "PauseAccount", "SLOLedger", "WindowAttainment", "meets_slo",
    "Span", "TraceBuffer", "export_chrome", "overlaps", "validate_chrome",
]
