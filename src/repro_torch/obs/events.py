"""The flight recorder: structured event bus + span tracing + metrics,
timestamped on the serving layer's installed clock.

Design constraints (the whole point of this module):

  * **Zero overhead when disabled.** The module-level `RECORDER` is
    ``None`` by default; every instrumentation site in the serving
    stack is one attribute read + one ``is None`` test. Nothing is
    allocated, no lock is touched, no clock is read.
  * **Clock-aware, never clock-perturbing.** This module's ``time``
    attribute is swapped by `repro_torch.serving.clock.install_clock` exactly
    like the serving modules' (it is listed in ``CLOCKED_MODULE_NAMES``).
    `now` prefers the installed clock's NON-advancing ``.now`` property,
    so recording an event under a `FakeClock` does not advance simulated
    time — a recorded replay is bitwise-identical to an unrecorded one.
  * **Deterministic ordering.** Simulated timestamps can tie (the
    non-advancing read); every event therefore carries a monotone
    ``seq`` assigned under the bus lock.
  * **Bounded.** The bus is an overwrite-oldest ring with a drop
    counter: a 10^6-request replay cannot OOM the recorder, and the
    drops are themselves observable.
  * **Lifecycle on the rings, steps beside them.** The rings hold the
    request, ticket, cluster and migration events and the lifecycle spans
    lineage and the SLO ledger read. What happens inside a serving step
    (`repro_torch.obs.trace.StepSpan`: admission, prefill, the decode
    step) goes to the engine's ``decode_stats`` and, while
    `torch.profiler` runs, to its trace; of the step, only the strided
    ``engine.decode`` progress event reaches the bus.

Typical use::

    from repro_torch.obs import Recorder, recording

    with recording(Recorder()) as rec:
        ...                                   # run the serving workload
    rec.export_chrome("replay.trace.json")    # open in Perfetto
    rec.bus.events("request.complete")        # structured history
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time  # swapped for the installed clock by install_clock
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Span, TraceBuffer, export_chrome


def now() -> float:
    """Current time on the recording clock, WITHOUT advancing it.

    When a clock object is installed (`FakeClock` / `SystemClock`), its
    ``.now`` property is a non-advancing read; the raw :mod:`time`
    module (the un-swapped default) has no ``now``, so we fall back to
    ``time.time()``.
    """
    t = getattr(time, "now", None)
    return time.time() if t is None else t


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured record on the bus.

    Attributes:
        seq: monotone sequence number (total order even when simulated
            timestamps tie).
        ts: recording-clock timestamp, seconds.
        kind: dotted taxonomy name (``"request.submit"``,
            ``"ticket.ready"``, ``"planner.decision"``, ...); see
            docs/observability.md for the full taxonomy.
        engine: engine name the event concerns ("" when n/a).
        rid: request id (-1 when n/a).
        label: ``data-type`` label value ("" when n/a).
        data: JSON-able payload.
    """

    seq: int
    ts: float
    kind: str
    engine: str = ""
    rid: int = -1
    label: str = ""
    data: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class EventBus:
    """Lock-safe bounded ring of `Event`s (overwrite-oldest, counted)."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[Event]] = [None] * self.capacity
        self._head = 0
        self._count = 0
        self.emitted = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def emit(self, kind: str, *, engine: str = "", rid: int = -1,
             label: str = "", ts: Optional[float] = None,
             **data: Any) -> Event:
        if ts is None:
            ts = now()
        with self._lock:
            ev = Event(self.emitted, ts, kind, engine, rid, label, data)
            if self._count == self.capacity:
                self.dropped += 1
            else:
                self._count += 1
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self.emitted += 1
        return ev

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def events(self, kind: Optional[str] = None,
               engine: Optional[str] = None) -> List[Event]:
        """Oldest-first snapshot; ``kind`` may be an exact name or a
        dotted prefix (``"request"`` matches ``"request.submit"``)."""
        with self._lock:
            start = (self._head - self._count) % self.capacity
            out = [self._buf[(start + i) % self.capacity]
                   for i in range(self._count)]
        if kind is not None:
            out = [e for e in out
                   if e.kind == kind or e.kind.startswith(kind + ".")]
        if engine is not None:
            out = [e for e in out if e.engine == engine]
        return out


class Recorder:
    """Event bus + span trace + metrics registry behind one handle.

    Installed, it also turns on the spans and counters inside the serving
    step (`repro_torch.obs.trace.StepSpan`), which go to the engines'
    ``decode_stats`` and to the profiler's trace, not to this recorder.

    Args:
        capacity: event-bus ring size.
        trace_capacity: span-ring size.
        decode_stride: engines emit an ``engine.decode`` progress event
            every this-many decode steps (1 == every step; bounded
            volume is the default).
    """

    def __init__(self, capacity: int = 65536, trace_capacity: int = 65536,
                 decode_stride: int = 16):
        self.bus = EventBus(capacity)
        self.trace = TraceBuffer(trace_capacity)
        self.metrics = MetricsRegistry()
        self.decode_stride = max(1, int(decode_stride))

    # -- events --------------------------------------------------------
    def emit(self, kind: str, *, engine: str = "", rid: int = -1,
             label: str = "", **data: Any) -> Event:
        """Record one event; a few kinds also fold into the metrics
        registry so counters/sketches stay O(1)-current."""
        ev = self.bus.emit(kind, engine=engine, rid=rid, label=label,
                           **data)
        if kind == "request.complete":
            lbl = label or "*"
            self.metrics.counter("requests_completed", label=lbl).inc()
            ttft = data.get("ttft_s")
            tpot = data.get("tpot_s")
            if ttft is not None:
                self.metrics.histogram("ttft_s", label=lbl).observe(ttft)
            if tpot is not None:
                self.metrics.histogram("tpot_s", label=lbl).observe(tpot)
        elif kind == "request.submit":
            self.metrics.counter("requests_submitted",
                                 label=label or "*").inc()
        elif kind == "request.reject":
            self.metrics.counter("requests_rejected",
                                 label=label or "*").inc()
        elif kind == "request.admit":
            wait = data.get("queue_wait_s")
            if wait is not None:
                self.metrics.histogram("queue_wait_s",
                                       label=label or "*").observe(wait)
        elif kind == "migration.pause":
            pause = data.get("pause_s")
            if pause is not None:
                self.metrics.histogram("migration_pause_s").observe(pause)
        return ev

    def events(self, kind: Optional[str] = None,
               engine: Optional[str] = None) -> List[Event]:
        return self.bus.events(kind, engine)

    # -- spans ---------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", cat: str = "serving",
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Record the body as one span; mutate the yielded dict to add
        result args (they land in the exported trace)."""
        t0 = now()
        try:
            yield args
        finally:
            self.trace.add(Span(name, t0, max(0.0, now() - t0),
                                track, cat, args))

    def span_at(self, name: str, ts: float, dur: float,
                track: str = "main", cat: str = "serving",
                **args: Any) -> None:
        """Record an already-measured interval (e.g. a migration pause
        whose duration is a computed sum, not a wrapped region)."""
        self.trace.add(Span(name, ts, max(0.0, dur), track, cat, args))

    # -- export --------------------------------------------------------
    def export_chrome(self, path: Optional[str] = None,
                      flows: Any = ()) -> Dict[str, Any]:
        """Chrome ``trace_event`` JSON of every recorded span (load in
        Perfetto / chrome://tracing); ``flows`` stitches cross-engine
        request paths (see `export_chrome`)."""
        return export_chrome(self.trace.spans(), path, flows=flows)

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able status dict: metrics + recorder health."""
        return {"metrics": self.metrics.snapshot(),
                "events_emitted": self.bus.emitted,
                "events_dropped": self.bus.dropped,
                "spans_added": self.trace.added,
                "spans_dropped": self.trace.dropped}


#: The process-wide recorder. ``None`` (the default) disables all
#: instrumentation — sites guard with ``rec = RECORDER`` + ``is None``.
RECORDER: Optional[Recorder] = None


def install_recorder(rec: Optional[Recorder]) -> Callable[[], None]:
    """Install ``rec`` as the process recorder; returns a zero-argument
    restore callable (call in a ``finally``; `recording` wraps this)."""
    global RECORDER
    previous = RECORDER
    RECORDER = rec

    def restore() -> None:
        global RECORDER
        RECORDER = previous

    return restore


def get_recorder() -> Optional[Recorder]:
    """The installed recorder, or None when recording is disabled."""
    return RECORDER


@contextlib.contextmanager
def recording(rec: Optional[Recorder] = None) -> Iterator[Recorder]:
    """Enable recording for the body; restores the previous recorder on
    exit.

    >>> with recording() as rec:
    ...     ...                       # serve
    >>> rec.bus.emitted >= 0
    True
    """
    rec = rec if rec is not None else Recorder()
    restore = install_recorder(rec)
    try:
        yield rec
    finally:
        restore()
