"""Span tracing for the flight recorder: bounded span storage plus a
Chrome ``trace_event`` JSON exporter.

Spans are closed intervals on the *recording clock* (the clock installed
into the serving layer — see `repro_torch.serving.clock.install_clock`; the
recorder reads it non-advancing, so tracing never perturbs a simulated
run). A span belongs to a ``track`` — an engine name or a subsystem like
``"cluster"`` / ``"planner"`` — which the exporter maps onto Chrome
``tid`` lanes, so a Perfetto timeline shows one row per engine with the
swap windows, migration pauses, and routing decisions nested on it.

The export format is the Chrome ``trace_event`` "JSON object format":
phase-``"X"`` (complete) events with microsecond ``ts``/``dur``, plus
``"M"`` metadata events naming each track. Both chrome://tracing and
https://ui.perfetto.dev load it directly.

`StepSpan` is the other kind: a span inside a serving step, which times
its body into an engine's stats dict and, while `torch.profiler` runs,
names it in the profiler's trace, but never enters a `TraceBuffer`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

# `events` imports this module for `Span`; the package imports `events`
# first, so this import finds it in place
from repro_torch.obs import events as obs_events


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval on the recording clock.

    Attributes:
        name: what happened (``"route"``, ``"swap.commit"``, ...).
        ts: start time, seconds on the recording clock.
        dur: duration, seconds (>= 0; zero-width spans are legal under a
            non-advancing simulated clock).
        track: exporter lane — engine name or subsystem.
        cat: Chrome category string (filterable in Perfetto).
        args: JSON-able payload shown in the Perfetto detail pane.
    """

    name: str
    ts: float
    dur: float
    track: str = "main"
    cat: str = "serving"
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


def overlaps(a: Span, b: Span) -> bool:
    """Strict interval overlap (exclusive bounds): touching endpoints —
    and zero-width spans sitting exactly on a boundary — do NOT count.
    This is the predicate the no-route-during-swap invariant is checked
    with: two spans serialized by the same lock may share an endpoint
    but can never strictly interleave."""
    return a.ts < b.end and b.ts < a.end


class TraceBuffer:
    """Lock-safe bounded span store: overwrite-oldest ring with a drop
    counter, same retention policy as the event bus."""

    def __init__(self, capacity: int = 65536):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._head = 0          # next write slot
        self._count = 0
        self.added = 0
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if self._count == self.capacity:
                self.dropped += 1
            else:
                self._count += 1
            self._buf[self._head] = span
            self._head = (self._head + 1) % self.capacity
            self.added += 1

    def __len__(self) -> int:
        with self._lock:
            return self._count

    def spans(self, name: Optional[str] = None,
              track: Optional[str] = None) -> List[Span]:
        """Oldest-first snapshot, optionally filtered by name/track."""
        with self._lock:
            start = (self._head - self._count) % self.capacity
            out = [self._buf[(start + i) % self.capacity]
                   for i in range(self._count)]
        return [s for s in out
                if (name is None or s.name == name)
                and (track is None or s.track == track)]


def export_chrome(spans: Sequence[Span],
                  path: Optional[str] = None,
                  flows: Sequence[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """Render spans as a Chrome ``trace_event`` JSON document.

    Tracks are assigned ``tid``s in sorted-name order (deterministic:
    two identical replays export byte-identical traces) and labeled via
    ``thread_name`` metadata events so Perfetto shows readable lanes.

    Args:
        spans: the spans to export (any order; emitted as-is).
        path: when given, the document is also written there.
        flows: flow-event specs — dicts with ``name``, ``id``, ``ph``
            (``"s"`` start / ``"f"`` finish), ``track``, ``ts``
            (seconds); Perfetto draws them as arrows between lanes (a
            request's cross-engine handoff/migration path).

    Returns:
        The trace document (``{"traceEvents": [...], ...}``).
    """
    tracks = {s.track for s in spans} | {f["track"] for f in flows}
    tids = {t: i + 1 for i, t in enumerate(sorted(tracks))}
    events: List[Dict[str, Any]] = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
         "args": {"name": track}}
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1])]
    for s in spans:
        events.append({"name": s.name, "cat": s.cat, "ph": "X",
                       "ts": s.ts * 1e6, "dur": s.dur * 1e6,
                       "pid": 1, "tid": tids[s.track],
                       "args": dict(s.args)})
    for f in flows:
        ev = {"name": f["name"], "cat": "flow", "ph": f["ph"],
              "id": int(f["id"]), "ts": float(f["ts"]) * 1e6,
              "pid": 1, "tid": tids[f["track"]]}
        if f["ph"] == "f":
            ev["bp"] = "e"     # bind to the enclosing slice's end
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return doc


def validate_chrome(doc: Dict[str, Any]) -> int:
    """Validate a trace document against the ``trace_event`` contract
    Perfetto actually enforces; returns the number of ``"X"`` events.

    Raises:
        ValueError: missing keys, non-numeric ts/dur, or negative dur.
    """
    if "traceEvents" not in doc:
        raise ValueError("trace document lacks 'traceEvents'")
    n = 0
    for ev in doc["traceEvents"]:
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"trace event missing {key!r}: {ev}")
        if ev["ph"] == "X":
            n += 1
            if not isinstance(ev.get("ts"), (int, float)) \
                    or not isinstance(ev.get("dur"), (int, float)):
                raise ValueError(f"complete event needs numeric ts/dur: {ev}")
            if ev["dur"] < 0:
                raise ValueError(f"negative duration: {ev}")
        elif ev["ph"] in ("s", "t", "f"):
            if "id" not in ev:
                raise ValueError(f"flow event missing 'id': {ev}")
            if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
                raise ValueError(f"flow event needs numeric ts: {ev}")
    return n


# ---------------------------------------------------------------------------
# spans inside the serving step
# ---------------------------------------------------------------------------

#: what a step-span site enters with no recorder installed: the shared
#: null context, so the site allocates nothing and reads no clock
NO_SPAN = contextlib.nullcontext()


class StepSpan:
    """One span inside a serving step, entered only where a recorder is
    installed (sites write ``NO_SPAN if rec is None else StepSpan(...)``).

    It never enters the recorder's span ring: that ring keeps the lifecycle
    spans (``route``, ``swap.commit``, ``migration.pause``) that lineage and
    the SLO ledger read, which a span per step would evict. Instead:

    - with ``stats`` given, the body is timed on the recording clock (the
      non-advancing `events.now`, never the serving modules' advancing
      ``time.time()``) and its seconds added to ``stats[key + "_s"]``, one
      to ``stats[key + "_spans"]``;
    - while `torch.profiler` is on, the body is a ``record_function`` of the
      same name, so it lies in the device trace on the profiler's own clock
      and names the device's idle gaps across it.
    """

    __slots__ = ("name", "stats", "key_s", "key_n", "_rf", "_t0")

    def __init__(self, name: str, stats: Optional[Dict[str, Any]] = None,
                 key: str = ""):
        self.name = name
        self.stats = stats
        self.key_s, self.key_n = key + "_s", key + "_spans"
        self._rf = None
        self._t0 = 0.0

    def __enter__(self) -> "StepSpan":
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.stats is not None:
            self._t0 = obs_events.now()
        return self

    def __exit__(self, *exc) -> None:
        if self.stats is not None:
            self.stats[self.key_s] += max(0.0, obs_events.now() - self._t0)
            self.stats[self.key_n] += 1
        if self._rf is not None:
            self._rf.__exit__(*exc)
