"""SLO / downtime ledger: turn the recorded event stream into windowed
per-label SLO attainment and an exact accounting of every pause.

The ledger consumes the same Φ_L targets the planner optimizes against
(`CompiledPolicy.slo_targets` — per-label ``(max_ttft_s, max_tpot_s)``)
and scores ``request.complete`` events with EXACTLY the replay harness's
semantics (`repro_torch.traffic.replay`): a request attains its SLO iff its
TTFT is finite and within target (when a TTFT target exists) and its
TPOT, when finite, is within target (a TPOT target never fails on a
non-finite TPOT — single-token requests have no decode interval). That
equivalence is what lets tests cross-check the ledger's attainment
against `ReplayStats.attainment` from the very same run.

Downtime accounting answers "who paid for every pause": migration
pauses (``migration.pause``), swap windows (``cluster.swap``), spawn
and retire windows (``cluster.spawn`` / ``cluster.retire``), and
admission queueing (``request.admit`` queue waits) are each summed and
counted per cause, with per-engine breakdown for the reconfiguration
causes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs.events import Event

SLOTargets = Mapping[str, Tuple[Optional[float], Optional[float]]]


def meets_slo(ttft_s: float, tpot_s: float,
              targets: Tuple[Optional[float], Optional[float]]) -> bool:
    """The replay harness's attainment predicate, verbatim semantics."""
    ok = True
    if targets[0] is not None and not (math.isfinite(ttft_s)
                                       and ttft_s <= targets[0]):
        ok = False
    if targets[1] is not None and math.isfinite(tpot_s) \
            and tpot_s > targets[1]:
        ok = False
    return ok


@dataclasses.dataclass
class WindowAttainment:
    """Per-label attainment over one ledger window."""

    window: int          # window index: floor((ts - t0) / window_s)
    t_end: float         # window end, recording-clock seconds
    label: str
    ok: int
    scored: int

    @property
    def attainment(self) -> float:
        return self.ok / self.scored if self.scored else math.nan


@dataclasses.dataclass
class PauseAccount:
    """Who paid a pause: totals + counts for one cause."""

    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    by_engine: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, seconds: float, engine: str = "") -> None:
        self.total_s += seconds
        self.count += 1
        self.max_s = max(self.max_s, seconds)
        if engine:
            self.by_engine[engine] = self.by_engine.get(engine, 0.0) \
                + seconds

    def as_dict(self) -> Dict[str, object]:
        return {"total_s": self.total_s, "count": self.count,
                "max_s": self.max_s, "by_engine": dict(self.by_engine)}


class SLOLedger:
    """Fold a recorded event stream into attainment + pause accounting.

    Args:
        targets: per-label ``(max_ttft_s, max_tpot_s)``; labels absent
            from the mapping are observed but not scored (mirroring the
            replay harness).
        window_s: attainment window width, recording-clock seconds.
        t0: window epoch; defaults to the first consumed event's
            timestamp.
    """

    #: pause causes the ledger accounts for, in reporting order; a
    #: ``migration.pause`` event with ``reason="handoff"`` (the
    #: disaggregated first-token prefill→decode handoff) is accounted
    #: under "handoff", every other migration pause under "migration" —
    #: the two never double count
    CAUSES = ("migration", "handoff", "swap", "spawn", "retire", "queueing")

    def __init__(self, targets: Optional[SLOTargets] = None,
                 window_s: float = 1.0, t0: Optional[float] = None):
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.targets: Dict[str, Tuple[Optional[float], Optional[float]]] \
            = dict(targets or {})
        self.window_s = float(window_s)
        self.t0 = t0
        self._win: Dict[Tuple[int, str], WindowAttainment] = {}
        self._ok: Dict[str, int] = {}
        self._scored: Dict[str, int] = {}
        self._completed: Dict[str, int] = {}
        # completions by serving role at completion time (disaggregated
        # serving: handoff requests complete on their decode engine)
        self._by_role: Dict[str, int] = {}
        self.pauses: Dict[str, PauseAccount] = {
            c: PauseAccount() for c in self.CAUSES}

    @classmethod
    def from_policy(cls, policy, **kw) -> "SLOLedger":
        """Build a ledger from an intent-compiled policy's Φ_L targets
        (`CompiledPolicy.slo_targets`) — or anything exposing a
        ``slo_targets`` mapping, e.g. a `WorkloadPlanner`."""
        return cls(dict(getattr(policy, "slo_targets", {}) or {}), **kw)

    # -- consumption ---------------------------------------------------
    def consume(self, events: Iterable[Event]) -> "SLOLedger":
        """Fold events (any order-preserving slice of the bus) into the
        ledger; returns self for chaining."""
        for ev in events:
            self.observe(ev)
        return self

    def observe(self, ev: Event) -> None:
        if self.t0 is None:
            self.t0 = ev.ts
        kind = ev.kind
        if kind == "request.complete":
            self._score(ev)
        elif kind == "migration.pause":
            cause = ("handoff" if ev.data.get("reason") == "handoff"
                     else "migration")
            self.pauses[cause].add(float(ev.data.get("pause_s", 0.0)),
                                   ev.engine)
        elif kind == "cluster.swap":
            self.pauses["swap"].add(float(ev.data.get("downtime_s", 0.0)),
                                    ev.engine)
        elif kind == "cluster.spawn":
            self.pauses["spawn"].add(float(ev.data.get("downtime_s", 0.0)),
                                     ev.engine)
        elif kind == "cluster.retire":
            self.pauses["retire"].add(float(ev.data.get("downtime_s", 0.0)),
                                      ev.engine)
        elif kind == "request.admit":
            wait = ev.data.get("queue_wait_s")
            if wait is not None:
                self.pauses["queueing"].add(float(wait), ev.engine)

    def _score(self, ev: Event) -> None:
        label = ev.label or "*"
        self._completed[label] = self._completed.get(label, 0) + 1
        role = str(ev.data.get("role", "unified") or "unified")
        self._by_role[role] = self._by_role.get(role, 0) + 1
        targets = self.targets.get(label)
        if targets is None or (targets[0] is None and targets[1] is None):
            return
        ok = meets_slo(float(ev.data.get("ttft_s", math.inf)),
                       float(ev.data.get("tpot_s", math.nan)), targets)
        self._scored[label] = self._scored.get(label, 0) + 1
        self._ok[label] = self._ok.get(label, 0) + ok
        w = int((ev.ts - self.t0) // self.window_s)
        key = (w, label)
        rec = self._win.get(key)
        if rec is None:
            rec = self._win[key] = WindowAttainment(
                w, self.t0 + (w + 1) * self.window_s, label, 0, 0)
        rec.scored += 1
        rec.ok += ok

    # -- results -------------------------------------------------------
    def attainment(self) -> Dict[str, float]:
        """Aggregate per-label attainment over everything consumed."""
        return {label: self._ok.get(label, 0) / scored
                for label, scored in sorted(self._scored.items()) if scored}

    def attainment_overall(self) -> Optional[float]:
        scored = sum(self._scored.values())
        return sum(self._ok.values()) / scored if scored else None

    def completed(self) -> Dict[str, int]:
        return dict(self._completed)

    def completed_by_role(self) -> Dict[str, int]:
        """Completions by the serving role of the completing engine
        (``"unified"`` unless disaggregated serving is active; a
        handed-off request counts under ``"decode"`` — where it
        finished)."""
        return dict(self._by_role)

    def windows(self, label: Optional[str] = None) -> List[WindowAttainment]:
        """The windowed attainment series, time-ordered."""
        out = sorted(self._win.values(), key=lambda w: (w.window, w.label))
        if label is not None:
            out = [w for w in out if w.label == label]
        return out

    def pause_accounting(self) -> Dict[str, Dict[str, object]]:
        """Every pause, attributed: cause -> totals/counts/per-engine."""
        return {c: self.pauses[c].as_dict() for c in self.CAUSES}

    def as_dict(self) -> Dict[str, object]:
        return {
            "targets": {k: list(v) for k, v in sorted(self.targets.items())},
            "window_s": self.window_s,
            "attainment": self.attainment(),
            "attainment_overall": self.attainment_overall(),
            "completed": self.completed(),
            "completed_by_role": self.completed_by_role(),
            "windows": [dataclasses.asdict(w) for w in self.windows()],
            "pauses": self.pause_accounting(),
        }
