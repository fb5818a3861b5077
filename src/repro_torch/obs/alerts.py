"""Watchtower alerting: SLO burn-rate rules, estimator-drift alarms,
liveness watchdogs, and auto-captured debug bundles.

`AlertEvaluator` polls the flight recorder's event bus incrementally
(by ``seq``, so re-polls never double count), folds completions into its
own `SLOLedger`, and evaluates:

  * **SLO burn rate** — the multi-window rule: the per-label error rate
    over a short AND a long trailing window must BOTH exceed
    ``factor x (1 - goal)`` before paging. The short window makes the
    alert reset fast when the incident ends; the long window keeps a
    brief blip from paging.
  * **Estimator drift** — the measured/calibrated-predicted TTFT/TPOT
    ratio leaves `ResidualCalibration`'s clipped band
    ``[1/ratio_cap, ratio_cap]`` after the calibrator has warmed up
    (fail-closed cold start: no observations, no alarm — matching the
    calibrator's own cold-start contract).
  * **Watchdogs** — event-bus/trace-ring drops (attribution corruption),
    PREPARE tickets stuck outside a terminal state, and starved labels
    (pending submissions with no admission progress).

Every fired alert optionally captures a **debug bundle** — one
deterministic JSON file with the events, spans, metrics, SLO ledger,
and planner state at detection time (`capture_bundle` / `load_bundle` /
`replay_ledger` round-trip). Alerts with a label feed
`WorkloadPlanner.mandatory_fix` / `Autoscaler.mandatory_fix` so
detection closes the loop into reconfiguration instead of waiting out
hysteresis.

Discipline: this module's ``time`` attribute is swapped by
`repro_torch.serving.clock.install_clock` (it is listed in
``CLOCKED_MODULE_NAMES``) and every read is NON-advancing — an
evaluated replay stays bit-identical to an unevaluated one. The
evaluator itself is fail-closed: a crashing rule fires a
``watchtower.error`` alert rather than silently going blind.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time  # swapped for the installed clock by install_clock
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.events import Event, Recorder
from repro_torch.obs.slo import SLOLedger, SLOTargets


def _now() -> float:
    """Non-advancing read of the recording clock (see
    `repro_torch.obs.events.now`)."""
    t = getattr(time, "now", None)
    return time.time() if t is None else t


@dataclasses.dataclass(frozen=True)
class Alert:
    """One fired alert.

    Attributes:
        name: taxonomy name (``"slo.burn_rate"``, ``"estimator.drift"``,
            ``"obs.drops"``, ``"prepare.stuck"``, ``"label.starved"``,
            ``"watchtower.error"``).
        severity: ``"page"`` (SLO at risk / evaluator broken) or
            ``"warn"`` (degraded observability or liveness).
        label / engine: scope ("" when n/a).
        t: detection time, recording-clock seconds.
        value: the measurement that tripped the rule.
        threshold: the rule's trip point.
        message: human-readable summary.
        bundle: debug-bundle path ("" when capture is disabled).
    """

    name: str
    severity: str
    label: str = ""
    engine: str = ""
    t: float = 0.0
    value: float = 0.0
    threshold: float = 0.0
    message: str = ""
    bundle: str = ""


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Multi-window SLO burn-rate rule (per label).

    ``burn = error_rate / (1 - goal)``; pages when the burn over BOTH
    trailing windows exceeds ``factor``. With the defaults a label must
    be missing its SLO >4x faster than its error budget allows, for
    long enough to fill the long window's evidence.
    """

    goal: float = 0.9
    short_s: float = 2.0
    long_s: float = 8.0
    factor: float = 4.0

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.goal)


def _jsonable(obj: Any) -> Any:
    """Recursively make ``obj`` JSON-safe: non-finite floats -> None,
    mappings key-sorted (byte-deterministic bundles)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class AlertEvaluator:
    """Detection loop over a live `Recorder`.

    Args:
        recorder: the flight recorder to watch.
        slo_targets: per-label ``(max_ttft_s, max_tpot_s)`` for the
            internal ledger (or pass ``policy`` with a ``slo_targets``
            attribute).
        window_s: ledger window width (burn windows are multiples).
        burn: the burn-rate rule (None disables SLO burn alerts).
        calibration: the planner's `ResidualCalibration`; enables drift
            alarms (band defaults to its ``ratio_cap``).
        drift_band: override the drift band factor (> 1).
        drift_min_obs: calibration observations per label before drift
            can alarm (fail-closed cold start).
        stuck_prepare_s: seconds a PREPARE ticket may stay non-terminal.
        starve_s: seconds a label may have pending submissions with no
            admission/rejection progress.
        planner / scaler: mandatory-fix targets (optional).
        bundle_dir: when set, every fired alert writes a debug bundle
            here (created on first capture).
    """

    def __init__(self, recorder: Recorder, *,
                 slo_targets: Optional[SLOTargets] = None,
                 policy: Any = None,
                 window_s: float = 1.0,
                 burn: Optional[BurnRateRule] = BurnRateRule(),
                 calibration: Any = None,
                 drift_band: Optional[float] = None,
                 drift_min_obs: int = 3,
                 stuck_prepare_s: float = 10.0,
                 starve_s: float = 10.0,
                 planner: Any = None,
                 scaler: Any = None,
                 bundle_dir: Optional[str] = None):
        if slo_targets is None and policy is not None:
            slo_targets = dict(getattr(policy, "slo_targets", {}) or {})
        self.recorder = recorder
        self.ledger = SLOLedger(slo_targets, window_s=window_s)
        self.burn = burn
        self.calibration = calibration
        if drift_band is None:
            drift_band = float(getattr(calibration, "ratio_cap", 8.0))
        if drift_band <= 1.0:
            raise ValueError(f"drift_band must exceed 1, got {drift_band}")
        self.drift_band = drift_band
        self.drift_min_obs = int(drift_min_obs)
        self.stuck_prepare_s = float(stuck_prepare_s)
        self.starve_s = float(starve_s)
        self.planner = planner
        self.scaler = scaler
        self.bundle_dir = bundle_dir
        self.alerts: List[Alert] = []
        self._next_seq = 0
        #: conditions currently true — an alert fires once per onset
        self._firing: Dict[Tuple[str, str, str], Alert] = {}
        # watchdog state
        self._open_tickets: Dict[str, float] = {}    # engine -> since ts
        self._pending: Dict[str, int] = {}           # label -> waiting
        self._progress_ts: Dict[str, float] = {}     # label -> anchor ts

    # -- ingestion -----------------------------------------------------
    def _ingest(self) -> None:
        for ev in self.recorder.events():
            if ev.seq < self._next_seq:
                continue
            self._next_seq = ev.seq + 1
            self.ledger.observe(ev)
            kind = ev.kind
            if kind == "ticket.preparing":
                self._open_tickets.setdefault(ev.engine, ev.ts)
            elif kind in ("ticket.swapped", "ticket.cancelled",
                          "ticket.failed"):
                self._open_tickets.pop(ev.engine, None)
            elif kind == "request.submit":
                lbl = ev.label or "*"
                if self._pending.get(lbl, 0) == 0:
                    self._progress_ts[lbl] = ev.ts
                self._pending[lbl] = self._pending.get(lbl, 0) + 1
            elif kind in ("request.admit", "request.reject"):
                lbl = ev.label or "*"
                self._pending[lbl] = max(0, self._pending.get(lbl, 0) - 1)
                self._progress_ts[lbl] = ev.ts

    # -- rule evaluation ----------------------------------------------
    def poll(self, t: Optional[float] = None) -> List[Alert]:
        """Ingest new events and evaluate every rule; returns the alerts
        that fired THIS poll (all fired alerts stay in ``self.alerts``).
        Call on the control-tick cadence (the replay harness does)."""
        t = _now() if t is None else float(t)
        fired: List[Alert] = []
        active: Dict[Tuple[str, str, str], Alert] = {}
        try:
            self._ingest()
        except Exception as exc:               # fail closed, loudly
            self._error(active, t, "ingest", exc)
        for check in (self._check_burn, self._check_drops,
                      self._check_stuck_prepare, self._check_starved):
            try:
                check(active, t)
            except Exception as exc:           # fail closed, loudly
                self._error(active, t, check.__name__, exc)
        for key, alert in active.items():
            if key not in self._firing:
                fired.append(self._fire(alert))
        # conditions that cleared may fire again at their next onset;
        # drift alarms are edge-triggered in observe_prediction and
        # clear themselves there
        self._firing = {**{k: v for k, v in self._firing.items()
                           if k[0] == "estimator.drift"}, **active}
        return fired

    def _error(self, active: Dict[Tuple[str, str, str], Alert],
               t: float, where: str, exc: Exception) -> None:
        active[("watchtower.error", where, "")] = Alert(
            "watchtower.error", "page", label=where, t=t,
            message=f"{where}: {exc!r}")

    def _check_burn(self, active: Dict[Tuple[str, str, str], Alert],
                    t: float) -> None:
        if self.burn is None:
            return
        for label in sorted(self.ledger.targets):
            short = self._burn_over(label, t, self.burn.short_s)
            long_ = self._burn_over(label, t, self.burn.long_s)
            if short is None or long_ is None:
                continue
            if short > self.burn.factor and long_ > self.burn.factor:
                active[("slo.burn_rate", label, "")] = Alert(
                    "slo.burn_rate", "page", label=label, t=t,
                    value=min(short, long_), threshold=self.burn.factor,
                    message=(f"{label}: burn {short:.1f}x/"
                             f"{long_:.1f}x budget over "
                             f"{self.burn.short_s:g}s/"
                             f"{self.burn.long_s:g}s windows"))

    def _burn_over(self, label: str, t: float,
                   span_s: float) -> Optional[float]:
        """Error-budget burn multiple over the trailing ``span_s``
        seconds; None when the window scored nothing (no evidence —
        absence of traffic is not an SLO violation)."""
        ok = scored = 0
        for w in self.ledger.windows(label):
            if w.t_end > t - span_s:
                ok += w.ok
                scored += w.scored
        if scored == 0:
            return None
        return ((scored - ok) / scored) / self.burn.budget

    def _check_drops(self, active: Dict[Tuple[str, str, str], Alert],
                     t: float) -> None:
        bus, trace = self.recorder.bus, self.recorder.trace
        dropped = bus.dropped + trace.dropped
        if dropped > 0:
            active[("obs.drops", "", "")] = Alert(
                "obs.drops", "warn", t=t, value=float(dropped),
                threshold=0.0,
                message=(f"recorder dropped {bus.dropped} events + "
                         f"{trace.dropped} spans — attribution and "
                         "ledger windows are no longer complete"))

    def _check_stuck_prepare(self, active: Dict[Tuple[str, str, str], Alert],
                             t: float) -> None:
        for engine in sorted(self._open_tickets):
            age = t - self._open_tickets[engine]
            if age > self.stuck_prepare_s:
                active[("prepare.stuck", "", engine)] = Alert(
                    "prepare.stuck", "warn", engine=engine, t=t,
                    value=age, threshold=self.stuck_prepare_s,
                    message=(f"{engine}: PREPARE ticket non-terminal for "
                             f"{age:.1f}s"))

    def _check_starved(self, active: Dict[Tuple[str, str, str], Alert],
                       t: float) -> None:
        for label in sorted(self._pending):
            if self._pending[label] <= 0:
                continue
            age = t - self._progress_ts.get(label, t)
            if age > self.starve_s:
                active[("label.starved", label, "")] = Alert(
                    "label.starved", "page", label=label, t=t,
                    value=age, threshold=self.starve_s,
                    message=(f"{label}: {self._pending[label]} requests "
                             f"waiting, no admission progress for "
                             f"{age:.1f}s"))

    # -- estimator drift (event-driven: fed by the measurement loop) ---
    def observe_prediction(self, label: str, *,
                           predicted_ttft_s: float,
                           predicted_tpot_s: float,
                           measured_ttft_s: float,
                           measured_tpot_s: float,
                           t: Optional[float] = None) -> Optional[Alert]:
        """Feed one calibrated-prediction/measurement pair (the replay
        harness calls this from its measurement window). Fires
        ``estimator.drift`` when a measured/predicted ratio leaves the
        clipped band — but only after calibration warm-up."""
        t = _now() if t is None else float(t)
        try:
            if self.calibration is not None and \
                    self.calibration.n_observations(label) \
                    < self.drift_min_obs:
                return None            # fail-closed cold start
            worst = 0.0
            for pred, meas in ((predicted_ttft_s, measured_ttft_s),
                               (predicted_tpot_s, measured_tpot_s)):
                if pred is None or meas is None:
                    continue
                if not (math.isfinite(pred) and math.isfinite(meas)) \
                        or pred <= 0 or meas <= 0:
                    continue
                ratio = meas / pred
                worst = max(worst, ratio, 1.0 / ratio)
            key = ("estimator.drift", label, "")
            if worst > self.drift_band:
                if key in self._firing:
                    return None        # still in the same excursion
                alert = Alert(
                    "estimator.drift", "page", label=label, t=t,
                    value=worst, threshold=self.drift_band,
                    message=(f"{label}: measured/predicted ratio "
                             f"{worst:.2f} outside the calibration band "
                             f"[1/{self.drift_band:g}, "
                             f"{self.drift_band:g}]"))
                self._firing[key] = alert
                return self._fire(alert)
            self._firing.pop(key, None)
            return None
        except Exception as exc:       # fail closed, loudly
            active: Dict[Tuple[str, str, str], Alert] = {}
            self._error(active, t, "observe_prediction", exc)
            (key, alert), = active.items()
            if key not in self._firing:
                self._firing[key] = alert
                return self._fire(alert)
            return None

    # -- firing / bundles / mandatory fixes ----------------------------
    def _fire(self, alert: Alert) -> Alert:
        if self.bundle_dir:
            try:
                path = self.capture_bundle(alert)
                alert = dataclasses.replace(alert, bundle=path)
            except Exception as exc:
                alert = dataclasses.replace(
                    alert, message=alert.message
                    + f" [bundle capture failed: {exc!r}]")
        self.alerts.append(alert)
        if alert.label and alert.name in ("slo.burn_rate",
                                          "estimator.drift",
                                          "label.starved"):
            for target in (self.planner, self.scaler):
                if target is None:
                    continue
                try:
                    target.mandatory_fix(alert.label, reason=alert.name)
                except Exception:
                    pass               # detection must outlive actuation
        return alert

    def planner_state(self) -> Dict[str, Any]:
        """JSON-able snapshot of the planner's decision inputs."""
        p = self.planner
        if p is None:
            return {}
        state: Dict[str, Any] = {
            "slo_targets": {k: list(v) for k, v in
                            sorted(getattr(p, "slo_targets", {}).items())},
            "bounds": {k: list(v) for k, v in
                       sorted(getattr(p, "bounds", {}).items())},
        }
        cal = getattr(p, "calibration", None)
        if cal is not None:
            labels = sorted(set(state["slo_targets"])
                            | set(self.ledger.completed()))
            state["calibration"] = {
                lb: {"factors": list(cal.factors(lb)),
                     "n_observations": cal.n_observations(lb)}
                for lb in labels}
        return state

    def capture_bundle(self, alert: Alert,
                       path: Optional[str] = None) -> str:
        """Write one deterministic debug bundle; returns its path.

        The bundle is everything needed to re-derive the detection
        offline: the event stream, the span trace, the metrics
        snapshot, the live ledger's accounting, and the planner state —
        key-sorted JSON with non-finite floats nulled, so two identical
        FakeClock runs produce byte-identical bundles.
        """
        if path is None:
            if not self.bundle_dir:
                raise ValueError("no bundle_dir configured and no path "
                                 "given")
            os.makedirs(self.bundle_dir, exist_ok=True)
            stem = alert.name.replace(".", "-")
            if alert.label:
                stem += f"_{alert.label}"
            if alert.engine:
                stem += f"_{alert.engine}"
            path = os.path.join(
                self.bundle_dir, f"{len(self.alerts):04d}_{stem}.json")
        rec = self.recorder
        bundle = {
            "format": "watchtower-bundle/v1",
            "alert": dataclasses.asdict(alert),
            "events": [dataclasses.asdict(e) for e in rec.events()],
            "spans": [dataclasses.asdict(s) for s in rec.trace.spans()],
            "metrics": rec.snapshot(),
            "slo": self.ledger.as_dict(),
            "planner": self.planner_state(),
        }
        with open(path, "w") as f:
            json.dump(_jsonable(bundle), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def as_dicts(self) -> List[Dict[str, Any]]:
        return [dataclasses.asdict(a) for a in self.alerts]


# -- bundle round-trip -------------------------------------------------
def load_bundle(path: str) -> Dict[str, Any]:
    """Load a debug bundle written by `AlertEvaluator.capture_bundle`."""
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("format") != "watchtower-bundle/v1":
        raise ValueError(f"{path}: not a watchtower debug bundle")
    return bundle


def bundle_events(bundle: Mapping[str, Any]) -> List[Event]:
    """Reconstruct the `Event` stream stored in a bundle."""
    return [Event(seq=int(e["seq"]), ts=float(e["ts"]), kind=e["kind"],
                  engine=e.get("engine", ""), rid=int(e.get("rid", -1)),
                  label=e.get("label", ""), data=dict(e.get("data", {})))
            for e in bundle["events"]]


def replay_ledger(bundle: Mapping[str, Any]) -> SLOLedger:
    """Re-derive an `SLOLedger` from a bundle's event stream with the
    bundled targets/window — the round-trip check: its attainment must
    match the bundle's live ``slo`` section."""
    slo = bundle["slo"]
    targets = {k: (v[0], v[1]) for k, v in slo["targets"].items()}
    ledger = SLOLedger(targets, window_s=float(slo["window_s"]))
    ledger.consume(bundle_events(bundle))
    return ledger
