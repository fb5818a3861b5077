"""Discrete-event replay: drive the port's full serving stack over a
generated trace on a simulated clock (the port of `repro.traffic.replay`).

The harness owns a virtual-time cursor ``t`` and advances the installed
`FakeClock` (see `repro_torch.serving.clock`) in lockstep:

  * each ``cluster.step()`` costs ``step_time_s`` simulated seconds —
    the service-rate model; engines decode in parallel, so one step
    boundary is one step duration regardless of engine count (more
    engines == more slots per step == more throughput, exactly the
    roofline's pooling assumption);
  * arrivals are submitted at their trace timestamps, between steps;
  * idle gaps (no queued or resident work anywhere) are JUMPED, not
    slept — wall-clock never gates scale;
  * the autoscaler ticks every ``tick_s`` of simulated time, and every
    ``window_ticks`` ticks the harness drains completions
    (`ServingCluster.drain_completed` — O(window), not O(history)),
    folds windowed TTFT/TPOT into the planner's `ResidualCalibration`
    (planner mode), and records the predicted-vs-measured pair — the
    one-step-ahead evaluation `ReplayStats.prediction_error` scores;
  * calibration learns from QUASI-STEADY windows only: when the queued
    backlog exceeded ``steady_backlog`` times the pooled slot capacity
    at any control tick of the window (or the previous one — early
    completions can be stragglers of the prior transient), the window's
    latency reflects a queueing transient the roofline already models
    through rho — folding its ratio (which clips at ``ratio_cap``)
    would poison the stationary residual and corrupt every later
    prediction. The window is still SCORED — gating affects learning,
    never the evaluation.

TTFT/TPOT/SLO attainment are therefore *simulated-time* quantities,
fully determined by (trace, step_time_s, policy) — deterministic under a
fixed seed, independent of host speed. Use sync spawns
(``Autoscaler(async_spawn=False)``, the default): an async PREPARE
commits at a wall-dependent step boundary, which would leak wall time
back into the simulation.

The port's serving modules read the installed clock exactly as often, and
in the same order, as the reference's (a decode-graph capture is timed on
the wall clock), so one trace replayed through both packages on the same
weights, profile and step features gives the same stamps, decisions and
window records.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.serving.cluster import RoutingError, ServingCluster
from repro_torch.serving.engine import METRIC_KEYS, Request
from repro_torch.traffic.generator import TraceRequest

SLOTargets = Mapping[str, Tuple[Optional[float], Optional[float]]]


@dataclasses.dataclass
class WindowRecord:
    """One measurement window's per-label predicted-vs-measured pair.

    ``predicted_*`` is the raw analytical roofline for the label's
    deployed configuration; ``calibrated_*`` is the same estimate with
    the residual factors learned from PREVIOUS windows (one-step-ahead:
    the window's own measurement is folded only after the prediction is
    recorded). None where no planner/calibration/deployment applies.
    """

    t: float
    label: str
    completed: int
    measured_ttft_s: float
    measured_tpot_s: float
    predicted_ttft_s: Optional[float] = None
    predicted_tpot_s: Optional[float] = None
    calibrated_ttft_s: Optional[float] = None
    calibrated_tpot_s: Optional[float] = None


@dataclasses.dataclass
class ReplayStats:
    """What a replay produced (all times simulated seconds)."""

    n_requests: int
    submitted: int
    completed: int
    dropped: int
    duration_s: float
    steps: int
    engine_seconds: float
    peak_engines: int
    final_engines: int
    per_label: Dict[str, Dict[str, float]]
    attainment: Dict[str, float]
    attainment_overall: Optional[float]
    windows: List[WindowRecord]
    downtime_max_s: float
    reports: int
    reports_finalized: bool

    def prediction_error(self) -> Dict[str, Optional[float]]:
        """Mean |relative error| of predicted vs measured TTFT/TPOT over
        the windows where BOTH the analytical and the calibrated
        estimator produced a prediction. ``*_mare`` is averaged over
        TTFT and TPOT errors jointly; None when no such window exists
        (e.g. threshold mode — no planner, nothing predicted)."""
        analytical: List[float] = []
        calibrated: List[float] = []
        for w in self.windows:
            for pred_a, pred_c, meas in (
                    (w.predicted_ttft_s, w.calibrated_ttft_s,
                     w.measured_ttft_s),
                    (w.predicted_tpot_s, w.calibrated_tpot_s,
                     w.measured_tpot_s)):
                if pred_a is None or pred_c is None:
                    continue
                if not (math.isfinite(pred_a) and math.isfinite(pred_c)
                        and math.isfinite(meas) and meas > 0):
                    continue
                analytical.append(abs(pred_a - meas) / meas)
                calibrated.append(abs(pred_c - meas) / meas)
        if not analytical:
            return {"analytical_mare": None, "calibrated_mare": None,
                    "windows_scored": 0}
        return {"analytical_mare": float(np.mean(analytical)),
                "calibrated_mare": float(np.mean(calibrated)),
                "windows_scored": len(analytical)}


def _has_work(cluster: ServingCluster) -> bool:
    for name in cluster.engines():
        try:
            eng = cluster.engine(name)
        except KeyError:
            continue
        if eng.paused:
            continue
        if eng.queue or any(r is not None for r in eng.slot_req):
            return True
    return False


def _backlog_and_slots(cluster: ServingCluster) -> Tuple[int, int]:
    """(queued requests, pooled slot capacity) across live engines."""
    backlog = slots = 0
    for name in cluster.engines():
        try:
            eng = cluster.engine(name)
        except KeyError:
            continue
        backlog += len(eng.queue)
        slots += len(eng.slot_req)
    return backlog, slots


class _LabelStats:
    """Streaming per-label accumulators (TTFT list kept for p99)."""

    __slots__ = ("ttft", "tpot", "ok", "scored")

    def __init__(self):
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.ok = 0
        self.scored = 0


def replay_trace(trace: List[TraceRequest], cluster: ServingCluster,
                 scaler, clock, *,
                 vocab_size: int,
                 step_time_s: float,
                 tick_s: float = 1.0,
                 window_ticks: int = 20,
                 slo_targets: Optional[SLOTargets] = None,
                 steady_backlog: float = 1.0,
                 seed: int = 0,
                 max_steps: Optional[int] = None,
                 alert_evaluator=None,
                 step_time_fn=None) -> ReplayStats:
    """Replay ``trace`` through ``cluster``/``scaler`` on ``clock``.

    Args:
        trace: the generated trace (monotone arrival times).
        cluster: the serving cluster (capacity is grown/shrunk by the
            scaler; the cluster may start empty if the scaler's bounds
            or planner will spawn a first engine).
        scaler: an `Autoscaler` (threshold or planner mode) driving the
            cluster; its ``tick(dt=tick_s)`` runs every simulated
            ``tick_s``.
        clock: the INSTALLED simulated clock (`FakeClock`) — the
            harness advances it so every request/downtime stamp lands
            in simulated time. It must already be installed into the
            serving layer (`install_clock` / `simulated_time`).
        vocab_size: prompt tokens are drawn uniformly from
            ``[2, vocab_size)``.
        step_time_s: simulated duration of one ``cluster.step()``.
        tick_s: autoscaler control-loop period, simulated seconds.
        window_ticks: ticks per measurement window (drain + calibrate).
        slo_targets: per-label ``(max_ttft_s, max_tpot_s)`` attainment
            targets; defaults to the planner's targets when the scaler
            runs planner mode.
        steady_backlog: calibration steadiness gate — a window's
            measurement is folded into the planner's calibration only
            when the queued backlog stayed at or below this multiple of
            the pooled slot capacity at EVERY control tick of the
            window AND of the previous window (completions early in a
            window can be stragglers whose TTFT carries the previous
            window's queueing transient; sampling every tick catches
            transients that drain before a window boundary, e.g. the
            cold-start ramp before the first scale-out). Saturated
            windows are still scored, just not learned from: a
            transient's (clipped) ratio would corrupt the stationary
            residual for every later prediction.
        seed: PRNG seed for prompt-token materialization.
        max_steps: decode-step budget (a wedged replay raises instead
            of spinning); default scales with the trace.
        alert_evaluator: optional `repro_torch.obs.alerts.AlertEvaluator` —
            polled at every control tick and fed each measurement
            window's calibrated-prediction/measurement pair (the
            estimator-drift signal). Purely observational: under a
            FakeClock an evaluated replay is bit-identical to an
            unevaluated one.
        step_time_fn: optional ``t -> seconds`` override of
            ``step_time_s`` (degradation injection: a slowed engine is
            a step that starts taking longer at some simulated time).

    Returns:
        The `ReplayStats`; ``dropped`` counts fail-closed routing
        rejections (0 on a healthy replay).

    Raises:
        ValueError: empty trace, non-simulated clock, bad step time.
        RuntimeError: the step budget was exhausted.
    """
    if not trace:
        raise ValueError("cannot replay an empty trace")
    if step_time_s <= 0:
        raise ValueError(f"step_time_s must be positive, got {step_time_s}")
    if not getattr(clock, "is_simulated", False):
        raise ValueError("replay_trace needs the simulated clock that is "
                         "installed into the serving layer (FakeClock)")
    planner = getattr(scaler, "planner", None)
    if slo_targets is None:
        slo_targets = dict(getattr(planner, "slo_targets", {}) or {})
    rng = np.random.default_rng(seed)
    if max_steps is None:
        max_steps = int(trace[-1].t / step_time_s) * 20 + 100_000

    epoch = clock.now
    t = 0.0
    engine_seconds = 0.0
    peak_engines = 0
    steps = 0
    submitted = 0
    dropped = 0
    stats: Dict[str, _LabelStats] = {}
    windows: List[WindowRecord] = []

    def sync(target: float) -> None:
        """Advance simulated time to ``target``, integrating
        engine-seconds over the interval."""
        nonlocal t, engine_seconds
        if target <= t:
            return
        engine_seconds += len(cluster.engines()) * (target - t)
        delta = (epoch + target) - clock.now
        if delta > 0:
            clock.advance(delta)
        t = target

    def submit(ev: TraceRequest) -> None:
        nonlocal submitted, dropped
        prompt = rng.integers(2, vocab_size,
                              size=ev.prompt_len).astype(np.int32)
        req = Request(ev.rid, prompt, max_new_tokens=ev.new_tokens,
                      labels={"data-type": ev.label})
        try:
            cluster.submit(req)
            submitted += 1
        except RoutingError:
            dropped += 1

    def measure(now: float) -> None:
        """Drain the window's completions, score them against the SLO
        targets, and close the calibration loop (predict, record, THEN
        observe — one-step-ahead)."""
        nonlocal win_ok, win_ok_prev
        # quasi-steady only when every tick of this window AND the
        # previous one was unbacklogged: early completions can be
        # stragglers still carrying the prior transient's queueing
        steady = win_ok and win_ok_prev
        win_ok_prev = win_ok
        win_ok = True
        done = cluster.drain_completed()
        if not done:
            return
        by_label: Dict[str, List[Request]] = {}
        for r in done:
            by_label.setdefault(r.labels.get("data-type", "*"),
                                []).append(r)
        demand = (planner.forecast(scaler.tracker)
                  if planner is not None else {})
        for label in sorted(by_label):
            rs = by_label[label]
            acc = stats.setdefault(label, _LabelStats())
            ttfts = [r.ttft for r in rs if math.isfinite(r.ttft)]
            tpots = [r.tpot for r in rs if math.isfinite(r.tpot)]
            acc.ttft.extend(ttfts)
            acc.tpot.extend(tpots)
            targets = slo_targets.get(label)
            if targets is not None and (targets[0] is not None
                                        or targets[1] is not None):
                for r in rs:
                    acc.scored += 1
                    ok = True
                    if targets[0] is not None and not \
                            (math.isfinite(r.ttft)
                             and r.ttft <= targets[0]):
                        ok = False
                    if targets[1] is not None and math.isfinite(r.tpot) \
                            and r.tpot > targets[1]:
                        ok = False
                    acc.ok += ok
            if not ttfts or not tpots:
                continue
            rec = WindowRecord(
                t=now, label=label, completed=len(rs),
                measured_ttft_s=float(np.mean(ttfts)),
                measured_tpot_s=float(np.mean(tpots)))
            d = demand.get(label)
            if planner is not None and d is not None and d.rate > 0:
                pa = planner.predicted_for(label, d, calibrated=False)
                pc = planner.predicted_for(label, d, calibrated=True)
                if pa is not None:
                    rec.predicted_ttft_s = pa.ttft_s
                    rec.predicted_tpot_s = pa.tpot_s
                if pc is not None:
                    rec.calibrated_ttft_s = pc.ttft_s
                    rec.calibrated_tpot_s = pc.tpot_s
                    if alert_evaluator is not None:
                        alert_evaluator.observe_prediction(
                            label,
                            predicted_ttft_s=pc.ttft_s,
                            predicted_tpot_s=pc.tpot_s,
                            measured_ttft_s=rec.measured_ttft_s,
                            measured_tpot_s=rec.measured_tpot_s)
                if steady:
                    planner.observe_measurement(
                        label, d, measured_ttft_s=rec.measured_ttft_s,
                        measured_tpot_s=rec.measured_tpot_s)
            windows.append(rec)

    i, n = 0, len(trace)
    next_tick = tick_s
    ticks = 0
    win_ok = True          # no over-limit backlog seen this window
    win_ok_prev = True     # ... nor in the previous window
    while True:
        while i < n and trace[i].t <= t:
            submit(trace[i])
            i += 1
        busy = _has_work(cluster)
        if not busy and i >= n:
            break
        if busy:
            if steps >= max_steps:
                raise RuntimeError(
                    f"replay exhausted its step budget ({max_steps}) at "
                    f"t={t:.1f}s with {i}/{n} submitted — the service "
                    "model cannot keep up with the trace")
            # charge the step's cost FIRST: tokens (and their TTFT/TPOT
            # stamps) arrive at the END of the step window, and arrivals
            # inside the window wait for the next admission boundary
            dt_step = step_time_s if step_time_fn is None \
                else float(step_time_fn(t))
            if dt_step <= 0:
                raise ValueError(
                    f"step_time_fn({t}) must be positive, got {dt_step}")
            sync(t + dt_step)
            cluster.step()
            steps += 1
        else:
            # idle: jump to whichever comes first — the next arrival or
            # the next control tick (the scaler must keep ticking to
            # retire idle capacity)
            jump = trace[i].t if i < n else next_tick
            sync(max(t, min(jump, next_tick)))
        while t >= next_tick - 1e-9:
            scaler.tick(tick_s)
            if alert_evaluator is not None:
                alert_evaluator.poll()
            ticks += 1
            next_tick += tick_s
            peak_engines = max(peak_engines, len(cluster.engines()))
            backlog, slots = _backlog_and_slots(cluster)
            if backlog > steady_backlog * max(1, slots):
                win_ok = False
            if ticks % window_ticks == 0:
                measure(t)

    cluster.run()                     # reap draining engines
    measure(t)                        # final partial window
    if alert_evaluator is not None:
        alert_evaluator.poll()        # ingest the tail of the run

    per_label: Dict[str, Dict[str, float]] = {}
    attainment: Dict[str, float] = {}
    completed = 0
    ok_total = scored_total = 0
    for label in sorted(stats):
        acc = stats[label]
        completed += len(acc.ttft)
        per_label[label] = {
            "completed": len(acc.ttft),
            "ttft_mean_s": float(np.mean(acc.ttft)) if acc.ttft
            else float("nan"),
            "ttft_p99_s": float(np.percentile(acc.ttft, 99)) if acc.ttft
            else float("nan"),
            "tpot_mean_s": float(np.mean(acc.tpot)) if acc.tpot
            else float("nan"),
        }
        if acc.scored:
            attainment[label] = acc.ok / acc.scored
            ok_total += acc.ok
            scored_total += acc.scored
    history = cluster.history
    return ReplayStats(
        n_requests=n, submitted=submitted, completed=completed,
        dropped=max(dropped, len(cluster.rejected)),
        duration_s=t, steps=steps, engine_seconds=engine_seconds,
        peak_engines=peak_engines,
        final_engines=len(cluster.engines()),
        per_label=per_label, attainment=attainment,
        attainment_overall=(ok_total / scored_total) if scored_total
        else None,
        windows=windows,
        downtime_max_s=max((r.downtime_s for r in history), default=0.0),
        reports=len(history),
        reports_finalized=all(
            set(METRIC_KEYS) <= set(r.metrics_after) for r in history))


def recorded_replay(n_requests: int = 2000, *, arch: str = "minitron_4b",
                    step_time_s: float = 4e-3, seed: int = 11,
                    recorder=None, timings: Optional[Dict[str, float]] = None,
                    alert_evaluator_factory=None,
                    step_time_fn=None,
                    bounds: Tuple[int, int] = (1, 4),
                    flash_multiplier: float = 3.0,
                    device="cuda"):
    """Build a compact full stack (planner + autoscaler + cluster on a
    `FakeClock`), replay a generated trace with the flight recorder ON,
    and return ``(stats, recorder, planner)``.

    This is the one-call recorded-run recipe behind ``python -m
    repro_torch.traffic.replay --trace-out run.trace.json``: everything is
    simulated-time deterministic, so two calls with the same arguments
    (and fresh recorders) produce identical event streams. The model is
    the reduced config of ``arch`` in fp32 with random weights from seed
    0: a replay's counts and stamps do not depend on token values (a
    request stops at its budget; there is no end-of-sequence token).

    Args:
        n_requests: approximate trace size (base_rate * duration).
        arch: reduced-config architecture name.
        step_time_s: simulated duration of one decode step.
        seed: trace-generation seed.
        recorder: a `repro_torch.obs.Recorder` to record into (a fresh one
            is created when None). Pass ``False`` to run with recording
            DISABLED; the returned recorder is then None.
        timings: optional dict; when given, ``timings["replay_wall_s"]``
            is set to the REAL wall-clock seconds of the replay loop
            alone (model build and the floors' spawns excluded), so a
            recorded and an unrecorded run compare on the recorder's cost.
        alert_evaluator_factory: optional ``(recorder, planner, scaler)
            -> AlertEvaluator`` callable; the result is polled through
            the replay (see `replay_trace`). The factory sees the fully
            built stack, so it can wire the evaluator's mandatory-fix
            hooks and calibration; keep a reference in a closure to
            inspect the alerts afterwards.
        step_time_fn: forwarded to `replay_trace` (degradation
            injection).
        bounds: per-label (min, max) engine bounds — tighten the max to
            build an over-capacity scenario the planner cannot absorb.
        flash_multiplier: the built-in phi flash crowd's rate multiple
            (t in [duration/3, duration/2)); raise it to overload.
        device: where the model, the engines and the host profile's
            probes run; the card unless the caller names the CPU.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
    """
    import contextlib
    import dataclasses as _dc

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    from repro_torch.models.common import resolve_device
    from repro_torch.obs import Recorder, recording
    from repro_torch.planner import (
        EngineSpec,
        ResidualCalibration,
        WorkloadPlanner,
        calibrate_host_profile,
    )
    from repro_torch.serving import (
        Autoscaler,
        FakeClock,
        LoadTracker,
        ServingEngine,
        install_clock,
    )
    from repro_torch.sharding.plan import default_plan
    from repro_torch.traffic.generator import (
        FlashCrowd,
        LabelProfile,
        TrafficPattern,
        generate_trace,
    )

    device = resolve_device(device)
    cfg = _dc.replace(get_reduced_config(arch), param_dtype="float32",
                      activ_dtype="float32")
    model = Model(cfg, device=device, seed=0)
    host = calibrate_host_profile(device=device)
    spec = EngineSpec(plan=default_plan(), n_slots=8, s_max=32)

    def engine_factory(sp, label):
        return ServingEngine(model, n_slots=sp.n_slots, s_max=sp.s_max,
                             device=device)

    duration_s = 24.0
    base_rate = n_requests / duration_s
    pattern = TrafficPattern(
        duration_s=duration_s, base_rate=base_rate,
        labels={"phi": LabelProfile(weight=2.0),
                "gen": LabelProfile(weight=1.0)},
        diurnal_period_s=duration_s / 2,
        flash_crowds=(FlashCrowd(t_start=duration_s / 3,
                                 duration_s=duration_s / 6,
                                 multiplier=flash_multiplier,
                                 label="phi"),),
        seed=seed)

    if recorder is False:
        rec = None
    else:
        rec = recorder if recorder is not None else Recorder()
    clock = FakeClock(tick=1e-6)
    restore = install_clock(clock)
    try:
        with (recording(rec) if rec is not None
              else contextlib.nullcontext()):
            cluster = ServingCluster(device=device)
            calibration = ResidualCalibration(alpha=0.3)
            planner = WorkloadPlanner(cluster, engine_factory,
                                      specs=[spec], profiles=[host],
                                      dwell=0, calibration=calibration,
                                      clock=clock)
            for label in ("phi", "gen"):
                planner.bounds[label] = tuple(bounds)
                planner.set_slo_target(label, 50 * step_time_s,
                                       2 * step_time_s)
            scaler = Autoscaler(cluster,
                                lambda label: engine_factory(spec, label),
                                planner=planner,
                                tracker=LoadTracker(alpha=0.5),
                                async_spawn=False, clock=clock)
            planner.execute(planner.plan({}), async_spawn=False)  # floors
            planner.attach_calibrated_profiles()
            trace = generate_trace(pattern)
            evaluator = (alert_evaluator_factory(rec, planner, scaler)
                         if alert_evaluator_factory is not None else None)
            # real wall clock on purpose: this module is not registered
            # for clock injection, so `wall` is untouched by install_clock
            import time as wall
            t_loop = wall.perf_counter()
            stats = replay_trace(trace, cluster, scaler, clock,
                                 vocab_size=cfg.vocab_size,
                                 step_time_s=step_time_s, tick_s=1.0,
                                 window_ticks=4, seed=1,
                                 alert_evaluator=evaluator,
                                 step_time_fn=step_time_fn)
            if device.type == "cuda":
                import torch
                torch.cuda.synchronize(device)
            if timings is not None:
                timings["replay_wall_s"] = wall.perf_counter() - t_loop
    finally:
        restore()
    return stats, rec, planner


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: replay a generated trace with the flight recorder on.

        PYTHONPATH=src python -m repro_torch.traffic.replay \\
            --requests 2000 --trace-out run.trace.json

    ``--device`` names where the stack runs (the card by default; ``cpu``
    runs the plain PyTorch path). ``--trace-out`` dumps a Chrome
    ``trace_event`` JSON of the whole simulated run (with per-request
    cross-engine flow arrows) — open it in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing. ``--slo-out`` dumps the
    `repro_torch.obs.SLOLedger` accounting (windowed per-label attainment +
    pause attribution). ``--alerts-out`` runs the Watchtower
    `repro_torch.obs.AlertEvaluator` through the replay and dumps every
    fired alert; ``--bundle-dir`` additionally captures a debug bundle per
    alert. Recorder ring drops are warned about always and fail the run
    under ``--strict-obs`` (dropped events corrupt attribution silently
    otherwise).
    """
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="recorded serving replay on a simulated clock")
    parser.add_argument("--requests", type=int, default=2000,
                        help="approximate trace size (default 2000)")
    parser.add_argument("--step-time-s", type=float, default=4e-3,
                        help="simulated decode-step duration")
    parser.add_argument("--arch", default="minitron_4b")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--device", default="cuda",
                        help="where the stack runs (default: the card; "
                             "'cpu' runs the plain PyTorch path)")
    parser.add_argument("--trace-out", default="",
                        help="write a Perfetto-loadable Chrome "
                             "trace_event JSON here")
    parser.add_argument("--slo-out", default="",
                        help="write the SLO/downtime ledger JSON here")
    parser.add_argument("--alerts-out", default="",
                        help="run the Watchtower AlertEvaluator and "
                             "write fired alerts (JSON) here")
    parser.add_argument("--bundle-dir", default="",
                        help="capture a debug bundle per fired alert "
                             "into this directory (implies alerting)")
    parser.add_argument("--strict-obs", action="store_true",
                        help="exit nonzero when the recorder dropped "
                             "events or spans (ring overflow)")
    args = parser.parse_args(argv)

    holder: Dict[str, object] = {}
    factory = None
    if args.alerts_out or args.bundle_dir:
        from repro_torch.obs import AlertEvaluator

        def factory(rec_, planner_, scaler_):
            ev = AlertEvaluator(
                rec_, policy=planner_, calibration=planner_.calibration,
                planner=planner_, scaler=scaler_,
                bundle_dir=args.bundle_dir or None)
            holder["evaluator"] = ev
            return ev

    stats, rec, planner = recorded_replay(
        args.requests, arch=args.arch, step_time_s=args.step_time_s,
        seed=args.seed, alert_evaluator_factory=factory,
        device=args.device)
    print(f"replayed {stats.submitted} requests "
          f"({stats.completed} completed, {stats.dropped} dropped) over "
          f"{stats.duration_s:.1f} simulated seconds in {stats.steps} steps")
    print(f"recorded {rec.bus.emitted} events "
          f"({rec.bus.dropped} dropped), {rec.trace.added} spans")
    obs_drops = rec.bus.dropped + rec.trace.dropped
    if obs_drops:
        print(f"WARNING: recorder dropped {rec.bus.dropped} events and "
              f"{rec.trace.dropped} spans (ring overflow) — attribution "
              "and SLO windows are incomplete; raise Recorder capacity",
              file=sys.stderr)
    if args.trace_out or args.slo_out:
        from repro_torch.obs import RequestLineage
        lineage = RequestLineage.from_recorder(rec)
    if args.trace_out:
        doc = rec.export_chrome(args.trace_out,
                                flows=lineage.chrome_flows())
        cons = lineage.conservation()
        worst = max(cons["ttft_max_rel_err"], cons["tpot_max_rel_err"])
        print(f"wrote {args.trace_out}: "
              f"{sum(1 for e in doc['traceEvents'] if e['ph'] == 'X')} "
              "trace events (open in Perfetto / chrome://tracing); "
              f"attributed {len(lineage)} requests, max conservation "
              f"error {worst:.2e}")
    if args.slo_out:
        from repro_torch.obs import SLOLedger
        ledger = SLOLedger.from_policy(planner).consume(rec.events())
        with open(args.slo_out, "w") as f:
            json.dump(ledger.as_dict(), f, indent=1)
        print(f"wrote {args.slo_out}: attainment "
              f"{ledger.attainment_overall()}")
    if args.alerts_out or args.bundle_dir:
        evaluator = holder["evaluator"]
        alerts = evaluator.as_dicts()
        if args.alerts_out:
            with open(args.alerts_out, "w") as f:
                json.dump(alerts, f, indent=1, sort_keys=True)
            print(f"wrote {args.alerts_out}: {len(alerts)} alerts")
        for a in alerts:
            print(f"  ALERT {a['name']} [{a['severity']}] "
                  f"{a['label'] or a['engine']}: {a['message']}")
    if args.strict_obs and obs_drops:
        print("--strict-obs: failing on recorder drops", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
