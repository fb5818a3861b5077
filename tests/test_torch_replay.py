"""The port's discrete-event replay (`repro_torch.traffic.replay`) against
the reference's, on the CPU.

Parity: one seeded trace (the ~2k-request pattern of
`tests/test_scale.py::test_scale_smoke_2k`: diurnal cycle, phi flash crowd,
long-prompt flood on gen) goes through `repro.traffic.replay_trace` over
JAX engines and through `repro_torch.traffic.replay_trace` over port
engines, on reduced fp32 minitron with the same weights
(`test_torch_cluster.tiny`), each on a `FakeClock(tick=1e-6)` with the
flight recorder on. Both planners get one fixed `DeviceProfile` (slow
enough that the flash crowd needs more engines) and the reference's
decode-step features (as `tests/test_torch_autoscaler.py` injects them),
so both score the same numbers. Every count, the attainment, the decisions
per tick, every `WindowRecord`, each request's ``t_submit`` / ``t_first``
/ ``t_done`` and the whole event stream must be equal: a replay reads the
simulated clock exactly as often, and in the same order, in both packages.

Mirrors (port only): `test_scale_smoke_2k` (on the parity run's port side)
and `test_scale_replay_deterministic` at their sizes; the CLI
(`repro_torch.traffic.replay.main`) once on a small trace. The 10^5-request
stress replay stays the reference's alone.
"""
import contextlib
import dataclasses
import json

import pytest
from test_torch_cluster import sides, tiny

import repro.obs as jobs
import repro.planner as jplanner
import repro.serving as jserving
import repro.traffic as jtraffic
import repro_torch.obs as tobs
import repro_torch.planner as tplanner
import repro_torch.traffic as ttraffic
from repro_torch.serving import METRIC_KEYS

STEP_TIME_S = 4e-3
#: the pinned profile: at 5e8 B/s the tiny engine's decode step is ~4 ms
#: (its 2.0 MB of step bytes), the simulated step time, so one engine's 4
#: lanes carry ~1000 tokens/s and the phi flash crowd needs more engines
PROFILE = dict(name="pinned", peak_flops=1e11, hbm_bw=5e8, mem_bytes=8 << 30,
               link_bw=5e8)
FEATURE_KEYS = ("flops", "bytes", "wire_bytes", "n_slots", "s_max", "param_bytes",
                "kv_bytes", "kv_tokens")
PACKAGES = {"jax": (jplanner, jtraffic, jobs), "torch": (tplanner, ttraffic, tobs)}


def _pattern(traffic, duration_s, base_rate, *, seed=7):
    """`tests/test_scale.py`'s two-tenant pattern in ``traffic``'s types."""
    return traffic.TrafficPattern(
        duration_s=duration_s, base_rate=base_rate,
        labels={"phi": traffic.LabelProfile(weight=2.0),
                "gen": traffic.LabelProfile(weight=1.0)},
        diurnal_period_s=duration_s / 2,
        flash_crowds=(traffic.FlashCrowd(t_start=duration_s / 3, duration_s=duration_s / 6,
                                         multiplier=3.0, label="phi"),),
        floods=(traffic.LongPromptFlood(t_start=2 * duration_s / 3,
                                        duration_s=duration_s / 12, rate=base_rate / 6,
                                        label="gen", prompt_len=24, new_tokens=2),),
        seed=seed)


def _replay(side, pattern_args, *, window_ticks, features=None, record=True):
    """One replay on a fresh planner-mode stack of ``side`` (bounds (1, 3)
    per label, SLO targets 50x / 2x the step time, sync spawns). Returns
    the stats, the decisions per tick, each completed request's stamps and
    tokens, the recorder and the planner."""
    planner_pkg, traffic, obs = PACKAGES[side.name]
    sv = side.serving
    clock = sv.FakeClock(tick=1e-6)
    restore = sv.install_clock(clock)
    rec = obs.Recorder() if record else None
    done, ticks = [], []
    try:
        with obs.recording(rec) if record else contextlib.nullcontext():
            spec = planner_pkg.EngineSpec(plan=side.sharding.default_plan(), n_slots=4,
                                          s_max=32)
            cluster = side.cluster()
            factory = lambda s, label: side.engine(n_slots=s.n_slots, s_max=s.s_max)  # noqa: E731
            # the pinned profile beside pinned features; else the host's own
            profile = (planner_pkg.DeviceProfile(**PROFILE) if features is not None
                       else planner_pkg.calibrate_host_profile(
                           **({"device": "cpu"} if side.name == "torch" else {})))
            planner = planner_pkg.WorkloadPlanner(
                cluster, factory, specs=[spec], profiles=[profile], dwell=0,
                calibration=planner_pkg.ResidualCalibration(alpha=0.3), clock=clock)
            if features is not None:
                planner._features[(4, 32, spec.plan.with_(
                    device_constraints=(), forbidden_collective_axes=()))] = \
                    planner_pkg.CostFeatures(**{k: getattr(features, k) for k in FEATURE_KEYS})
            for label in ("phi", "gen"):
                planner.bounds[label] = (1, 3)
                planner.set_slo_target(label, 50 * STEP_TIME_S, 2 * STEP_TIME_S)
            scaler = sv.Autoscaler(cluster, lambda label: factory(spec, label),
                                   planner=planner, tracker=sv.LoadTracker(alpha=0.5),
                                   async_spawn=False, clock=clock)
            planner.execute(planner.plan({}), async_spawn=False)       # floors
            trace = traffic.generate_trace(_pattern(traffic, *pattern_args))
            drain, tick = cluster.drain_completed, scaler.tick

            def drain_kept():
                out = drain()
                done.extend(out)
                return out

            def tick_kept(dt=1.0):
                out = tick(dt)
                ticks.append([(d.kind, d.label, d.engine, d.reason, d.mode) for d in out])
                return out

            cluster.drain_completed, scaler.tick = drain_kept, tick_kept
            stats = traffic.replay_trace(trace, cluster, scaler, clock,
                                         vocab_size=tiny()[0].vocab_size,
                                         step_time_s=STEP_TIME_S, tick_s=1.0,
                                         window_ticks=window_ticks)
    finally:
        restore()
    requests = {r.rid: (r.t_submit, r.t_first, r.t_done, list(r.tokens_out)) for r in done}
    return {"trace": trace, "stats": stats, "ticks": ticks, "requests": requests,
            "rec": rec, "planner": planner, "cluster": cluster}


@pytest.fixture(scope="module")
def runs():
    """The 2k-request trace through both packages (one replay each)."""
    _, jmodel, jparams, _ = tiny()
    feats = jplanner.features_from_engine(
        jserving.ServingEngine(jmodel, jparams, n_slots=4, s_max=32))
    return {side.name: _replay(side, (12.0, 170.0), window_ticks=3, features=feats)
            for side in sides()}


def _freeze_events(rec):
    return [(e.seq, e.ts, e.kind, e.engine, e.rid, e.label,
             json.dumps(e.data, sort_keys=True, default=repr)) for e in rec.events()]


VIEWS = {
    "counts": lambda r: {k: getattr(r["stats"], k) for k in (
        "n_requests", "submitted", "completed", "dropped", "steps", "peak_engines",
        "final_engines", "reports", "reports_finalized")},
    "attainment": lambda r: (r["stats"].attainment, r["stats"].attainment_overall,
                             r["stats"].per_label),
    "simulated_time": lambda r: (r["stats"].duration_s, r["stats"].engine_seconds,
                                 r["stats"].downtime_max_s),
    "decisions_per_tick": lambda r: r["ticks"],
    "window_records": lambda r: [dataclasses.astuple(w) for w in r["stats"].windows],
    "prediction_error": lambda r: r["stats"].prediction_error(),
    "request_stamps": lambda r: {k: v[:3] for k, v in r["requests"].items()},
    "streams": lambda r: {k: v[3] for k, v in r["requests"].items()},
    "events": lambda r: _freeze_events(r["rec"]),
    "spans": lambda r: [(s.name, s.ts, s.dur, s.track) for s in r["rec"].trace.spans()],
    "reports": lambda r: [(d.event, d.engine, d.downtime_s, d.compiled_in_prepare)
                          for d in r["cluster"].history],
}


@pytest.mark.parametrize("view", list(VIEWS))
def test_replay_equals_the_reference(runs, view):
    assert VIEWS[view](runs["torch"]) == VIEWS[view](runs["jax"])


def test_the_parity_trace_scales_out(runs):
    """The comparison covers the control loop acting: the flash crowd
    spawns beyond the floors, and the quiet tail retires."""
    kinds = [d[0] for t in runs["torch"]["ticks"] for d in t]
    assert "spawn" in kinds and "retire" in kinds
    assert runs["torch"]["stats"].peak_engines > 2


def test_slo_ledger_equals_replay_attainment_on_both_packages(runs):
    ledgers = {}
    for name, run in runs.items():
        obs = PACKAGES[name][2]
        ledger = obs.SLOLedger.from_policy(run["planner"]).consume(run["rec"].events())
        assert ledger.attainment() == pytest.approx(run["stats"].attainment, abs=1e-12)
        ledgers[name] = ledger.as_dict()
    assert ledgers["torch"] == ledgers["jax"]


def test_port_lineage_conserves_exactly(runs):
    run = runs["torch"]
    lin = tobs.RequestLineage.from_recorder(run["rec"])
    cons = lin.conservation()
    assert len(lin) == run["stats"].completed and cons["n_partial"] == 0
    assert cons["ttft_max_rel_err"] == 0.0 and cons["tpot_max_rel_err"] == 0.0
    jlin = jobs.RequestLineage.from_recorder(runs["jax"]["rec"])
    assert [dataclasses.asdict(t) for t in lin.timelines] \
        == [dataclasses.asdict(t) for t in jlin.timelines]


def test_scale_smoke_2k(runs):
    """The mirror of `tests/test_scale.py::test_scale_smoke_2k` on the port
    side of the parity run."""
    run = runs["torch"]
    trace, stats, cluster, planner = run["trace"], run["stats"], run["cluster"], run["planner"]
    assert len(trace) >= 2000
    assert stats.n_requests == len(trace)
    assert stats.dropped == 0 and not cluster.rejected
    assert stats.completed == stats.submitted == len(trace)
    assert stats.reports_finalized
    for r in cluster.history:
        assert set(METRIC_KEYS) <= set(r.metrics_after)
        assert r.downtime_s >= 0.0
    assert set(stats.attainment) == {"gen", "phi"}
    assert all(0.0 <= a <= 1.0 for a in stats.attainment.values())
    assert stats.attainment_overall is not None
    assert stats.duration_s >= trace[-1].t
    assert stats.engine_seconds >= stats.duration_s
    assert stats.peak_engines >= 2
    err = stats.prediction_error()
    assert err["windows_scored"] > 0
    assert planner.calibration.n_observations("phi") > 0


def test_scale_replay_deterministic():
    """The mirror of `tests/test_scale.py::test_scale_replay_deterministic`
    on port engines (the port's own host profile and counted features):
    same seed, identical replay end to end across two fresh stacks."""
    torch_side = sides()[1]
    out = []
    for _ in range(2):
        run = _replay(torch_side, (5.0, 50.0), window_ticks=2, record=False)
        stats = run["stats"]
        out.append((stats.per_label, stats.attainment, stats.engine_seconds, stats.steps,
                    [dataclasses.astuple(w) for w in stats.windows], run["ticks"]))
    assert out[0] == out[1]


def test_replay_rejects_bad_inputs():
    from repro_torch.serving import SYSTEM_CLOCK, FakeClock
    trace = ttraffic.generate_trace(_pattern(ttraffic, 2.0, 5.0))
    with pytest.raises(ValueError, match="empty"):
        ttraffic.replay_trace([], None, None, FakeClock(), vocab_size=8, step_time_s=1e-3)
    with pytest.raises(ValueError, match="positive"):
        ttraffic.replay_trace(trace, None, None, FakeClock(), vocab_size=8, step_time_s=0.0)
    with pytest.raises(ValueError, match="simulated"):
        ttraffic.replay_trace(trace, None, None, SYSTEM_CLOCK, vocab_size=8,
                              step_time_s=1e-3)


def test_cli_writes_trace_ledger_and_alerts(tmp_path):
    """`python -m repro_torch.traffic.replay --device cpu` with every
    output: a Perfetto-loadable trace, the SLO ledger, the alert list and
    a bundle per alert; no recorder drops under ``--strict-obs``."""
    from repro_torch.traffic.replay import main
    paths = {k: tmp_path / f"{k}.json" for k in ("trace", "slo", "alerts")}
    rc = main(["--device", "cpu", "--requests", "120", "--seed", "3",
               "--trace-out", str(paths["trace"]), "--slo-out", str(paths["slo"]),
               "--alerts-out", str(paths["alerts"]), "--bundle-dir", str(tmp_path / "b"),
               "--strict-obs"])
    assert rc == 0
    assert tobs.validate_chrome(json.loads(paths["trace"].read_text())) > 0
    slo = json.loads(paths["slo"].read_text())
    assert set(slo["attainment"]) == {"gen", "phi"}
    assert sum(slo["completed"].values()) > 100
    alerts = json.loads(paths["alerts"].read_text())
    assert isinstance(alerts, list)
    for a in alerts:
        bundle = tobs.load_bundle(a["bundle"])
        assert tobs.replay_ledger(bundle).as_dict()["attainment"] \
            == bundle["slo"]["attainment"]


def test_recorded_replay_defaults_to_the_card():
    import torch

    from repro_torch.traffic.replay import main, recorded_replay
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recorded_replay(10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "10"])
