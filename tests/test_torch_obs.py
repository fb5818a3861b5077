"""The port's flight recorder and Watchtower layer (`repro_torch.obs`):
mirrors of `tests/test_obs.py`, `tests/test_lineage.py` and
`tests/test_alerts.py` on the port's modules, and cross-package checks.

Cross-package: the same hand-built event streams through `repro.obs` and
`repro_torch.obs` give equal `SLOLedger.as_dict()`, equal `RequestLineage`
decompositions and conservation, and equal alert lists; a debug bundle
captured on either side round-trips through the other's `load_bundle` /
`replay_ledger`; and a port handoff (a prefill and a decode engine) on a
`FakeClock` gives the reference's lineage.

The recorded-replay checks share one module-scoped
`repro_torch.traffic.replay.recorded_replay` on the CPU; the determinism
test pays for the second run itself.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
from test_torch_cluster import prompts, sides, tiny

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs import (
    Alert,
    AlertEvaluator,
    BurnRateRule,
    EventBus,
    Histogram,
    Recorder,
    RequestLineage,
    SLOLedger,
    Span,
    TPOT_COMPONENTS,
    TTFT_COMPONENTS,
    TraceBuffer,
    bundle_events,
    load_bundle,
    meets_slo,
    recording,
    replay_ledger,
    validate_chrome,
)
from repro_torch.obs import events as obs_events
from repro_torch.serving import METRIC_KEYS, Request, ServingCluster, ServingEngine

#: recorded-replay size: big enough to scale and migrate, small enough that
#: the module stays a minor slice of the suite
N_REQ = 400
PACKAGES = {"jax": jobs, "torch": tobs}


# ---------------------------------------------------------------------------
# rings: bounded, counted, oldest-out
# ---------------------------------------------------------------------------


def test_event_bus_overflow_drops_oldest_and_counts():
    bus = EventBus(capacity=8)
    for i in range(20):
        bus.emit("unit.tick", rid=i, ts=float(i))
    assert len(bus) == 8
    assert bus.emitted == 20
    assert bus.dropped == 12
    kept = bus.events()
    assert [e.rid for e in kept] == list(range(12, 20))
    assert [e.seq for e in kept] == list(range(12, 20))
    assert all(a.ts <= b.ts for a, b in zip(kept, kept[1:]))


def test_event_bus_kind_prefix_filter():
    bus = EventBus()
    bus.emit("request.submit")
    bus.emit("request.complete")
    bus.emit("requestor")                         # prefix, not substring
    bus.emit("cluster.swap")
    assert len(bus.events("request")) == 2
    assert len(bus.events("request.submit")) == 1
    assert len(bus.events("cluster")) == 1


def test_trace_buffer_overflow_drops_oldest_and_counts():
    buf = TraceBuffer(capacity=4)
    for i in range(10):
        buf.add(Span("s", float(i), 0.5))
    spans = buf.spans()
    assert len(spans) == 4
    assert buf.added == 10 and buf.dropped == 6
    assert [s.ts for s in spans] == [6.0, 7.0, 8.0, 9.0]


@pytest.mark.parametrize("make", [lambda: EventBus(capacity=0),
                                  lambda: TraceBuffer(capacity=-1)],
                         ids=["bus", "trace"])
def test_rings_reject_nonpositive_capacity(make):
    with pytest.raises(ValueError):
        make()


# ---------------------------------------------------------------------------
# histogram sketch
# ---------------------------------------------------------------------------


def test_histogram_quantiles_within_sketch_error():
    rng = np.random.default_rng(3)
    xs = rng.lognormal(mean=-4.0, sigma=1.0, size=20_000)
    h = Histogram(growth=1.1)
    for x in xs:
        h.observe(float(x))
    for q in (0.5, 0.9, 0.99):
        exact = float(np.percentile(xs, 100 * q))
        assert abs(h.quantile(q) - exact) / exact < 0.06, q
    assert h.mean == pytest.approx(float(np.mean(xs)), rel=1e-9)


def test_histogram_edge_values():
    h = Histogram()
    h.observe(0.0)
    h.observe(5.0)
    assert h.quantile(0.0) == 0.0
    assert h.quantile(1.0) == pytest.approx(5.0, rel=0.06)
    h.observe(float("nan"))
    assert h.snapshot()["count"] == 3
    assert math.isnan(h.quantile(0.5))


# ---------------------------------------------------------------------------
# recorder plumbing
# ---------------------------------------------------------------------------


def test_recording_disabled_by_default_and_restores():
    assert obs_events.RECORDER is None
    with recording(Recorder()) as rec:
        assert obs_events.RECORDER is rec
        with recording() as inner:
            assert obs_events.RECORDER is inner
        assert obs_events.RECORDER is rec
    assert obs_events.RECORDER is None


def test_request_complete_events_fold_into_metrics():
    rec = Recorder()
    rec.emit("request.complete", rid=1, label="phi", ttft_s=0.1, tpot_s=0.01)
    rec.emit("request.complete", rid=2, label="phi", ttft_s=0.3, tpot_s=0.02)
    rec.emit("request.reject", rid=3, label="gen")
    snap = rec.snapshot()["metrics"]
    assert snap["counters"]["requests_completed{label=phi}"] == 2
    assert snap["counters"]["requests_rejected{label=gen}"] == 1
    assert snap["histograms"]["ttft_s{label=phi}"]["count"] == 2


@pytest.mark.parametrize("ttft,tpot,targets,ok", [
    (0.1, 0.01, (0.2, 0.02), True),
    (0.3, 0.01, (0.2, 0.02), False),              # ttft over
    (0.1, 0.03, (0.2, 0.02), False),              # tpot over
    (math.inf, 0.01, (0.2, None), False),         # ttft must finish
    (0.1, math.nan, (0.2, 0.02), True),           # 1-token request
    (math.inf, math.inf, (None, None), True),     # unscored
])
def test_meets_slo_predicate_matches_harness_semantics(ttft, tpot, targets, ok):
    assert meets_slo(ttft, tpot, targets) is ok
    assert jobs.meets_slo(ttft, tpot, targets) is ok


# ---------------------------------------------------------------------------
# the recorded replay on the CPU: one run, many cross-checks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded_run():
    from repro_torch.traffic.replay import recorded_replay
    return recorded_replay(N_REQ, seed=7, device="cpu")


def test_replay_records_the_request_lifecycle(recorded_run):
    stats, rec, _ = recorded_run
    assert rec.bus.dropped == 0 and rec.trace.dropped == 0
    assert len(rec.events("request.submit")) == stats.submitted
    assert len(rec.events("request.complete")) == stats.completed
    assert stats.completed > 0
    assert len(rec.events("planner.decision")) > 0
    assert len(rec.trace.spans("route")) == stats.submitted


def test_no_wall_clock_on_the_event_stream(recorded_run):
    """Every timestamp sits in the FakeClock's epoch (starts at 1000 s)."""
    _, rec, _ = recorded_run
    ts = [e.ts for e in rec.events()] + [s.ts for s in rec.trace.spans()]
    assert ts
    assert all(1_000.0 <= t < 1e6 for t in ts)


def _freeze_events(rec):
    return [(e.seq, e.ts, e.kind, e.engine, e.rid, e.label,
             json.dumps(e.data, sort_keys=True, default=repr)) for e in rec.events()]


def _freeze_spans(rec):
    return [(s.name, s.ts, s.dur, s.track, s.cat,
             json.dumps(s.args, sort_keys=True, default=repr)) for s in rec.trace.spans()]


def test_fake_clock_replays_are_bit_identical(recorded_run):
    from repro_torch.traffic.replay import recorded_replay

    stats_a, rec_a, _ = recorded_run
    stats_b, rec_b, _ = recorded_replay(N_REQ, seed=7, device="cpu")
    assert dataclasses.asdict(stats_b) == dataclasses.asdict(stats_a)
    assert _freeze_events(rec_b) == _freeze_events(rec_a)
    assert _freeze_spans(rec_b) == _freeze_spans(rec_a)
    assert json.dumps(rec_b.export_chrome(), sort_keys=True) \
        == json.dumps(rec_a.export_chrome(), sort_keys=True)


def test_replay_migration_pauses_consistent(recorded_run):
    _, rec, planner = recorded_run
    records = [m for rep in planner.cluster.history for m in rep.migrations]
    span_pauses = sorted((s.args.get("rid", -1), s.dur)
                         for s in rec.trace.spans("migration.pause"))
    assert span_pauses == sorted((m.rid, m.pause_s) for m in records)
    ev_total = sum(e.data["pause_s"] for e in rec.events("migration.pause"))
    assert abs(ev_total - sum(m.pause_s for m in records)) * 1e3 < 1e-6


def test_slo_ledger_matches_replay_attainment(recorded_run):
    stats, rec, planner = recorded_run
    ledger = SLOLedger.from_policy(planner).consume(rec.events())
    assert set(ledger.attainment()) == set(stats.attainment)
    for label, expected in stats.attainment.items():
        assert ledger.attainment()[label] == pytest.approx(expected, abs=1e-12)
    assert ledger.attainment_overall() == pytest.approx(stats.attainment_overall, abs=1e-12)
    assert sum(ledger.completed().values()) == stats.completed
    for label in ledger.attainment():
        wins = ledger.windows(label)
        assert wins
        ok, scored = sum(w.ok for w in wins), sum(w.scored for w in wins)
        assert ok / scored == pytest.approx(ledger.attainment()[label], abs=1e-12)
    pauses = ledger.pause_accounting()
    assert set(pauses) == set(SLOLedger.CAUSES)
    assert pauses["migration"]["count"] == len(rec.events("migration.pause"))


def test_replay_lineage_conserves_exactly(recorded_run):
    stats, rec, _ = recorded_run
    lin = RequestLineage.from_recorder(rec)
    cons = lin.conservation()
    assert len(lin) == stats.completed and cons["n_partial"] == 0
    assert cons["ttft_max_rel_err"] == 0.0 and cons["tpot_max_rel_err"] == 0.0
    assert cons["violations"] == []


def test_chrome_export_is_perfetto_loadable(recorded_run):
    _, rec, _ = recorded_run
    doc = json.loads(json.dumps(rec.export_chrome(
        flows=RequestLineage.from_recorder(rec).chrome_flows())))
    assert validate_chrome(doc) == rec.trace.added - rec.trace.dropped
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "route" in names
    assert names <= {"route", "swap.commit", "spawn.commit", "migration.pause"}


def test_migration_pause_spans_match_records_ms_exact():
    """Migration-pause spans reproduce the per-request `MigrationRecord`
    pause totals exactly, on the `migrate_requests` and the
    `retire_engine(mode="migrate")` paths."""
    cfg, _, _, model = tiny()
    mk = lambda: ServingEngine(model, n_slots=4, s_max=32, device="cpu")  # noqa: E731
    with recording(Recorder()) as rec:
        cluster = ServingCluster(device="cpu")
        cluster.register("e0", mk())
        for rid, p in enumerate(prompts(cfg.vocab_size, (6,) * 4, seed=5)):
            cluster.submit(Request(rid, p, max_new_tokens=8))
        for _ in range(3):
            cluster.step()
        cluster.register("e1", mk())
        moved = cluster.migrate_requests("e0", "e1", rids=[0, 1])
        report = cluster.retire_engine("e1", mode="migrate")
        records = list(moved) + list(report.migrations)
        cluster.run()
    assert len(records) >= 4, records
    spans = rec.trace.spans("migration.pause")
    assert sorted((s.args.get("rid", -1), s.dur) for s in spans) \
        == sorted((m.rid, m.pause_s) for m in records)
    assert abs(sum(s.dur for s in spans) - sum(m.pause_s for m in records)) * 1e3 < 1e-6
    assert all(s.args.get("dst") for s in spans)


def test_metrics_by_label_matches_full_scan():
    from repro_torch.serving import compute_metrics

    cfg, _, _, model = tiny()
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", ServingEngine(model, n_slots=2, s_max=32, device="cpu"),
                     labels={"data-type": "phi"})
    cluster.register("e1", ServingEngine(model, n_slots=2, s_max=32, device="cpu"))
    rng = np.random.default_rng(17)
    for rid in range(12):
        label = "phi" if rid % 3 else "gen"
        cluster.submit(Request(rid, rng.integers(2, cfg.vocab_size, size=6).astype(np.int32),
                               max_new_tokens=3, labels={"data-type": label}))
    cluster.run()
    per_label = {}
    for name in cluster.engines():
        for r in cluster.engine(name).done:
            per_label.setdefault(r.labels.get(ServingCluster.ROUTE_KEY, "*"), []).append(r)
    expected = {v: compute_metrics(rs) for v, rs in per_label.items()}
    got = cluster.metrics_by_label()
    assert set(expected) <= set(got)
    for v, exp in expected.items():
        assert set(got[v]) == set(METRIC_KEYS)
        assert got[v]["completed"] == exp["completed"]
        for key in ("ttft_mean_s", "tpot_mean_s"):
            assert got[v][key] == pytest.approx(exp[key], rel=1e-9), (v, key)
        for key in ("ttft_p99_s", "tpot_p99_s"):
            assert got[v][key] == pytest.approx(exp[key], rel=0.12), (v, key)
    assert len(cluster.drain_completed()) == 12
    assert all(m["completed"] == 0 for m in cluster.metrics_by_label().values())


# ---------------------------------------------------------------------------
# lineage over hand-built streams (mirrors of tests/test_lineage.py)
# ---------------------------------------------------------------------------


def _ev(seq, ts, kind, engine="e0", rid=0, label="phi", **data):
    return (seq, ts, kind, engine, rid, label, data)


def _events(obs, raw):
    """One package's `Event`s from the tuples `_ev` builds."""
    return [obs.Event(*e) for e in raw]


def _basic_request(rid=7, t0=10.0, engine="e0"):
    """TTFT 0.5 (0.08 prefill + 0.02 admission + 0.4 queue), decode span
    0.4 over 4 steps."""
    return [
        _ev(0, t0, "request.submit", engine, rid),
        _ev(1, t0 + 0.5, "request.admit", engine, rid, admit_s=0.02, prefill_s=0.08),
        _ev(2, t0 + 0.9, "request.complete", engine, rid, ttft_s=0.5, tpot_s=0.1,
            tokens_out=5),
    ]


def _migrated_request():
    raw = _basic_request()
    raw.insert(2, _ev(9, 10.7, "migration.pause", "e0", 7, pause_s=0.05, dst="e1",
                      reason="retire"))
    raw[-1] = _ev(2, 10.9, "request.complete", "e1", 7, ttft_s=0.5, tpot_s=0.1,
                  tokens_out=5)
    return raw


def _pre_admit_handoff():
    rid, t0 = 3, 20.0
    return [
        _ev(0, t0, "request.submit", "prefill0", rid),
        _ev(1, t0 + 0.3, "migration.pause", "prefill0", rid, pause_s=0.04,
            dst="decode0", reason="handoff"),
        _ev(2, t0 + 0.5, "request.admit", "decode0", rid),
        _ev(3, t0 + 0.7, "request.complete", "decode0", rid, ttft_s=0.5, tpot_s=0.1,
            tokens_out=3),
    ]


def _prepare_window(engine="e0"):
    raw = _basic_request()
    raw.insert(1, _ev(9, 10.4, "cluster.swap", engine, -1, "", downtime_s=0.1))
    return raw


def _partial():
    return _basic_request() + [_ev(5, 11.0, "request.complete", "e0", 99, ttft_s=0.1,
                                   tpot_s=0.01, tokens_out=2)]


def _inconsistent():
    raw = _basic_request()
    raw[-1] = _ev(2, 10.9, "request.complete", "e0", 7, ttft_s=1.0, tpot_s=0.1,
                  tokens_out=5)
    return raw


def _three_labels():
    raw, seq = [], 0
    for i, (label, queue) in enumerate([("phi", 0.4), ("phi", 0.6), ("gen", 0.01)]):
        rid, t0 = 100 + i, 50.0 + i
        raw += [
            _ev(seq, t0, "request.submit", "e0", rid, label),
            _ev(seq + 1, t0 + queue + 0.08, "request.admit", "e0", rid, label,
                prefill_s=0.08),
            _ev(seq + 2, t0 + queue + 0.28, "request.complete", "e0", rid, label,
                ttft_s=queue + 0.08, tpot_s=0.1, tokens_out=3),
        ]
        seq += 3
    return raw


def _lineage(raw):
    return RequestLineage.from_events(_events(tobs, raw))


def test_consistent_stream_conserves_exactly():
    lin = _lineage(_basic_request())
    assert len(lin) == 1 and not lin.partial_rids
    tl = lin.get(7)
    assert tl.ttft_parts["queue_wait"] == pytest.approx(0.4)
    assert tl.ttft_parts["admission"] == pytest.approx(0.02)
    assert tl.ttft_parts["prefill"] == pytest.approx(0.08)
    assert sum(tl.ttft_parts.values()) == pytest.approx(tl.ttft_s)
    assert tl.decode_steps == 4
    assert tl.decode_span_s == pytest.approx(0.4)
    assert tl.tpot_parts["decode"] == pytest.approx(0.4)
    assert tl.ttft_error() < 1e-12 and tl.tpot_error() < 1e-12
    assert tl.critical("ttft") == "queue_wait" and tl.critical("tpot") == "decode"
    cons = lin.conservation()
    assert cons["violations"] == [] and cons["ttft_max_rel_err"] < 1e-12
    assert set(tl.ttft_parts) == set(TTFT_COMPONENTS)
    assert set(tl.tpot_parts) == set(TPOT_COMPONENTS)


def test_post_admit_migration_pause_comes_out_of_decode():
    tl = _lineage(_migrated_request()).get(7)
    assert tl.tpot_parts["migration_pause"] == pytest.approx(0.05)
    assert tl.tpot_parts["decode"] == pytest.approx(0.35)
    assert tl.tpot_parts["handoff_pause"] == 0.0
    assert tl.engines == ("e0", "e1")
    assert tl.hops == ((pytest.approx(10.65), 10.7, "e0", "e1", "retire"),)
    assert tl.tpot_error() < 1e-12


def test_pre_admit_handoff_lands_in_ttft_not_decode():
    tl = _lineage(_pre_admit_handoff()).get(3)
    assert tl.ttft_parts["handoff_pause"] == pytest.approx(0.04)
    assert tl.ttft_parts["queue_wait"] == pytest.approx(0.46)
    assert tl.tpot_parts["handoff_pause"] == 0.0
    assert tl.engines == ("prefill0", "decode0")
    assert tl.ttft_error() < 1e-12 and tl.tpot_error() < 1e-12


@pytest.mark.parametrize("engine,attributed", [("e0", 0.1), ("other", 0.0)])
def test_prepare_window_overlap_is_attributed(engine, attributed):
    """A committed swap's window inside [submit, admit] on the admitting
    engine is PREPARE wait; one on another engine attributes nothing."""
    tl = _lineage(_prepare_window(engine)).get(7)
    assert tl.ttft_parts["prepare_wait"] == pytest.approx(attributed)
    assert tl.ttft_parts["queue_wait"] == pytest.approx(0.4 - attributed)
    assert tl.ttft_error() < 1e-12


def test_partial_requests_are_excluded_not_guessed():
    lin = _lineage(_partial())
    assert len(lin) == 1 and lin.partial_rids == [99] and lin.get(99) is None
    assert lin.conservation()["n_partial"] == 1


def test_inconsistent_measurement_is_flagged():
    cons = _lineage(_inconsistent()).conservation(eps=0.01)
    assert cons["violations"] == [7]
    assert cons["ttft_max_rel_err"] == pytest.approx(0.5)


def test_critical_path_aggregates_per_label():
    cp = _lineage(_three_labels()).critical_path()
    assert cp["phi"]["n"] == 2 and cp["gen"]["n"] == 1
    assert cp["phi"]["ttft"]["dominant_p99"] == "queue_wait"
    assert cp["phi"]["ttft"]["p99"]["queue_wait"] == pytest.approx(0.6)
    assert cp["gen"]["ttft"]["dominant_p99"] == "prefill"
    assert cp["phi"]["tpot"]["dominant_p50"] == "decode"


def test_chrome_flows_round_trip_through_export(tmp_path):
    rec = Recorder()
    for track in ("e0", "e1"):
        with rec.span("decode", track=track, rid=7):
            pass
    flows = _lineage(_migrated_request()).chrome_flows()
    assert [f["ph"] for f in flows] == ["s", "f"]
    assert flows[0]["track"] == "e0" and flows[1]["track"] == "e1"
    assert flows[0]["id"] == flows[1]["id"] == 7 * 16
    path = tmp_path / "trace.json"
    rec.export_chrome(str(path), flows=flows)
    doc = json.loads(path.read_text())
    assert validate_chrome(doc) > 0
    assert {"s", "f"} <= {e["ph"] for e in doc["traceEvents"]}


def test_from_recorder_matches_from_events():
    rec = Recorder()
    for e in _events(tobs, _basic_request()):
        rec.bus.emit(e.kind, engine=e.engine, rid=e.rid, label=e.label, ts=e.ts, **e.data)
    a = RequestLineage.from_recorder(rec)
    b = RequestLineage.from_events(rec.events())
    assert len(a) == len(b) == 1
    assert a.get(7).ttft_parts == b.get(7).ttft_parts


# ---------------------------------------------------------------------------
# the Watchtower evaluator (mirrors of tests/test_alerts.py)
# ---------------------------------------------------------------------------

TARGETS = {"phi": (0.1, None)}


def _complete(rec, ts, ttft_s, label="phi", rid=0):
    rec.bus.emit("request.complete", engine="e0", rid=rid, label=label, ts=ts,
                 ttft_s=ttft_s, tpot_s=0.01, tokens_out=4)


def _violations(rec, t0, t1, ttft_s=1.0, per_s=4):
    for i in range(int((t1 - t0) * per_s)):
        _complete(rec, t0 + i / per_s, ttft_s, rid=1000 + i)


def _burn_both_windows(obs):
    rec = obs.Recorder()
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS, burn=obs.BurnRateRule(
        goal=0.9, short_s=2.0, long_s=8.0, factor=4.0))
    for i in range(28):
        _complete(rec, 100.0 + i * 0.25, 0.01, rid=i)
    _violations(rec, 107.0, 108.0)
    polls = [ev.poll(t=108.0)]
    _violations(rec, 108.0, 112.0)
    polls += [ev.poll(t=112.0), ev.poll(t=112.5)]
    return ev, polls


def _burn_refire(obs):
    rec = obs.Recorder()
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS,
                            burn=obs.BurnRateRule(short_s=2.0, long_s=4.0))
    _violations(rec, 100.0, 104.0)
    polls = [ev.poll(t=104.0)]
    for i in range(32):
        _complete(rec, 104.0 + i * 0.25, 0.01, rid=2000 + i)
    polls.append(ev.poll(t=112.0))
    _violations(rec, 112.0, 116.0)
    polls.append(ev.poll(t=116.0))
    return ev, polls


def _drops(obs):
    rec = obs.Recorder(capacity=4)
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS)
    for i in range(10):
        rec.bus.emit("request.submit", rid=i, label="phi", ts=float(i))
    polls = [ev.poll(t=10.0)]
    rec.bus.emit("request.submit", rid=99, label="phi", ts=11.0)
    polls.append(ev.poll(t=11.0))
    return ev, polls


def _stuck_prepare(obs):
    rec = obs.Recorder()
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS, stuck_prepare_s=10.0)
    rec.bus.emit("ticket.preparing", engine="e1", ts=100.0)
    polls = [ev.poll(t=105.0), ev.poll(t=111.0)]
    rec.bus.emit("ticket.swapped", engine="e1", ts=112.0)
    polls.append(ev.poll(t=130.0))
    return ev, polls


class _Fixes:
    """A mandatory-fix target that records its calls."""

    def __init__(self, calls):
        self.calls = calls

    def mandatory_fix(self, label, reason=""):
        self.calls.append((label, reason))


def _starved(obs, calls=None):
    calls = [] if calls is None else calls
    rec = obs.Recorder()
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS, starve_s=10.0,
                            planner=_Fixes(calls), scaler=_Fixes(calls))
    rec.bus.emit("request.submit", rid=1, label="phi", ts=100.0)
    polls = [ev.poll(t=105.0), ev.poll(t=111.0)]
    rec.bus.emit("request.admit", engine="e0", rid=1, label="phi", ts=112.0)
    polls.append(ev.poll(t=130.0))
    return ev, polls


class _Cal:
    """ResidualCalibration stand-in: fixed observation count + band."""

    def __init__(self, n=5, ratio_cap=8.0):
        self.n = n
        self.ratio_cap = ratio_cap

    def n_observations(self, label):
        return self.n

    def factors(self, label):
        return (1.0, 1.0)


def _drift(obs):
    ev = obs.AlertEvaluator(obs.Recorder(), slo_targets=TARGETS, calibration=_Cal())
    kw = dict(predicted_ttft_s=0.01, predicted_tpot_s=0.01, measured_tpot_s=0.01)
    polls = [[a] if a else [] for a in (
        ev.observe_prediction("phi", measured_ttft_s=m, t=t, **kw)
        for m, t in ((0.5, 2.0), (0.6, 3.0), (0.01, 4.0), (0.5, 5.0)))]
    return ev, polls


SCENARIOS = {"burn_both_windows": _burn_both_windows, "burn_refire": _burn_refire,
             "drops": _drops, "stuck_prepare": _stuck_prepare, "starved": _starved,
             "drift": _drift}
#: alert names fired per poll of each scenario (the reference's contract)
FIRED = {
    "burn_both_windows": [[], ["slo.burn_rate"], []],
    "burn_refire": [["slo.burn_rate"], [], ["slo.burn_rate"]],
    "drops": [["obs.drops"], []],
    "stuck_prepare": [[], ["prepare.stuck"], []],
    "starved": [[], ["label.starved"], []],
    "drift": [["estimator.drift"], [], [], ["estimator.drift"]],
}


def _alert_key(a):
    return (a.name, a.severity, a.label, a.engine, a.t, a.value, a.threshold, a.message)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_alert_rules_fire_once_per_onset(scenario):
    """Burn rate needs both windows and re-fires after clearing; the drop
    watchdog never re-pages; stuck PREPARE and starved labels fire past
    their age and clear on progress; drift dedups an excursion."""
    ev, polls = SCENARIOS[scenario](tobs)
    assert [[a.name for a in p] for p in polls] == FIRED[scenario]
    assert [a.name for a in ev.alerts] == [n for p in FIRED[scenario] for n in p]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_alert_lists_equal_the_reference(scenario):
    _, jpolls = SCENARIOS[scenario](jobs)
    _, tpolls = SCENARIOS[scenario](tobs)
    assert [[_alert_key(a) for a in p] for p in tpolls] \
        == [[_alert_key(a) for a in p] for p in jpolls]


def test_burn_rate_no_traffic_is_not_a_violation():
    ev = AlertEvaluator(Recorder(), slo_targets=TARGETS)
    assert ev.poll(t=50.0) == [] and ev.alerts == []


def test_labeled_page_alerts_drive_both_mandatory_fixes():
    calls = []
    ev, polls = _starved(tobs, calls)
    assert polls[1][0].label == "phi" and polls[1][0].severity == "page"
    assert calls == [("phi", "label.starved"), ("phi", "label.starved")]


def test_mandatory_fix_reaches_the_ports_planner_and_autoscaler():
    """A labeled page alert lands in the port's
    `WorkloadPlanner.mandatory_fix` and `Autoscaler.mandatory_fix`."""
    from repro_torch.planner import L40S, EngineSpec, WorkloadPlanner
    from repro_torch.serving import Autoscaler
    from repro_torch.sharding import default_plan

    _, _, _, model = tiny()
    cluster = ServingCluster(device="cpu")
    factory = lambda s, label: ServingEngine(model, n_slots=2, s_max=32,  # noqa: E731
                                             device="cpu")
    planner = WorkloadPlanner(cluster, factory, profiles=[L40S],
                              specs=[EngineSpec(plan=default_plan(), n_slots=2, s_max=32)])
    scaler = Autoscaler(cluster, lambda label: factory(None, label), planner=planner)
    with recording(Recorder()) as rec:
        ev = AlertEvaluator(rec, slo_targets=TARGETS, starve_s=10.0,
                            planner=planner, scaler=scaler)
        rec.bus.emit("request.submit", rid=1, label="phi", ts=100.0)
        (alert,) = ev.poll(t=111.0)
    assert alert.name == "label.starved"
    # the planner directly and through the autoscaler, which also clears
    # its own hysteresis
    assert [(e.label, e.data["reason"]) for e in rec.events("planner.mandatory_fix")] \
        == [("phi", "label.starved")] * 2
    assert [(e.label, e.data["reason"]) for e in rec.events("scale.mandatory_fix")] \
        == [("phi", "label.starved")]


def test_drift_respects_warmup():
    cold = AlertEvaluator(Recorder(), slo_targets=TARGETS, calibration=_Cal(n=0))
    assert cold.observe_prediction("phi", predicted_ttft_s=0.01, predicted_tpot_s=0.01,
                                   measured_ttft_s=1.0, measured_tpot_s=1.0, t=1.0) is None
    ev = AlertEvaluator(Recorder(), slo_targets=TARGETS, calibration=_Cal())
    assert ev.drift_band == 8.0
    a = ev.observe_prediction("phi", predicted_ttft_s=1.0, predicted_tpot_s=1.0,
                              measured_ttft_s=0.05, measured_tpot_s=1.0, t=6.0)
    assert a is not None and a.value == pytest.approx(20.0) and a.threshold == 8.0


def test_drift_band_must_exceed_one():
    with pytest.raises(ValueError):
        AlertEvaluator(Recorder(), slo_targets=TARGETS, drift_band=1.0)


def test_rule_crash_fails_closed_as_watchtower_error():
    class Broken:
        ratio_cap = 8.0

        def n_observations(self, label):
            raise RuntimeError("boom")

    ev = AlertEvaluator(Recorder(), slo_targets=TARGETS, calibration=Broken())
    a = ev.observe_prediction("phi", predicted_ttft_s=1.0, predicted_tpot_s=1.0,
                              measured_ttft_s=1.0, measured_tpot_s=1.0, t=1.0)
    assert a is not None and a.name == "watchtower.error"
    assert a.severity == "page" and "boom" in a.message


def _bundled_evaluator(obs, path):
    rec = obs.Recorder()
    _violations(rec, 100.0, 108.0)
    ev = obs.AlertEvaluator(rec, slo_targets=TARGETS, bundle_dir=str(path))
    fired = ev.poll(t=108.0)
    assert len(fired) == 1 and fired[0].bundle
    return rec, ev, fired[0]


def test_bundles_are_byte_deterministic_and_round_trip(tmp_path):
    rec, ev, alert = _bundled_evaluator(tobs, tmp_path / "a")
    _, _, alert_b = _bundled_evaluator(tobs, tmp_path / "b")
    with open(alert.bundle, "rb") as fa, open(alert_b.bundle, "rb") as fb:
        assert fa.read() == fb.read()
    bundle = load_bundle(alert.bundle)
    assert bundle["alert"]["name"] == "slo.burn_rate"
    assert bundle_events(bundle) == list(rec.events())
    led = replay_ledger(bundle)
    assert led.attainment() == ev.ledger.attainment()
    assert led.as_dict() == ev.ledger.as_dict()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_bundles_round_trip_across_packages(tmp_path, writer, reader):
    """A bundle written by one package loads in the other, with the same
    events and the same re-derived ledger; the two bundles are the same
    bytes."""
    _, ev, alert = _bundled_evaluator(PACKAGES[writer], tmp_path / writer)
    _, _, other = _bundled_evaluator(PACKAGES[reader], tmp_path / reader)
    with open(alert.bundle, "rb") as fa, open(other.bundle, "rb") as fb:
        assert fa.read() == fb.read()
    obs = PACKAGES[reader]
    bundle = obs.load_bundle(alert.bundle)
    events = obs.bundle_events(bundle)
    assert [dataclasses.astuple(e) for e in events] \
        == [dataclasses.astuple(e) for e in ev.recorder.events()]
    assert obs.replay_ledger(bundle).as_dict() == ev.ledger.as_dict()


def test_load_bundle_rejects_foreign_json(tmp_path):
    p = tmp_path / "x.json"
    p.write_text('{"format": "something-else"}')
    with pytest.raises(ValueError):
        load_bundle(str(p))


def test_bundle_capture_failure_does_not_lose_the_alert(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where a directory must go")
    rec = Recorder()
    _violations(rec, 100.0, 108.0)
    ev = AlertEvaluator(rec, slo_targets=TARGETS, bundle_dir=str(blocked / "sub"))
    (alert,) = ev.poll(t=108.0)
    assert alert.bundle == "" and "bundle capture failed" in alert.message


def test_as_dicts_and_alert_shape():
    a = Alert("slo.burn_rate", "page", label="phi", t=1.0, value=10.0, threshold=4.0,
              message="m")
    d = dataclasses.asdict(a)
    assert d["name"] == "slo.burn_rate" and d["bundle"] == ""
    assert BurnRateRule().budget == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# the same streams through both packages
# ---------------------------------------------------------------------------

STREAMS = {"basic": _basic_request, "migrated": _migrated_request,
           "pre_admit_handoff": _pre_admit_handoff, "prepare_window": _prepare_window,
           "partial": _partial, "inconsistent": _inconsistent,
           "three_labels": _three_labels}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_lineage_and_ledger_equal_the_reference(stream):
    raw = STREAMS[stream]()
    out = {}
    for name, obs in PACKAGES.items():
        lin = obs.RequestLineage.from_events(_events(obs, raw))
        ledger = obs.SLOLedger({"phi": (0.45, 0.2), "gen": (0.1, None)}, window_s=0.5)
        out[name] = ([dataclasses.asdict(tl) for tl in lin.timelines], lin.partial_rids,
                     lin.conservation(), lin.critical_path(), lin.chrome_flows(),
                     ledger.consume(_events(obs, raw)).as_dict())
    assert out["torch"] == out["jax"]


def test_port_handoff_lineage_equals_the_reference():
    """A prefill engine hands every request off at its first token to a
    decode engine, on a `FakeClock`, in both packages. The handoff comes
    after admission (the first token is out), so the lineage accounts it
    once, in the decode span's ``handoff_pause`` and never as a migration
    pause or in TTFT; conservation is exact; and the port's timelines,
    ledger and flows equal the reference's."""
    cfg = tiny()[0]
    out = {}
    for side in sides():
        obs = PACKAGES[side.name]
        ps = prompts(cfg.vocab_size, (5, 7, 6, 8), seed=1)
        with side.serving.simulated_time(side.serving.FakeClock(tick=1e-6)), \
                obs.recording(obs.Recorder()) as rec:
            cluster = side.cluster()
            cluster.register("pf", side.engine(n_slots=4, s_max=32), role="prefill")
            cluster.register("dc", side.engine(n_slots=4, s_max=32), role="decode")
            for i, p in enumerate(ps):
                cluster.submit(side.serving.Request(i, p, max_new_tokens=8))
            cluster.run()
        lin = obs.RequestLineage.from_recorder(rec)
        ledger = obs.SLOLedger().consume(rec.events())
        out[side.name] = ([dataclasses.asdict(tl) for tl in lin.timelines],
                          lin.conservation(), lin.chrome_flows(), ledger.as_dict(), rec)
    timelines, cons, flows, ledger, rec = out["torch"]
    assert len(timelines) == 4 and cons["violations"] == []
    assert cons["ttft_max_rel_err"] == 0.0 and cons["tpot_max_rel_err"] == 0.0
    pauses = {e.rid: e.data["pause_s"] for e in rec.events("migration.pause")}
    for tl in timelines:
        assert tl["engines"] == ("pf", "dc") and tl["role"] == "decode"
        assert tl["ttft_parts"]["handoff_pause"] == 0
        assert tl["tpot_parts"]["handoff_pause"] == pauses[tl["rid"]] > 0
        assert tl["tpot_parts"]["migration_pause"] == 0.0
    assert ledger["pauses"]["handoff"]["count"] == 4
    assert ledger["pauses"]["migration"]["count"] == 0
    assert len(flows) == 8
    assert out["torch"][:4] == out["jax"][:4]
