"""The port's elastic control loop (`repro_torch.serving.autoscaler`)
against the reference's, and its own contracts.

Parity on the CPU: seeded traces of submissions, cluster steps and
`Autoscaler.tick()`s go through a reference cluster of JAX engines and a
port cluster of port engines, on reduced fp32 minitron with the same weights
(`test_torch_cluster.sides`). Per tick the `ScaleDecision`s (kind, label,
engine) and the engine counts per label must be equal; so must every
`DowntimeReport`'s event, engine and warm-up count, and every completed
stream. The traces cover threshold mode (a transient burst does not spawn, a
sustained one does), rebalance over a cold spawn, retirement only after
drain, no flapping on an oscillating trace, an intent that pins bounds (a
floor spawns at once; an invalid scaling intent fails closed) and planner
mode (`Autoscaler(planner=...)`, with the reference's decode-step features
injected into both planners).

Mirrors (port only): every test of `tests/test_autoscaler.py` on port
engines; its five grammar tests become one parametrised test that holds the
port's intent pipeline to the reference's on each sentence.
"""
import numpy as np
import pytest
from test_torch_cluster import sides, tiny

import repro.core as jcore
import repro.planner as jplanner
import repro.serving as jserving
import repro_torch.core as tcore
import repro_torch.planner as tplanner
from repro_torch.core import Orchestrator
from repro_torch.serving import (
    METRIC_KEYS,
    Autoscaler,
    ElasticPolicy,
    LoadTracker,
    Request,
    RoutingError,
    ServingCluster,
    ServingEngine,
)
from repro_torch.sharding import ShardingPlan, plan_satisfies


@pytest.fixture(scope="module")
def port():
    """(cfg, port CPU model) of reduced fp32 minitron."""
    cfg, _, _, model = tiny()
    return cfg, model


def _mk(model, **kw):
    return ServingEngine(model, **{"n_slots": 2, "s_max": 32, "device": "cpu", **kw})


def _req(rng, cfg, rid, label=None, *, n=6, new=3):
    return Request(rid, rng.integers(2, cfg.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=new, labels={"data-type": label} if label else {})


# ---------------------------------------------------------------------------
# parity traces: the same control loop on both packages
# ---------------------------------------------------------------------------


class Loop:
    """One package's cluster and scaler behind the trace's calls, with what
    the trace records."""

    def __init__(self, side, vocab, policy=None, **scaler_kw):
        self.S, self.side, self.vocab = side.serving, side, vocab
        self.cluster = side.cluster()
        self.rng = np.random.default_rng(0)
        self.rid = 0
        self.reqs = []
        self.ticks = []
        kw = dict(tracker=self.S.LoadTracker(alpha=1.0), **scaler_kw)
        if policy is not None:
            kw["policy"] = self.S.ElasticPolicy(**policy)
        self.scaler = self.S.Autoscaler(self.cluster, lambda label: self.engine(), **kw)

    def engine(self, **kw):
        return self.side.engine(**{"n_slots": 2, "s_max": 32, **kw})

    def submit(self, label, k=1, *, n=6, new=3):
        for _ in range(k):
            r = self.S.Request(self.rid, self.rng.integers(2, self.vocab, size=n)
                               .astype(np.int32), max_new_tokens=new,
                               labels={"data-type": label} if label else {})
            self.rid += 1
            self.reqs.append(r)
            try:
                self.cluster.submit(r)
            except self.S.RoutingError:
                pass

    def tick(self):
        self.ticks.append([(d.kind, d.label, d.engine, d.mode) for d in self.scaler.tick()])

    def result(self):
        return {
            "decisions": self.ticks,
            "trajectory": self.scaler.trajectory,
            "reports": [(d.kind, d.label, d.engine, r.event, r.engine, r.compiled_in_prepare)
                        for d, r in self.scaler.events],
            "finalized": all(set(r.metrics_after) == set(METRIC_KEYS)
                             for _, r in self.scaler.events),
            "pending_reports": self.cluster.pending_reports(),
            "engines": sorted(self.cluster.engines()),
            "rejected": [r.rid for r in self.cluster.rejected],
            "streams": {r.rid: list(r.tokens_out) for r in self.reqs},
            "completed": self.cluster.metrics()["completed"],
        }


def trace_threshold(loop):
    """A one-tick transient phi burst, then a sustained one: spawn on the
    sustained burst only; once traffic stops and the engine drained, it
    retires."""
    loop.cluster.register("base", loop.engine())
    loop.submit("phi", 8)
    loop.tick()                 # one hot tick: transient, no spawn
    loop.cluster.run()
    loop.tick()
    for _ in range(4):          # sustained
        loop.submit("phi", 6, new=2)
        loop.tick()
        loop.cluster.step()
    loop.cluster.run()
    for _ in range(5):          # quiet tail: retire after drain
        loop.tick()
        loop.cluster.run()


def trace_rebalance(loop):
    """An idle engine dedicated to a cold label is retargeted at the hot
    general label instead of a cold spawn."""
    loop.cluster.register("base", loop.engine())
    loop.cluster.spawn_engine("phi-0", loop.engine(), labels={"data-type": "phi"})
    loop.submit("general", 10)
    for _ in range(3):
        loop.tick()
    loop.cluster.run()


def trace_drain(loop):
    """A dedicated phi engine with work is never retired while it works;
    retired once drained; its completions survive."""
    loop.cluster.register("base", loop.engine())
    loop.cluster.spawn_engine("phi-0", loop.engine(), labels={"data-type": "phi"})
    loop.submit("phi", 4)
    for _ in range(3):
        loop.tick()
    loop.cluster.run()
    for _ in range(2):
        loop.tick()
    loop.cluster.run()


def trace_oscillating(loop):
    """Hot and cold ticks in turn around the threshold."""
    loop.cluster.register("base", loop.engine())
    for t in range(10):
        if t % 2 == 0:
            loop.submit("phi", 8, new=2)
        loop.tick()
        loop.cluster.run()


def trace_intent(loop):
    """An invalid scaling intent fails closed and pins nothing; then the pod
    confinement with a floor of two: the floor spawns at once, compliant."""
    loop.cluster.register("base", loop.engine())
    core = loop.side.core
    bad = core.Orchestrator().submit("Keep at least two engines for financial records.",
                                     apply_to=loop.scaler)
    loop.ticks.append([("intent", str(bad.success), str(loop.scaler.bounds), "")])
    res = core.Orchestrator().submit(
        "Phi traffic must remain inside the pod, and keep at least two engines for "
        "phi traffic.", apply_to=loop.scaler)
    loop.ticks.append([("intent", str(res.success), str(sorted(res.reports)),
                        str(loop.scaler.bounds))])
    loop.tick()
    loop.tick()
    required = loop.cluster.route_constraints()["phi"]
    loop.ticks.append([("compliant", str(all(
        loop.side.sharding.plan_satisfies(loop.cluster.engine(n).plan, required)
        for n in loop.cluster.engines_for_label("phi"))), "", "")])
    loop.submit("phi", 4)
    loop.cluster.run()


def trace_planner(loop):
    """Planner mode: phi demand with a floor of one, then general demand;
    the planner sizes both labels."""
    loop.cluster.register("base0", loop.engine())
    for k in (4, 6, 6, 0, 0, 0, 0):
        loop.submit("phi", k)
        loop.submit("general", k // 2)
        loop.tick()
        loop.cluster.run()


def _planner_kw(side):
    """`Autoscaler` kwargs of planner mode: a `WorkloadPlanner` over L40S
    and A100 with the reference's features of a (2, 32) engine injected
    (both packages then score the same numbers)."""
    pkg = tplanner if side.name == "torch" else jplanner
    _, jmodel, jparams, _ = tiny()
    feats = jplanner.features_from_engine(
        jserving.ServingEngine(jmodel, jparams, n_slots=2, s_max=32))

    def make(cluster):
        spec = pkg.EngineSpec(plan=side.sharding.default_plan(), n_slots=2, s_max=32)
        planner = pkg.WorkloadPlanner(
            cluster, lambda s, label: side.engine(n_slots=s.n_slots, s_max=s.s_max),
            specs=[spec], profiles=[pkg.L40S.scaled(1e-7), pkg.A100.scaled(1e-7)], dwell=1)
        planner._features[(2, 32, spec.plan.with_(device_constraints=(),
                                                  forbidden_collective_axes=()))] = \
            pkg.CostFeatures(**{k: getattr(feats, k) for k in (
                "flops", "bytes", "wire_bytes", "n_slots", "s_max", "param_bytes",
                "kv_bytes", "kv_tokens")})
        return planner
    return make


TRACES = {
    "threshold": (trace_threshold, dict(spawn_depth=2.0, retire_rate=0.25, sustain=2,
                                        cooldown=1, prefer_rebalance=False)),
    "rebalance": (trace_rebalance, dict(spawn_depth=3.0, sustain=2, cooldown=2,
                                        prefer_rebalance=True)),
    "retire_after_drain": (trace_drain, dict(retire_rate=0.25, sustain=2, cooldown=0)),
    "oscillating_damped": (trace_oscillating, dict(spawn_depth=3.0, sustain=2, cooldown=3,
                                                   default_bounds=(0, 2),
                                                   prefer_rebalance=False)),
    "oscillating_eager": (trace_oscillating, dict(spawn_depth=3.0, sustain=1, cooldown=0,
                                                  default_bounds=(0, 2),
                                                  prefer_rebalance=False)),
    "intent_bounds": (trace_intent, None),
    "planner": (trace_planner, "planner"),
}


def _run(case, side, vocab):
    trace, policy = TRACES[case]
    if policy == "planner":
        loop = Loop(side, vocab, bounds={"phi": (1, 3)})
        loop.scaler.planner = _planner_kw(side)(loop.cluster)
    else:
        loop = Loop(side, vocab, policy)
    trace(loop)
    return loop.result()


@pytest.mark.parametrize("case", list(TRACES))
def test_control_loop_equals_reference(case):
    vocab = tiny()[0].vocab_size
    jax_side, torch_side = sides()
    want = _run(case, jax_side, vocab)
    got = _run(case, torch_side, vocab)
    assert got == want
    assert got["finalized"] and got["pending_reports"] == []
    kinds = [k for tick in got["decisions"] for k, *_ in tick]
    events = {
        "threshold": ["spawn", "retire"], "rebalance": ["rebalance"],
        "retire_after_drain": ["retire"], "oscillating_eager": ["spawn"],
        "intent_bounds": ["spawn"], "planner": ["spawn", "retire"],
    }
    for kind in events.get(case, []):
        assert kind in kinds, (case, kinds)
    if case == "threshold":
        assert got["decisions"][0] == []              # the transient did not spawn
    if case == "oscillating_damped":
        assert got["reports"] == []                   # hysteresis rides it out
    if case == "intent_bounds":
        assert got["decisions"][0] == [("intent", "False", "{}", "")]
        assert [("compliant", "True", "", "")] in got["decisions"]
        assert got["trajectory"][-1]["phi"] >= 2


# ---------------------------------------------------------------------------
# mirrors of tests/test_autoscaler.py: load tracking and per-label metrics
# ---------------------------------------------------------------------------


def test_load_tracker_ewma_rates_and_decay(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("e", _mk(model))
    rng = np.random.default_rng(0)
    tracker = LoadTracker(alpha=0.5)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    tracker.observe(cluster)
    assert tracker.rate("phi") == pytest.approx(2.0)
    assert tracker.depth("phi") == pytest.approx(2.0)
    assert tracker.depth_tokens("phi") > 0
    cluster.run()
    tracker.observe(cluster)
    assert tracker.rate("phi") == pytest.approx(1.0)
    assert tracker.depth("phi") == pytest.approx(1.0)
    assert tracker.rate("never-seen") == 0.0
    with pytest.raises(ValueError):
        tracker.observe(cluster, dt=0.0)
    with pytest.raises(ValueError):
        LoadTracker(alpha=0.0)


def test_cluster_metrics_aggregate_late_and_retired_engines(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("a", _mk(model))
    rng = np.random.default_rng(1)
    cluster.submit(_req(rng, cfg, 0, "phi"))
    cluster.run()
    assert cluster.metrics()["completed"] == 1
    cluster.register("b", _mk(model), labels={"data-type": "general"})
    cluster.submit(_req(rng, cfg, 1, "general"))
    cluster.run()
    assert cluster.metrics()["completed"] == 2
    cluster.retire_engine("b")
    cluster.run()
    assert "b" not in cluster.engines()
    assert cluster.metrics()["completed"] == 2
    assert cluster.metrics_by_label()["general"]["completed"] == 1


def test_metrics_by_label_zero_fills_idle_labels(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("e", _mk(model))
    cluster.set_route_constraint("phi", ShardingPlan())
    rng = np.random.default_rng(2)
    cluster.submit(_req(rng, cfg, 0, "general"))
    cluster.run()
    by_label = cluster.metrics_by_label(extra_labels=("audio",))
    for label in ("phi", "audio"):
        assert set(by_label[label]) == set(METRIC_KEYS)
        assert by_label[label]["completed"] == 0
        assert np.isnan(by_label[label]["ttft_mean_s"])
    assert by_label["general"]["completed"] == 1
    depths = cluster.queue_depth_by_label(extra_labels=("audio",))
    assert depths["phi"] == 0 and depths["audio"] == 0


# ---------------------------------------------------------------------------
# mirrors: scale-up
# ---------------------------------------------------------------------------


def test_spawn_on_sustained_overload_not_on_transient(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(spawn_depth=3.0, sustain=2, cooldown=2,
                                             prefer_rebalance=False),
                        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(3)
    for rid in range(8):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    assert scaler.tick() == []
    decisions = scaler.tick()
    assert [d.kind for d in decisions] == ["spawn"]
    assert decisions[0].label == "phi"
    (_, report), = scaler.events
    name = report.engine
    assert name in cluster.engines()
    assert report.event == "spawn"
    assert report.compiled_in_prepare > 0
    spawned = cluster.engine(name)
    assert spawned.labels["data-type"] == "phi"
    assert spawned.load > 0
    assert all(r.t_submit > 0 for r in spawned.queue)


def test_spawned_engine_is_warmed_in_prepare(port):
    """A spawn warms prefill at the label's live prompt lengths and
    installs PREPARE's decode executable (the reference's AOT executables:
    nothing is built on the serving path)."""
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    rng = np.random.default_rng(4)
    for rid in range(3):
        cluster.submit(_req(rng, cfg, rid, "phi", n=7))
    assert cluster.label_prompt_lengths("phi") == [7]
    engine = _mk(model)
    report = cluster.spawn_engine("phi-1", engine, labels={"data-type": "phi"},
                                  prefill_lengths=cluster.label_prompt_lengths("phi"))
    assert report.compiled_in_prepare == 2          # decode + prefill(7)
    assert engine.decode_executable is not None
    assert engine.decode_stats["installs"] == 1


# ---------------------------------------------------------------------------
# mirrors: scale-down
# ---------------------------------------------------------------------------


def test_retire_only_after_drain(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    cluster.spawn_engine("phi-0", _mk(model), labels={"data-type": "phi"})
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(retire_rate=0.25, sustain=2, cooldown=0),
                        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(5)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    for _ in range(3):
        assert all(d.kind != "retire" for d in scaler.tick())
    assert "phi-0" in cluster.engines()
    cluster.run()
    for _ in range(2):
        decisions = scaler.tick()
    assert [d.kind for d in decisions] == ["retire"]
    cluster.run()
    assert "phi-0" not in cluster.engines()
    assert cluster.metrics_by_label()["phi"]["completed"] == 4


def test_no_request_routed_to_draining_engine(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    cluster.register("phi-0", _mk(model), labels={"data-type": "phi"})
    rng = np.random.default_rng(6)
    cluster.engine("phi-0").submit(_req(rng, cfg, 0, "phi"))
    assert cluster.engine("phi-0").load == 1
    report = cluster.retire_engine("phi-0")
    assert report.event == "retire" and report.downtime_s == 0.0
    assert cluster.draining() == ["phi-0"]
    assert "phi-0" in cluster.engines()
    for rid in range(1, 4):
        assert cluster.submit(_req(rng, cfg, rid, "phi")) == "base"
    assert "phi-0" not in cluster.eligible(_req(rng, cfg, 99, "phi"))
    cluster.run()
    assert "phi-0" not in cluster.engines()
    assert cluster.retire_engine("base").event == "retire"


def test_retire_draining_twice_raises(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("a", _mk(model))
    cluster.submit(_req(np.random.default_rng(7), cfg, 0, "phi"))
    cluster.retire_engine("a")
    with pytest.raises(ValueError):
        cluster.retire_engine("a")


def test_retire_paused_engine_still_drains(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("a", _mk(model))
    eng = cluster.engine("a")
    eng.submit(_req(np.random.default_rng(12), cfg, 0, "phi"))
    eng.pause()
    cluster.retire_engine("a")
    assert not eng.paused
    cluster.run()
    assert "a" not in cluster.engines()
    assert cluster.metrics()["completed"] == 1


# ---------------------------------------------------------------------------
# mirrors: hysteresis, reports, rebalance
# ---------------------------------------------------------------------------


def test_no_flapping_under_oscillating_trace(port):
    cfg, model = port

    def run_trace(policy):
        cluster = ServingCluster(device="cpu")
        cluster.register("base", _mk(model))
        scaler = Autoscaler(cluster, lambda label: _mk(model), policy=policy,
                            tracker=LoadTracker(alpha=1.0))
        rng = np.random.default_rng(8)
        rid = 0
        for t in range(10):
            if t % 2 == 0:
                for _ in range(8):
                    cluster.submit(_req(rng, cfg, rid, "phi", new=2))
                    rid += 1
            scaler.tick()
            cluster.run()
        return len(scaler.events)

    eager = run_trace(ElasticPolicy(spawn_depth=3.0, sustain=1, cooldown=0,
                                    default_bounds=(0, 2), prefer_rebalance=False))
    damped = run_trace(ElasticPolicy(spawn_depth=3.0, sustain=2, cooldown=3,
                                     default_bounds=(0, 2), prefer_rebalance=False))
    assert eager >= 2
    assert damped == 0


def test_every_scale_event_report_finalized(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(spawn_depth=2.0, retire_rate=0.25, sustain=2,
                                             cooldown=1, prefer_rebalance=False),
                        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(9)
    rid = 0
    for _ in range(4):
        for _ in range(6):
            cluster.submit(_req(rng, cfg, rid, "phi", new=2))
            rid += 1
        scaler.tick()
        cluster.step()
    cluster.run()
    for _ in range(4):
        scaler.tick()
        cluster.run()
    kinds = {d.kind for d, _ in scaler.events}
    assert "spawn" in kinds and "retire" in kinds
    assert cluster.pending_reports() == []
    for _, report in scaler.events:
        assert set(report.metrics_after) == set(METRIC_KEYS)
        if report.event == "spawn":
            assert report.metrics_after["completed"] > 0


def test_rebalance_retargets_idle_engine_instead_of_cold_spawn(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    cluster.spawn_engine("phi-0", _mk(model), labels={"data-type": "phi"})
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(spawn_depth=3.0, sustain=2, cooldown=2,
                                             prefer_rebalance=True),
                        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(10)
    for rid in range(10):
        cluster.submit(_req(rng, cfg, rid, "general"))
    scaler.tick()
    decisions = scaler.tick()
    assert [d.kind for d in decisions] == ["rebalance"]
    assert decisions[0].engine == "phi-0"
    assert len(cluster.engines()) == 2
    assert cluster.engine("phi-0").labels["data-type"] == "general"
    (_, report), = scaler.events
    assert report.event == "rebalance"
    assert cluster.engine("phi-0").load > 0


def test_retire_and_rebalance_never_target_same_engine(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("a0", _mk(model), labels={"data-type": "a"})
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(retire_rate=0.25, sustain=1, cooldown=0,
                                             prefer_rebalance=True),
                        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(13)
    for rid in range(4):
        with pytest.raises(RoutingError):
            cluster.submit(_req(rng, cfg, rid, "b"))
    decisions = scaler.tick()
    targeted = [d.engine for d in decisions if d.engine]
    assert len(targeted) == len(set(targeted))
    for d in decisions:
        if d.kind == "rebalance":
            assert d.engine not in cluster.draining()
    if cluster.draining():
        with pytest.raises(ValueError):
            cluster.reconfigure(cluster.draining()[0],
                                cluster.engine(cluster.draining()[0]).plan)


def test_no_respawn_flapping_from_residual_ewma(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    scaler = Autoscaler(cluster, lambda label: _mk(model),
                        policy=ElasticPolicy(sustain=1, cooldown=0),
                        tracker=LoadTracker(alpha=0.5))
    rng = np.random.default_rng(14)
    scaler.set_bounds("phi", 0, 0)
    for rid in range(4):
        with pytest.raises(RoutingError):
            cluster.submit(_req(rng, cfg, rid, "phi"))
    for _ in range(10):
        scaler.tick()
    assert scaler.tracker.rate("phi") > 0.0
    scaler.set_bounds("phi", 0, 4)
    for _ in range(3):
        scaler.tick()
    assert scaler.events == []


def test_donor_with_conflicting_pins_is_not_rebalanced(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    cluster.register("a0", _mk(model, plan=ShardingPlan(device_constraints=(("pod", 0),))),
                     labels={"data-type": "a"})
    cluster.set_route_constraint("phi", ShardingPlan(device_constraints=(("pod", 1),)))
    scaler = Autoscaler(
        cluster, lambda label: _mk(model, plan=ShardingPlan(device_constraints=(("pod", 1),))),
        policy=ElasticPolicy(sustain=1, cooldown=0, prefer_rebalance=True),
        tracker=LoadTracker(alpha=1.0))
    rng = np.random.default_rng(15)
    for rid in range(4):
        with pytest.raises(RoutingError):
            cluster.submit(_req(rng, cfg, rid, "phi"))
    decisions = scaler.tick()
    assert all(d.kind != "rebalance" for d in decisions)
    assert any(d.kind == "spawn" and d.label == "phi" for d in decisions)
    assert len(cluster.engines_for_label("phi")) == 1


# ---------------------------------------------------------------------------
# mirrors: intent-pinned scaling bounds
# ---------------------------------------------------------------------------


def test_intent_pins_scaling_bounds_and_floor_spawns(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    scaler = Autoscaler(cluster, lambda label: _mk(model), tracker=LoadTracker(alpha=1.0))
    orch = Orchestrator()
    res = orch.submit("Keep at least two serving engines for phi traffic.", apply_to=scaler)
    assert res.success
    assert scaler.bounds["phi"] == (2, None)
    assert orch.state.scale_bounds["phi"] == (2, None)
    scaler.tick()
    scaler.tick()
    assert len(cluster.engines_for_label("phi")) >= 2
    assert all(r.event == "spawn" and r.compiled_in_prepare > 0 for _, r in scaler.events)


def test_intent_routing_plus_scaling_spawns_compliant_engines(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    scaler = Autoscaler(cluster, lambda label: _mk(model), tracker=LoadTracker(alpha=1.0))
    res = Orchestrator().submit("Phi traffic must remain inside the pod, and keep at least "
                                "two engines for phi traffic.", apply_to=scaler)
    assert res.success
    assert "base" in res.reports
    required = cluster.route_constraints()["phi"]
    scaler.tick()
    scaler.tick()
    phi_engines = cluster.engines_for_label("phi")
    assert len(phi_engines) >= 2
    for name in phi_engines:
        assert plan_satisfies(cluster.engine(name).plan, required)
    rng = np.random.default_rng(11)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    cluster.run()
    assert cluster.metrics_by_label()["phi"]["completed"] == 4


def test_invalid_scaling_intent_fails_closed(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    scaler = Autoscaler(cluster, lambda label: _mk(model))
    res = Orchestrator().submit("Keep at least two engines for financial records.",
                                apply_to=scaler)
    assert not res.success
    assert scaler.bounds == {}
    assert len(cluster.engines()) == 1


def test_set_bounds_validation():
    scaler = Autoscaler(ServingCluster(device="cpu"), lambda label: None)
    with pytest.raises(ValueError):
        scaler.set_bounds("phi", -1)
    with pytest.raises(ValueError):
        scaler.set_bounds("phi", 3, 2)


def _interpret(core, text, comps):
    from importlib import import_module
    labels = import_module(core.__name__ + ".labels")
    compiler = import_module(core.__name__ + ".compiler")
    validator = import_module(core.__name__ + ".validator")
    fabric = labels.build_fabric((2, 16, 16), ("pod", "data", "model"))
    res = core.DeterministicInterpreter().interpret(text, fabric, comps)
    policy = compiler.compile_intent(res.intent, fabric, comps)
    return {
        "scaling": [(s.selector, s.min_engines, s.max_engines) for s in res.intent.scaling],
        "placement": [tuple(sorted(dict(p.require).items())) for p in res.intent.placement],
        "scale_bounds": policy.scale_bounds,
        "errors": policy.errors,
        "valid": validator.validate(policy, fabric, comps).passed,
    }


GRAMMAR = {
    # a scaling selector on components with no data-type label cannot be
    # enforced: the compiler errors (fail-closed) instead of dropping it
    "no_routing_label": ("Keep at least two instances of the doctor app.", "doctor"),
    # a capacity phrase and a placement predicate in one clause: both compile
    "capacity_with_placement": ("Keep at least two patient instances in the cloud zone.",
                                "default"),
    # two clauses on one label intersect; an empty intersection errors
    "bounds_intersect": ("Keep at least two engines for phi traffic, and at most three "
                         "instances of the patient service.", "default"),
    "bounds_conflict": ("Keep at least two engines for phi traffic, and at most one "
                        "instance of the patient service.", "default"),
    # 'fourteen' is not 'four'; digits parse
    "number_word_boundary": ("Keep at least fourteen engines for phi traffic.", "default"),
    "number_digits": ("Keep at least 14 engines for phi traffic.", "default"),
    # an orphaned capacity clause is recovered from the whole sentence
    "orphaned_capacity": ("For the phi workloads. Provision at least two engines.", "default"),
}


@pytest.mark.parametrize("case", list(GRAMMAR))
def test_scaling_grammar_equals_reference(case):
    text, comps = GRAMMAR[case]
    got, want = (_interpret(core, text, (core.DEFAULT_WORKLOAD if comps == "default" else
                                         (core.Component("doctor", {"app": "doctor"}),)))
                 for core in (tcore, jcore))
    assert got == want
    if case == "no_routing_label":
        assert got["scaling"] and got["scale_bounds"] == {} and not got["valid"]
        assert any("scaling selector" in e for e in got["errors"])
    elif case == "capacity_with_placement":
        assert got["scaling"][0][1] == 2 and got["placement"] == [(("zone", "cloud"),)]
    elif case == "bounds_intersect":
        assert got["scale_bounds"]["phi"] == (2, 3) and got["errors"] == []
    elif case == "bounds_conflict":
        assert any("conflicting scaling bounds" in e for e in got["errors"])
    elif case == "number_word_boundary":
        assert got["scaling"] == []
    elif case == "number_digits":
        assert got["scaling"][0][1] == 14
    elif case == "orphaned_capacity":
        assert len(got["scaling"]) == 1 and got["scaling"][0][1] == 2


def test_floor_blocked_by_constraint_conflict_does_not_accumulate(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", ShardingPlan(device_constraints=(("pod", 1),)))
    scaler = Autoscaler(
        cluster, lambda label: _mk(model, plan=ShardingPlan(device_constraints=(("pod", 0),))),
        tracker=LoadTracker(alpha=1.0))
    scaler.set_bounds("phi", 2)
    for _ in range(4):
        scaler.tick()
    assert len(cluster.engines_for_label("phi")) == 0
    assert len(cluster.engines()) <= 2


def test_floor_enforced_despite_preexisting_ineligible_engine(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", ShardingPlan(device_constraints=(("pod", 1),)))
    cluster.register("stale", _mk(model, plan=ShardingPlan(device_constraints=(("pod", 0),))),
                     labels={"data-type": "phi"})
    scaler = Autoscaler(cluster, lambda label: _mk(model), tracker=LoadTracker(alpha=1.0))
    scaler.set_bounds("phi", 2)
    for _ in range(4):
        scaler.tick()
    assert len(cluster.engines_for_label("phi")) == 2
    assert len(cluster.engines()) == 3


def test_spawn_names_skip_existing_engines(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("phi-as0", _mk(model), labels={"data-type": "phi"})
    scaler = Autoscaler(cluster, lambda label: _mk(model), tracker=LoadTracker(alpha=1.0))
    scaler.set_bounds("phi", 2)
    scaler.tick()
    assert len(cluster.engines_for_label("phi")) == 2
    assert "phi-as1" in cluster.engines()


def test_redistributed_requests_feed_the_warmed_lengths(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    rng = np.random.default_rng(16)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi", n=9))
    spawned = _mk(model)
    cluster.spawn_engine("phi-1", spawned, labels={"data-type": "phi"}, prefill_lengths=(9,))
    assert spawned.queue
    assert 9 in spawned.seen_prompt_lengths
    report = cluster.reconfigure("phi-1", spawned.plan)
    assert 9 in spawned.recent_prompt_lengths()
    assert report.compiled_in_prepare >= 2


def test_policy_counts_inflight_spawn_tickets_as_capacity(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    ticket = cluster.spawn_engine_async("phi-inflight", _mk(model),
                                        labels={"data-type": "phi"})
    assert cluster.pending_spawn_labels() == {"phi": 1}
    policy = ElasticPolicy(sustain=1, cooldown=0)
    tracker = LoadTracker(alpha=1.0)
    rng = np.random.default_rng(0)
    for rid in range(3):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    tracker.observe(cluster)
    decisions = policy.decide(tracker, cluster, {"phi": (1, 4)})
    assert not any(d.kind == "spawn" and d.label == "phi" for d in decisions)
    cluster.run(wait_pending=True)
    assert ticket.done() and cluster.pending_spawn_labels() == {}
    tracker.observe(cluster)
    decisions = policy.decide(tracker, cluster, {"phi": (1, 4)})
    assert not any(d.kind == "spawn" and d.label == "phi" for d in decisions)
    cluster.run()
    assert cluster.metrics()["completed"] == 3


def test_async_spawn_and_failed_prepare_back_off(port):
    """``async_spawn``: the spawn's PREPARE runs on the worker and joins at
    a later tick; a spawn whose PREPARE fails is recorded in ``failures``
    and the label backs off instead of respawning every tick."""
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    broken = {"on": True}

    def factory(label):
        eng = _mk(model)
        if broken["on"]:
            eng.prepare_executables = lambda *a, **kw: (_ for _ in ()).throw(
                RuntimeError("boom"))
        return eng

    scaler = Autoscaler(cluster, factory, async_spawn=True, tracker=LoadTracker(alpha=1.0),
                        policy=ElasticPolicy(sustain=1, cooldown=2))
    scaler.set_bounds("phi", 2)              # "base" serves phi: one more
    assert [d.kind for d in scaler.tick()] == ["spawn"]
    assert scaler.events == []               # joins only at a later tick
    cluster.run(wait_pending=True)
    scaler.tick()
    assert len(scaler.failures) == 1 and "boom" in repr(scaler.failures[0][1])
    assert cluster.engines_for_label("phi") == ["base"]
    broken["on"] = False
    for _ in range(4):
        scaler.tick()
        cluster.run(wait_pending=True)
    scaler.tick()
    assert len(cluster.engines_for_label("phi")) == 2
    assert [d.kind for d, _ in scaler.events] == ["spawn"]


@pytest.mark.parametrize("async_spawn", [False, True], ids=["sync", "async"])
def test_retired_engines_are_freed(port, async_spawn):
    """Once a scaled-up engine retires and is reaped, nothing keeps it (its
    pool and decode executable) alive, not even the spawn ticket that the
    planner's log keeps."""
    import gc
    import weakref

    _, model = port
    spawned = []

    def factory(spec, label):
        eng = _mk(model)
        spawned.append(weakref.ref(eng))
        return eng

    cluster = ServingCluster(device="cpu")
    planner = tplanner.WorkloadPlanner(
        cluster, factory, specs=[tplanner.EngineSpec(plan=ShardingPlan(), n_slots=2,
                                                     s_max=32)],
        profiles=[tplanner.A100], dwell=0)
    scaler = Autoscaler(cluster, lambda label: _mk(model), planner=planner,
                        async_spawn=async_spawn, tracker=LoadTracker(alpha=1.0))
    for bounds in ((1, 2), (0, 0)):
        scaler.set_bounds("phi", *bounds)
        for _ in range(3):
            scaler.tick()
            cluster.run(wait_pending=True)
    assert [d.kind for d, _ in scaler.events] == ["spawn", "retire"]
    assert cluster.engines() == [] and len(planner.log) == 2
    gc.collect()
    assert len(spawned) == 2 and all(ref() is None for ref in spawned)
