"""The port's configuration planner (`repro_torch.planner`) against the
reference's, and its own contracts.

Parity on the CPU, on reduced fp32 models with the reference's weights
(`test_torch_cluster.tiny`):

  * the cost model is the same float arithmetic: `estimate`,
    `estimate_disagg`, `prefill_interference`, `ResidualCalibration`,
    `best_candidate` and `score_current` agree field for field for the same
    features, profiles, traffic and bounds;
  * `features_from_engine` counts one decode step of a port engine: FLOPs
    within 5 % of the reference's compiled-HLO count; parameter and KV
    bytes equal; the bytes (operand + result bytes of every non-view op,
    where the reference counts at XLA's fusion boundaries) pinned to the
    ratios PERF.md records, within 10 %;
  * a `WorkloadPlanner` on each package, over its own cluster of tiny
    engines, with the reference's features injected into both, emits the
    same `PlanAction`s round by round and leaves the same engine counts.

Mirrors (port only): every test of `tests/test_planner.py` on port engines,
and the host calibration on the CPU (the card's in `test_torch_cuda.py`).
"""
import dataclasses
import math
import time

import numpy as np
import pytest
import torch
from test_torch_cluster import tiny

import repro.planner as jplanner
import repro.serving as jserving
import repro.sharding.plan as jplan
import repro_torch.planner as tplanner
import repro_torch.serving as tserving
import repro_torch.sharding.plan as tplan
from repro_torch.core import Orchestrator
from repro_torch.planner import (
    A100,
    L40S,
    DeviceProfile,
    EngineSpec,
    LabelDemand,
    ResidualCalibration,
    TrafficMix,
    WorkloadPlanner,
    best_candidate,
    calibrate_host_profile,
    calibrated_estimate,
    eligible_specs,
    estimate,
    features_from_engine,
    get_profile,
)
from repro_torch.serving import (
    Autoscaler,
    LoadTracker,
    PrepareTicket,
    Request,
    ServingCluster,
    ServingEngine,
)
from repro_torch.sharding import ShardingPlan, default_plan


@pytest.fixture(scope="module")
def port():
    """(cfg, port CPU model) of reduced fp32 minitron."""
    cfg, _, _, model = tiny()
    return cfg, model


def _mk(model, **kw):
    return ServingEngine(model, **{"n_slots": 2, "s_max": 32, "device": "cpu", **kw})


def _req(rng, cfg, rid, label=None, *, n=6, new=4):
    return Request(rid, rng.integers(2, cfg.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=new, labels={"data-type": label} if label else {})


@pytest.fixture(scope="module")
def feats(port):
    return features_from_engine(_mk(port[1]))


@pytest.fixture(scope="module")
def host():
    return calibrate_host_profile(device="cpu")


def _flat(f):
    return lambda spec: f


# ---------------------------------------------------------------------------
# the cost model: the same arithmetic on both packages
# ---------------------------------------------------------------------------

# the reference's features of its tiny (2, 32) engine, and a decode-heavy
# (8, 128) one, as plain numbers both packages take
FEATS = {
    "small": dict(flops=430022.0, bytes=1402616.0, wire_bytes=0.0, n_slots=2, s_max=32,
                  param_bytes=428544, kv_bytes=20480, kv_tokens=64),
    "big": dict(flops=2433394.0, bytes=10130464.0, wire_bytes=0.0, n_slots=8, s_max=128,
                param_bytes=428544, kv_bytes=266240, kv_tokens=1024),
    "wired": dict(flops=2.0e12, bytes=9.0e9, wire_bytes=4.0e8, n_slots=8, s_max=512,
                  param_bytes=8_400_000_000, kv_bytes=537_000_000),
}
MIXES = [dict(), dict(prompt_len=8, new_tokens=4, rate=0.0),
         dict(prompt_len=200, new_tokens=12, rate=3.0), dict(prompt_len=64, new_tokens=16,
                                                              rate=1e9)]


def _profiles(pkg):
    return [pkg.A100, pkg.L40S, pkg.A100.pool(4), pkg.L40S.scaled(1e-6),
            pkg.DeviceProfile("tiny", 1e9, 1e9, mem_bytes=1e6, link_bw=1e8)]


def _asdict(x):
    return dataclasses.asdict(x) if x is not None else None


@pytest.mark.parametrize("f", list(FEATS))
def test_estimates_equal_reference(f):
    for jp, tp in zip(_profiles(jplanner), _profiles(tplanner)):
        assert dataclasses.astuple(jp) == dataclasses.astuple(tp)
        jf, tf = jplanner.CostFeatures(**FEATS[f]), tplanner.CostFeatures(**FEATS[f])
        for mix in MIXES:
            jm, tm = jplanner.TrafficMix(**mix), tplanner.TrafficMix(**mix)
            for n in (1, 3):
                je = jplanner.estimate(jf, jp, jm, engines=n)
                te = tplanner.estimate(tf, tp, tm, engines=n)
                assert _asdict(te) == _asdict(je)
                assert _asdict(tplanner.prefill_interference(te, tm, engines=n)) \
                    == _asdict(jplanner.prefill_interference(je, jm, engines=n))
                kw = dict(prefill_engines=n, decode_engines=2, handoff_s=0.004)
                assert _asdict(tplanner.estimate_disagg(
                    tf, tplanner.CostFeatures(**FEATS["big"]), tm, prefill_profile=tp,
                    decode_profile=tplanner.L40S, **kw)) == _asdict(jplanner.estimate_disagg(
                        jf, jplanner.CostFeatures(**FEATS["big"]), jm, prefill_profile=jp,
                        decode_profile=jplanner.L40S, **kw))


def test_residual_calibration_equals_reference():
    rng = np.random.default_rng(0)
    cals = [jplanner.ResidualCalibration(alpha=0.3, ratio_cap=20.0),
            tplanner.ResidualCalibration(alpha=0.3, ratio_cap=20.0)]
    base = [pkg.estimate(pkg.CostFeatures(**FEATS["small"]), pkg.A100)
            for pkg in (jplanner, tplanner)]
    for i in range(30):
        label = ("phi", "general")[i % 2]
        pt, pp, mt, mp = rng.lognormal(size=4)
        if i % 7 == 0:
            mt = float("nan")
        if i % 11 == 0:
            pp = 0.0
        for cal in cals:
            cal.observe(label, predicted_ttft_s=pt, predicted_tpot_s=pp,
                        measured_ttft_s=mt, measured_tpot_s=mp)
        assert cals[1].as_dict() == cals[0].as_dict()
        assert _asdict(cals[1].apply(label, base[1])) == _asdict(cals[0].apply(label, base[0]))
    assert _asdict(tplanner.calibrated_estimate(
        tplanner.CostFeatures(**FEATS["big"]), tplanner.L40S, calibration=cals[1],
        label="phi")) == _asdict(jplanner.calibrated_estimate(
            jplanner.CostFeatures(**FEATS["big"]), jplanner.L40S, calibration=cals[0],
            label="phi"))


def _plan(pkg_plan, pinned):
    return (pkg_plan.ShardingPlan(device_constraints=(("pod", 0),),
                                  forbidden_collective_axes=("pod",))
            if pinned else pkg_plan.default_plan())


def _search_case(pkg, pkg_plan, case):
    """(demand, targets, kwargs) of search case ``case`` for one package."""
    f = {n: pkg.CostFeatures(**v) for n, v in FEATS.items()}
    unified = [pkg.EngineSpec(plan=_plan(pkg_plan, False), n_slots=2, s_max=32),
               pkg.EngineSpec(plan=_plan(pkg_plan, True), n_slots=8, s_max=128)]
    roles = [pkg.EngineSpec(plan=_plan(pkg_plan, False), n_slots=8, s_max=128, role="prefill"),
             pkg.EngineSpec(plan=_plan(pkg_plan, False), n_slots=8, s_max=128, role="decode")]
    features_fn = (lambda s: f["small"] if s.n_slots == 2 else  # noqa: E731
                   f["big"] if s.role != "prefill" else f["wired"])
    cap = pkg.estimate(f["small"], pkg.A100).throughput_tok_s
    demand = {"phi": pkg.LabelDemand(rate=1.7 * cap / 16.0, prompt_len=40.0, queued=6.0),
              "general": pkg.LabelDemand(rate=0.3 * cap / 16.0),
              "audio": pkg.LabelDemand(rate=0.0)}
    kw = dict(specs=unified, profiles=[pkg.A100, pkg.L40S], features_fn=features_fn)
    targets = {}
    if case == "bounds_and_route":
        kw.update(bounds={"phi": (1, 6), "audio": (2, 2)},
                  route_required={"phi": _plan(pkg_plan, True)})
    elif case == "slo_targets":
        idle = pkg.estimate(f["small"], pkg.A100, pkg.TrafficMix())
        targets = {"phi": (idle.prefill_s * 3.0, None), "general": (None, idle.tpot_s * 0.5)}
    elif case == "disaggregated":
        kw["specs"] = unified + roles
    elif case == "infeasible":
        kw.update(specs=[pkg.EngineSpec(plan=pkg_plan.ShardingPlan(
            device_constraints=(("pod", 1),)))],
            route_required={"phi": _plan(pkg_plan, True)})
    return demand, targets, kw


def _candidate_fields(c):
    config = {label: tuple((a.spec.n_slots, a.spec.s_max, a.spec.role,
                            dataclasses.astuple(a.spec.plan), dataclasses.astuple(a.profile),
                            a.count) for a in la.assignments)
              for label, la in c.config.items()}
    return (config, c.violations, c.cost, c.headroom,
            {k: _asdict(v) for k, v in c.per_label.items()}, c.infeasible)


@pytest.mark.parametrize("case", ["plain", "bounds_and_route", "slo_targets",
                                  "disaggregated", "infeasible"])
def test_search_equals_reference(case):
    out = []
    for pkg, pkg_plan in ((jplanner, jplan), (tplanner, tplan)):
        demand, targets, kw = _search_case(pkg, pkg_plan, case)
        best = pkg.best_candidate(demand, targets, **kw)
        current = {label: (a.spec, a.profile, a.count) for label, a in best.config.items()
                   if not a.disaggregated}
        current["phi"] = (kw["specs"][0], pkg.L40S, 1)
        score = pkg.score_current(current, demand, targets, features_fn=kw["features_fn"],
                                  interference=case == "disaggregated")
        kept = pkg.eligible_specs(kw["specs"], _plan(pkg_plan, True))
        out.append((_candidate_fields(best), _candidate_fields(score),
                    [dataclasses.astuple(s.plan) for s in kept]))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# features_from_engine: the decode step counted against the compiled HLO
# ---------------------------------------------------------------------------

# the port's bytes over the reference's (PERF.md: definitions and values)
BYTES_RATIO = {("minitron_4b", 2, 32): 0.583, ("minitron_4b", 4, 64): 0.552,
               ("minitron_4b", 8, 128): 0.523, ("qwen2_moe_a2_7b", 2, 32): 0.536,
               ("mamba2_370m", 2, 32): 0.913}


@pytest.mark.parametrize("case", list(BYTES_RATIO), ids=lambda c: "-".join(map(str, c)))
def test_features_match_reference_count(case):
    arch, n_slots, s_max = case
    _, jmodel, jparams, tmodel = tiny(arch)
    want = jplanner.features_from_engine(
        jserving.ServingEngine(jmodel, jparams, n_slots=n_slots, s_max=s_max))
    eng = ServingEngine(tmodel, n_slots=n_slots, s_max=s_max, device="cpu")
    before = {k: v.clone() for k, v in eng.cache.items()}
    got = features_from_engine(eng, tserving.ServingCluster(device="cpu").mesh)
    assert abs(got.flops / want.flops - 1.0) < 0.05
    assert got.bytes / want.bytes == pytest.approx(BYTES_RATIO[case], rel=0.10)
    assert (got.param_bytes, got.kv_bytes, got.kv_tokens, got.wire_bytes,
            got.n_slots, got.s_max) == (want.param_bytes, want.kv_bytes, want.kv_tokens,
                                        want.wire_bytes, want.n_slots, want.s_max)
    # counted on meta tensors: the live pool is untouched
    assert all(torch.equal(eng.cache[k], v) for k, v in before.items())
    assert features_from_engine(eng) == got


def test_features_refuse_a_multi_device_mesh(port):
    mesh = tplan.Mesh(np.array([torch.device("cpu")] * 2, dtype=object).reshape(1, 2, 1))
    with pytest.raises(ValueError, match="one device"):
        features_from_engine(_mk(port[1]), mesh)


# ---------------------------------------------------------------------------
# the planner's decisions: the same actions on both packages
# ---------------------------------------------------------------------------


def _planner_side(pkg_serving, pkg_planner, pkg_plan, make, feats):
    cluster = (pkg_serving.ServingCluster(device="cpu") if pkg_serving is tserving
               else pkg_serving.ServingCluster())
    spec = pkg_planner.EngineSpec(plan=pkg_plan.default_plan(), n_slots=2, s_max=32)
    planner = pkg_planner.WorkloadPlanner(
        cluster, lambda s, label: make(n_slots=s.n_slots, s_max=s.s_max), specs=[spec],
        profiles=[pkg_planner.L40S, pkg_planner.A100], dwell=1)
    key = (spec.n_slots, spec.s_max,
           spec.plan.with_(device_constraints=(), forbidden_collective_axes=()))
    planner._features[key] = pkg_planner.CostFeatures(**dataclasses.asdict(feats))
    return cluster, planner


def _planner_rounds(side, rates):
    cluster, planner = side
    pkg = tplanner if isinstance(cluster, tserving.ServingCluster) else jplanner
    out = []
    for phi, gen in rates:
        demand = {"phi": pkg.LabelDemand(rate=phi), "general": pkg.LabelDemand(rate=gen)}
        actions = planner.plan(demand)
        planner.execute(actions, async_spawn=False)
        cluster.run()
        out.append(([(a.kind, a.label, a.engine, a.target, a.mode, a.role,
                      a.profile.name if a.profile else None) for a in actions],
                     {label: len(cluster.engines_for_label(label))
                      for label in ("phi", "general")}))
    return out


def test_planner_actions_equal_reference():
    """A rising phi burst over steady general traffic, then demand stops:
    the same actions and engine counts, round by round."""
    _, jmodel, jparams, tmodel = tiny()
    feats = jplanner.features_from_engine(
        jserving.ServingEngine(jmodel, jparams, n_slots=2, s_max=32))
    unit = jplanner.estimate(feats, jplanner.L40S).throughput_tok_s / 16.0
    rates = [(phi * unit, 0.5 * unit) for phi in (0.2, 0.5, 0.9, 1.4, 2.2, 2.2, 1.0)]
    rates += [(0.0, 0.0)] * 4
    sides = [
        _planner_side(jserving, jplanner, jplan,
                      lambda **kw: jserving.ServingEngine(jmodel, jparams, **kw), feats),
        _planner_side(tserving, tplanner, tplan,
                      lambda **kw: ServingEngine(tmodel, device="cpu", **kw), feats)]
    want, got = (_planner_rounds(s, rates) for s in sides)
    assert got == want
    kinds = [a[0] for acts, _ in want for a in acts]
    assert "spawn" in kinds and "retire" in kinds
    assert max(c["phi"] for _, c in want) >= 2 and want[-1][1] == {"phi": 0, "general": 0}


# ---------------------------------------------------------------------------
# mirrors of tests/test_planner.py: catalog
# ---------------------------------------------------------------------------


def test_catalog_profiles():
    assert get_profile("a100").peak_flops > get_profile("l40s").peak_flops
    assert A100.hbm_bw > L40S.hbm_bw
    assert A100.mem_bytes > L40S.mem_bytes
    with pytest.raises(KeyError):
        get_profile("h100-that-does-not-exist")


def test_profile_pool_scales_compute_not_link():
    p4 = A100.pool(4)
    assert p4.total_flops == pytest.approx(4 * A100.peak_flops)
    assert p4.total_hbm_bw == pytest.approx(4 * A100.hbm_bw)
    assert p4.total_mem_bytes == pytest.approx(4 * A100.mem_bytes)
    assert p4.link_bw == A100.link_bw
    assert p4.per_device().n_devices == 1
    with pytest.raises(ValueError):
        A100.pool(0)


def test_profile_scaled_preserves_ratios():
    a, l = A100.scaled(1e-6), L40S.scaled(1e-6)
    assert a.peak_flops / l.peak_flops == pytest.approx(A100.peak_flops / L40S.peak_flops)
    assert a.mem_bytes == A100.mem_bytes
    with pytest.raises(ValueError):
        A100.scaled(0.0)


def test_host_calibration_measures_positive_rates(host):
    assert host.peak_flops > 0 and host.hbm_bw > 0
    assert host.mem_bytes == 8 << 30 and host.link_bw > 0
    assert calibrate_host_profile(device="cpu") is host       # cached per device
    assert calibrate_host_profile(device="cpu", force=True, repeats=1) is not host


def test_host_calibration_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_host_profile()


# ---------------------------------------------------------------------------
# mirrors: estimator
# ---------------------------------------------------------------------------


def _measured_step_s(engine, n_requests, *, steps=30):
    """Median wall-clock decode-step latency at full occupancy (the first
    step admits; the clock starts after)."""
    rng = np.random.default_rng(0)
    for i in range(n_requests):
        engine.submit(_req(rng, engine.model.cfg, i, n=6, new=steps + 8))
    engine.step()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.step()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def test_estimator_ranking_matches_measured_step_latency(port, host):
    """The estimator's ranking of two engine shapes on the measured CPU
    profile equals the ranking of their measured step latencies. The big
    engine is (16, 512), not the reference's (8, 128): the eager CPU step
    spends ~1.5 ms dispatching its aten ops at any tiny shape, so (2, 32)
    and (8, 128) differ by ~0.5 ms, which a shared host's noise can flip;
    (16, 512) adds ~1.3 ms of work."""
    _, model = port
    small = _mk(model, n_slots=2, s_max=32)
    big = _mk(model, n_slots=16, s_max=512)
    est_small = estimate(features_from_engine(small), host)
    est_big = estimate(features_from_engine(big), host)
    meas_small = _measured_step_s(small, 2)
    meas_big = _measured_step_s(big, 16)
    assert est_small.step_s != est_big.step_s
    assert (est_small.step_s < est_big.step_s) == (meas_small < meas_big), (
        f"estimator ranked {est_small.step_s:.2e} vs {est_big.step_s:.2e} "
        f"but measurement says {meas_small:.2e} vs {meas_big:.2e}")


def test_estimate_memory_fit_is_profile_sensitive(feats):
    big = DeviceProfile("big", 1e12, 1e12, mem_bytes=1e12, link_bw=1e12)
    small = DeviceProfile("tiny", 1e12, 1e12, mem_bytes=feats.resident_bytes / 2,
                          link_bw=1e12)
    assert estimate(feats, big).fits
    est = estimate(feats, small)
    assert not est.fits
    assert not est.meets(None, None)


def test_estimate_load_sensitivity(feats, host):
    idle = estimate(feats, host, TrafficMix(prompt_len=8, new_tokens=4, rate=0.0))
    cap = idle.throughput_tok_s / 4.0
    loaded = estimate(feats, host, TrafficMix(prompt_len=8, new_tokens=4, rate=0.5 * cap))
    swamped = estimate(feats, host, TrafficMix(prompt_len=8, new_tokens=4, rate=2.0 * cap))
    assert idle.ttft_s < loaded.ttft_s < math.inf
    assert math.isinf(swamped.ttft_s)
    assert idle.tpot_s == loaded.tpot_s == swamped.tpot_s
    pooled = estimate(feats, host, TrafficMix(prompt_len=8, new_tokens=4, rate=0.5 * cap),
                      engines=4)
    assert pooled.utilization < loaded.utilization


# ---------------------------------------------------------------------------
# mirrors: search
# ---------------------------------------------------------------------------


def test_search_prunes_fail_closed(feats, host):
    required = ShardingPlan(device_constraints=(("pod", 0),))
    ok = EngineSpec(plan=default_plan())
    conflicted = EngineSpec(plan=default_plan().with_(device_constraints=(("pod", 1),)))
    kept = eligible_specs([ok, conflicted], required)
    assert len(kept) == 1
    assert dict(kept[0].plan.device_constraints).get("pod") == 0
    best = best_candidate({"phi": LabelDemand(rate=1.0)}, {}, specs=[conflicted],
                          profiles=[host], features_fn=_flat(feats),
                          route_required={"phi": required})
    assert best.infeasible == ["phi"]
    assert "phi" not in best.config


def test_search_respects_scale_bounds(feats, host):
    spec = EngineSpec(plan=default_plan())
    best = best_candidate({"phi": LabelDemand(rate=0.0)}, {}, specs=[spec], profiles=[host],
                          features_fn=_flat(feats), bounds={"phi": (2, 3)})
    assert best.config["phi"].count == 2
    best0 = best_candidate({"phi": LabelDemand(rate=0.0)}, {}, specs=[spec], profiles=[host],
                           features_fn=_flat(feats), bounds={"phi": (0, 3)})
    assert best0.config["phi"].count == 0


def test_search_picks_cheaper_profile_when_both_suffice(feats):
    best = best_candidate({"gen": LabelDemand(rate=0.0)}, {},
                          specs=[EngineSpec(plan=default_plan())], profiles=[A100, L40S],
                          features_fn=_flat(feats), bounds={"gen": (1, 2)})
    assert best.config["gen"].profile.name == "l40s"
    assert best.cost == pytest.approx(L40S.cost_rate)


def test_search_hetero_choice_differs_between_profiles(feats):
    spec = EngineSpec(plan=default_plan())
    cap_a = estimate(feats, A100).throughput_tok_s
    demand = {"phi": LabelDemand(rate=0.7 * cap_a / 16.0)}
    best_a = best_candidate(demand, {}, specs=[spec], profiles=[A100],
                            features_fn=_flat(feats))
    best_l = best_candidate(demand, {}, specs=[spec], profiles=[L40S],
                            features_fn=_flat(feats))
    assert best_a.violations == 0 and best_l.violations == 0
    assert best_a.config["phi"].count < best_l.config["phi"].count


def test_search_slo_target_forces_capacity(feats, host):
    spec = EngineSpec(plan=default_plan())
    idle = estimate(feats, host, TrafficMix())
    demand = {"phi": LabelDemand(rate=0.8 * idle.throughput_tok_s / 16.0)}
    relaxed = best_candidate(demand, {}, specs=[spec], profiles=[host],
                             features_fn=_flat(feats))
    tight = best_candidate(demand, {"phi": (idle.prefill_s * 2.0, None)}, specs=[spec],
                           profiles=[host], features_fn=_flat(feats))
    assert tight.violations == 0
    assert tight.config["phi"].count > relaxed.config["phi"].count


@pytest.mark.parametrize("demand_x,bounds,cap,want", [
    (20.0, (0, 4), 4, "max"),          # overload scales up, not down
    (5.5, (0, 8), 4, "above_cap"),     # an explicit max above the cap holds
], ids=["overload_scales_up", "explicit_max_not_capped"])
def test_search_sizes_to_demand_past_the_cap(feats, host, demand_x, bounds, cap, want):
    spec = EngineSpec(plan=default_plan())
    cap1 = estimate(feats, host).throughput_tok_s
    best = best_candidate({"phi": LabelDemand(rate=demand_x * cap1 / 16.0)}, {},
                          specs=[spec], profiles=[host], features_fn=_flat(feats),
                          bounds={"phi": bounds}, max_engines_per_label=cap)
    if want == "max":
        assert best.config["phi"].count == 4 and best.violations > 0
    else:
        assert best.config["phi"].count > 4 and best.violations == 0


# ---------------------------------------------------------------------------
# mirrors: WorkloadPlanner end to end
# ---------------------------------------------------------------------------


def _mk_planner(model, cluster, profiles, **kw):
    spec = EngineSpec(plan=default_plan(), n_slots=2, s_max=32)
    kw.setdefault("dwell", 0)
    return WorkloadPlanner(
        cluster, lambda s, label: _mk(model, n_slots=s.n_slots, s_max=s.s_max),
        specs=[spec], profiles=profiles, **kw)


def test_planner_spawns_through_async_tickets(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    planner = _mk_planner(model, cluster, [A100])
    cap = estimate(planner.features_for(planner.specs[0]), A100).throughput_tok_s
    demand = {"phi": LabelDemand(rate=0.7 * cap / 16.0)}
    actions = planner.plan(demand)
    assert [a.kind for a in actions] == ["spawn"]
    results = planner.execute(actions, async_spawn=True)
    assert all(isinstance(r, PrepareTicket) for _, r in results)
    assert cluster.pending_spawn_labels().get("phi", 0) \
        + len(cluster.engines_for_label("phi")) == 1
    assert planner.plan(demand) == []
    cluster.run(wait_pending=True)
    assert len(cluster.engines_for_label("phi")) == 1
    assert cluster.engine(cluster.engines_for_label("phi")[0]).labels["data-type"] == "phi"


def test_planner_scales_down_when_demand_stops(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    planner = _mk_planner(model, cluster, [A100])
    cap = estimate(planner.features_for(planner.specs[0]), A100).throughput_tok_s
    planner.execute(planner.plan({"phi": LabelDemand(rate=0.7 * cap / 16.0)}),
                    async_spawn=False)
    assert len(cluster.engines_for_label("phi")) == 1
    actions = planner.plan({"phi": LabelDemand(rate=0.0)})
    assert [a.kind for a in actions] == ["retire"]
    planner.execute(actions)
    cluster.run()
    assert cluster.engines_for_label("phi") == []


@pytest.mark.parametrize("via", ["planner_bounds", "plan_argument"])
def test_planner_floor_is_mandatory(port, via):
    """A floor bypasses dwell and the amortization gate, whether pinned in
    ``planner.bounds`` or passed to ``plan(bounds=...)`` (the autoscaler's
    planner-mode path); once met, no cost-saving move fires."""
    _, model = port
    cluster = ServingCluster(device="cpu")
    planner = _mk_planner(model, cluster, [A100], dwell=3, horizon_s=0.0)
    if via == "planner_bounds":
        planner.bounds["phi"] = (1, 2)
        actions = planner.plan({})
    else:
        actions = planner.plan({}, bounds={"phi": (1, 2)})
    assert [a.kind for a in actions] == ["spawn"]
    assert "floor" in actions[0].reason
    planner.execute(actions, async_spawn=False)
    assert planner.plan({}, bounds={"phi": (1, 2)}) == []


def test_planner_infeasible_label_holds_fail_closed(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", ShardingPlan(device_constraints=(("pod", 0),)))
    planner = WorkloadPlanner(
        cluster, lambda spec, label: _mk(model),
        specs=[EngineSpec(plan=default_plan().with_(device_constraints=(("pod", 1),)))],
        profiles=[A100], dwell=0)
    actions = planner.plan({"phi": LabelDemand(rate=1.0)})
    assert [a.kind for a in actions] == ["hold"]
    assert planner.execute(actions) == [(actions[0], None)]
    assert cluster.engines() == []


def test_planner_apply_policy_installs_slo_and_bounds(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    planner = _mk_planner(model, cluster, [A100])
    orch = Orchestrator()
    res = orch.submit("Keep TTFT under 200 ms for phi traffic, and keep at least one "
                      "serving engine for phi traffic.", apply_to=planner)
    assert res.success, res.report.summary()
    assert planner.slo_targets["phi"] == (pytest.approx(0.2), None)
    assert planner.bounds["phi"] == (1, None)
    assert orch.state.slo_targets["phi"][0] == pytest.approx(0.2)
    planner.set_slo_target("phi", 0.5, 0.05)
    assert planner.slo_targets["phi"] == (pytest.approx(0.2), pytest.approx(0.05))


def test_autoscaler_planner_mode_records_events(port):
    cfg, model = port
    rng = np.random.default_rng(0)
    cluster = ServingCluster(device="cpu")
    cluster.register("base0", _mk(model))
    planner = _mk_planner(model, cluster, [A100])
    scaler = Autoscaler(cluster, lambda label: _mk(model), planner=planner,
                        tracker=LoadTracker(alpha=1.0), bounds={"phi": (1, 2)})
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    executed = scaler.tick()
    assert any(d.kind == "spawn" and d.label == "phi" for d in executed)
    cluster.run()
    scaler.tick()
    assert any(d.kind == "spawn" for d, r in scaler.events)
    assert len(cluster.engines_for_label("phi")) >= 1
    assert scaler.trajectory
    cluster.run()
    assert cluster.metrics()["completed"] == 4


def test_attach_calibrated_profiles_measures_the_cluster_device(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("e", _mk(model))
    planner = _mk_planner(model, cluster, [A100])
    profile = planner.attach_calibrated_profiles()
    assert profile is calibrate_host_profile(device="cpu") and profile.name == "host"
    assert planner._profile_of("e") is profile


# ---------------------------------------------------------------------------
# mirrors: online calibration
# ---------------------------------------------------------------------------


def test_calibration_cold_start_equals_analytical_exactly(feats, host):
    calib = ResidualCalibration()
    analytical = estimate(feats, host, engines=2)
    assert calib.factors("phi") == (1.0, 1.0)
    assert calib.apply("phi", analytical) is analytical
    assert dataclasses.asdict(calibrated_estimate(
        feats, host, engines=2, calibration=calib, label="phi")) \
        == dataclasses.asdict(analytical)
    assert dataclasses.asdict(calibrated_estimate(feats, host, engines=2)) \
        == dataclasses.asdict(analytical)


def test_calibration_strictly_reduces_error_on_corpus(feats, host):
    base = estimate(feats, host)
    rng = np.random.default_rng(42)
    calib = ResidualCalibration(alpha=0.3)
    k_ttft, k_tpot = 1.8, 0.4
    err_a = {"ttft": [], "tpot": []}
    err_c = {"ttft": [], "tpot": []}
    for _ in range(40):
        noise = 1.0 + 0.05 * rng.standard_normal(2)
        measured_ttft = base.ttft_s * k_ttft * float(noise[0])
        measured_tpot = base.tpot_s * k_tpot * float(noise[1])
        cal = calib.apply("phi", base)
        err_a["ttft"].append(abs(base.ttft_s - measured_ttft))
        err_a["tpot"].append(abs(base.tpot_s - measured_tpot))
        err_c["ttft"].append(abs(cal.ttft_s - measured_ttft))
        err_c["tpot"].append(abs(cal.tpot_s - measured_tpot))
        calib.observe("phi", predicted_ttft_s=base.ttft_s, predicted_tpot_s=base.tpot_s,
                      measured_ttft_s=measured_ttft, measured_tpot_s=measured_tpot)
    assert calib.n_observations("phi") == 40
    for key in ("ttft", "tpot"):
        assert np.mean(err_c[key]) < np.mean(err_a[key])
    f_ttft, f_tpot = calib.factors("phi")
    assert f_ttft == pytest.approx(k_ttft, rel=0.15)
    assert f_tpot == pytest.approx(k_tpot, rel=0.15)
    cal = calib.apply("phi", base)
    assert cal.step_s == base.step_s
    assert cal.throughput_tok_s == base.throughput_tok_s
    assert cal.mem_bytes == base.mem_bytes and cal.fits == base.fits


def test_calibration_rejects_degenerate_observations(feats, host):
    base = estimate(feats, host)
    calib = ResidualCalibration(ratio_cap=50.0)
    for bad in (float("nan"), float("inf"), 0.0, -1.0):
        calib.observe("phi", predicted_ttft_s=base.ttft_s, predicted_tpot_s=base.tpot_s,
                      measured_ttft_s=bad, measured_tpot_s=bad)
    assert calib.n_observations("phi") == 0
    assert calib.factors("phi") == (1.0, 1.0)
    calib.observe("phi", predicted_ttft_s=base.ttft_s, predicted_tpot_s=base.tpot_s,
                  measured_ttft_s=base.ttft_s * 1e6, measured_tpot_s=base.tpot_s / 1e6)
    f_ttft, f_tpot = calib.factors("phi")
    assert f_ttft == pytest.approx(50.0)
    assert f_tpot == pytest.approx(1.0 / 50.0)
    with pytest.raises(ValueError):
        ResidualCalibration(alpha=1.5)
    with pytest.raises(ValueError):
        ResidualCalibration(ratio_cap=0.5)


def test_planner_observe_measurement_closes_loop(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    planner = _mk_planner(model, cluster, [A100], calibration=ResidualCalibration(alpha=1.0))
    cap = estimate(planner.features_for(planner.specs[0]), A100).throughput_tok_s
    demand = LabelDemand(rate=0.5 * cap / 16.0)
    planner.execute(planner.plan({"phi": demand}), async_spawn=False)
    analytical = planner.predicted_for("phi", demand, calibrated=False)
    assert analytical is not None
    planner.observe_measurement("phi", demand, measured_ttft_s=3.0 * analytical.ttft_s,
                                measured_tpot_s=0.5 * analytical.tpot_s)
    calibrated = planner.predicted_for("phi", demand)
    assert calibrated.ttft_s == pytest.approx(3.0 * analytical.ttft_s)
    assert calibrated.tpot_s == pytest.approx(0.5 * analytical.tpot_s)
    again = planner.predicted_for("phi", demand, calibrated=False)
    assert again.ttft_s == pytest.approx(analytical.ttft_s)


def test_planner_keeps_live_capacity_while_a_spawn_prepares(port):
    """Demand drops while a spawn's PREPARE is in flight: the reference
    counts the pending spawn as deployed and retires the label's only live
    engine (its requests then fail closed until the spawn commits); the
    port keeps it live and retires once the spawn has committed."""
    import threading

    _, jmodel, jparams, tmodel = tiny()
    gate = threading.Event()

    def gated(eng, method):
        run = getattr(eng, method)
        setattr(eng, method, lambda *a, **kw: (gate.wait(60), run(*a, **kw))[1])
        return eng

    feats = jplanner.features_from_engine(
        jserving.ServingEngine(jmodel, jparams, n_slots=2, s_max=32))
    out = {}
    for name, pkg, S, make, method in (
            ("jax", jplanner, jserving,
             lambda: jserving.ServingEngine(jmodel, jparams, n_slots=2, s_max=32),
             "aot_executables"),
            ("torch", tplanner, tserving, lambda: _mk(tmodel), "prepare_executables")):
        gate.clear()
        cluster = S.ServingCluster(device="cpu") if S is tserving else S.ServingCluster()
        cluster.register("edge", make(), labels={"data-type": "phi"})
        spec = pkg.EngineSpec(plan=(tplan if S is tserving else jplan).default_plan(),
                              n_slots=2, s_max=32)
        planner = pkg.WorkloadPlanner(cluster, lambda s, label: gated(make(), method),
                                      specs=[spec], profiles=[pkg.A100], dwell=0)
        planner._features[(2, 32, spec.plan)] = pkg.CostFeatures(**dataclasses.asdict(feats))
        unit = pkg.estimate(feats, pkg.A100).throughput_tok_s / 16.0
        spawn = planner.plan({"phi": pkg.LabelDemand(rate=1.5 * unit)})
        planner.execute(spawn, async_spawn=True)
        low = planner.plan({"phi": pkg.LabelDemand(rate=0.1 * unit)})
        planner.execute(low)
        live = cluster.engines_for_label("phi")
        gate.set()
        cluster.run(wait_pending=True)
        after = planner.plan({"phi": pkg.LabelDemand(rate=0.1 * unit)})
        planner.execute(after)
        cluster.run()
        out[name] = ([a.kind for a in spawn], [(a.kind, a.engine) for a in low], live,
                     [a.kind for a in after], len(cluster.engines_for_label("phi")))
    assert out["jax"][:2] == (["spawn"], [("retire", "edge")]) and out["jax"][2] == []
    assert out["torch"] == (["spawn"], [], ["edge"], ["retire"], 1)
