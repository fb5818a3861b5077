"""The port's `ServingCluster` against the JAX cluster on the CPU, and the
cluster's own contracts.

Parity: one seeded trace goes through the `repro` cluster and the port's
cluster, on reduced fp32 models with the same weights
(`conftest.build_tiny_model`, carried over by `bridge.params_from_numpy`).
Routing choices and rejections, token streams, each `DowntimeReport`'s
event/engine/compiled_in_prepare/migrate_bytes, each `MigrationRecord`'s
rid/phase/batch/bytes (and the position the request resumed at), handoff
counts and the `metrics_by_label` keys must be equal.

Mirrors (port only): `tests/test_cluster.py`, the role and handoff tests of
`tests/test_disagg.py` (the port's recorded events stand in for the SLO
ledger, which is not ported), and `tests/test_concurrent_prepare.py`
without the autoscaler (not ported).
"""
import dataclasses
import functools
import threading
import time

import jax
import numpy as np
import pytest
from conftest import build_tiny_model

import repro.core as jcore
import repro.serving as jserving
import repro.sharding as jsharding
import repro_torch.core as tcore
import repro_torch.serving as tserving
import repro_torch.sharding as tsharding
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.core import Component, Orchestrator
from repro_torch.models import Model
from repro_torch.obs import Recorder, overlaps, recording
from repro_torch.serving import (
    METRIC_KEYS,
    EngineStateError,
    PrepareCancelled,
    Request,
    RoutingError,
    ServingCluster,
    ServingEngine,
)
from repro_torch.sharding import ShardingPlan, default_plan, plan_satisfies

PINNED = ShardingPlan(device_constraints=(("pod", 0),),
                      forbidden_collective_axes=("pod",))
PHI_CONSTRAINT = PINNED
PHI_INTENT = "Phi traffic must remain inside the pod."
DEADLINE_S = 120.0


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tiny(arch="minitron_4b"):
    """(cfg, JAX model, its params, the port's CPU model with the same
    weights) for a reduced fp32 config."""
    cfg, jmodel, jparams = build_tiny_model(arch)
    tcfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                               activ_dtype="float32")
    params = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return cfg, jmodel, jparams, Model(tcfg, params, device="cpu")


@dataclasses.dataclass
class Side:
    """One package's serving stack behind the same calls."""

    name: str
    serving: object
    core: object
    sharding: object
    engine: object       # (**engine kwargs) -> ServingEngine
    cluster: object      # () -> ServingCluster


def sides(arch="minitron_4b"):
    """The JAX package's side and the port's, over the same weights."""
    _, jmodel, jparams, tmodel = tiny(arch)
    return (
        Side("jax", jserving, jcore, jsharding,
             lambda **kw: jserving.ServingEngine(jmodel, jparams, **kw),
             jserving.ServingCluster),
        Side("torch", tserving, tcore, tsharding,
             lambda **kw: tserving.ServingEngine(tmodel, device="cpu", **kw),
             lambda: tserving.ServingCluster(device="cpu")),
    )


def prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in sizes]


def report_fields(r):
    return (r.event, r.engine, r.compiled_in_prepare, r.migrate_bytes,
            tuple(record_fields(m) for m in r.migrations))


def record_fields(m):
    return (m.rid, m.src, m.dst, m.phase, m.batch, m.bytes_moved, m.reason)


def resumed_at(cluster, name, rids):
    eng = cluster.engine(name)
    return {r.rid: int(eng.slot_pos[i]) for i, r in enumerate(eng.slot_req)
            if r is not None and r.rid in rids}


def trace_intent_migrate(side, vocab, new=6):
    """Four unlabeled and four phi requests over a phi-labeled and a
    general-labeled engine; the phi intent arrives mid-decode (sync), then
    two unlabeled decoding requests move edge0 -> edge1; at the end the only
    phi-compliant engine retires and a phi request is rejected."""
    S = side.serving
    cluster = side.cluster()
    cluster.register("edge0", side.engine(n_slots=4, s_max=32),
                     labels={"data-type": "phi"})
    cluster.register("edge1", side.engine(n_slots=4, s_max=32),
                     labels={"data-type": "general"})
    ps = prompts(vocab, (5, 7, 6, 8, 9, 5, 7, 6), seed=1)
    reqs = [S.Request(i, p, max_new_tokens=new,
                      labels={"data-type": "phi"} if i >= 4 else {})
            for i, p in enumerate(ps)]
    placed = [cluster.submit(r) for r in reqs]
    for _ in range(2):
        cluster.step()
    res = side.core.Orchestrator().submit(PHI_INTENT, apply_to=cluster)
    movable = [r.rid for r in cluster.engine("edge0").slot_req
               if r is not None and not r.labels][:2]
    records = cluster.migrate_requests("edge0", "edge1", movable)
    pos = resumed_at(cluster, "edge1", movable)
    cluster.run()
    retire = cluster.retire_engine("edge0")
    late = S.Request(99, ps[0], max_new_tokens=new, labels={"data-type": "phi"})
    try:
        placed.append(cluster.submit(late))
    except S.RoutingError:
        placed.append(None)
    return {
        "placed": placed,
        "rejected": [r.rid for r in cluster.rejected],
        "streams": {r.rid: list(r.tokens_out) for r in reqs},
        "applied": res.success,
        "reports": {k: report_fields(v) for k, v in res.reports.items()},
        "retire": report_fields(retire),
        "records": [record_fields(m) for m in records],
        "resumed_at": pos,
        "constraints": {k: (v.device_constraints, v.forbidden_collective_axes)
                        for k, v in cluster.route_constraints().items()},
        "labels": sorted(cluster.metrics_by_label()),
        "completed": cluster.metrics()["completed"],
    }


def trace_handoff(side, vocab, new=8):
    """Prefill and decode engines: every request hands off at its first
    token; the decode tier (2 lanes) takes what fits, step by step."""
    S = side.serving
    cluster = side.cluster()
    cluster.register("pf", side.engine(n_slots=4, s_max=32), role="prefill")
    cluster.register("dc", side.engine(n_slots=2, s_max=32), role="decode")
    ps = prompts(vocab, (5, 7, 6, 8), seed=2)
    reqs = [S.Request(i, p, max_new_tokens=new) for i, p in enumerate(ps)]
    placed = [cluster.submit(r) for r in reqs]
    handoffs = []
    for _ in range(3 * new):
        if not cluster.engine("pf").load and not cluster.engine("dc").load:
            break
        cluster.step()
        handoffs.append(cluster.engine("dc").load)
    cluster.run()
    return {
        "placed": placed,
        "streams": {r.rid: list(r.tokens_out) for r in reqs},
        "dc_load_per_step": handoffs,
        "labels": sorted(cluster.metrics_by_label()),
        "by_role": cluster.metrics_by_label()["role:decode"]["completed"],
    }


def trace_slot_migrate(side, vocab, new=6):
    """Slot-granular engines (SSM state): two requests move mid-decode, then
    a migrate-mode retirement moves the rest."""
    S = side.serving
    cluster = side.cluster()
    cluster.register("a", side.engine(n_slots=4, s_max=32))
    cluster.register("b", side.engine(n_slots=4, s_max=32))
    ps = prompts(vocab, (5, 9, 6, 7), seed=3)
    reqs = [S.Request(i, p, max_new_tokens=new) for i, p in enumerate(ps)]
    for r in reqs:
        cluster.engine("a").submit(r)
    cluster.step()
    cluster.step()
    records = cluster.migrate_requests("a", "b", [1, 2])
    pos = resumed_at(cluster, "b", [1, 2])
    cluster.step()
    retire = cluster.retire_engine("a", mode="migrate")
    cluster.run()
    return {
        "streams": {r.rid: list(r.tokens_out) for r in reqs},
        "records": [record_fields(m) for m in records],
        "resumed_at": pos,
        "retire": report_fields(retire),
        "engines": cluster.engines(),
        "labels": sorted(cluster.metrics_by_label()),
    }


TRACES = {
    "intent_migrate-minitron": (trace_intent_migrate, "minitron_4b"),
    "intent_migrate-moe": (trace_intent_migrate, "qwen2_moe_a2_7b"),
    "handoff-minitron": (trace_handoff, "minitron_4b"),
    "slot_migrate-mamba2": (trace_slot_migrate, "mamba2_370m"),
}


@pytest.mark.parametrize("case", list(TRACES))
def test_seeded_trace_equals_reference_cluster(case):
    trace, arch = TRACES[case]
    vocab = tiny(arch)[0].vocab_size
    jax_side, torch_side = sides(arch)
    want = trace(jax_side, vocab)
    got = trace(torch_side, vocab)
    assert got == want
    if "records" in got:
        assert got["records"] and all(r[3] == "decoding" for r in got["records"])


def _unmigrated(model_side, vocab, sizes, seed, new, n_slots=4):
    eng = model_side.engine(n_slots=n_slots, s_max=32)
    reqs = [model_side.serving.Request(i, p, max_new_tokens=new)
            for i, p in enumerate(prompts(vocab, sizes, seed))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: list(r.tokens_out) for r in reqs}


@pytest.mark.parametrize("case", ["handoff-minitron", "slot_migrate-mamba2"])
def test_moved_streams_equal_an_unmigrated_port_run(case):
    """Handed-off and migrated streams are bitwise those of one unified
    port engine of the same ``n_slots`` (decode is row-wise at batch
    ``n_slots``)."""
    trace, arch = TRACES[case]
    vocab = tiny(arch)[0].vocab_size
    _, side = sides(arch)
    got = trace(side, vocab)["streams"]
    sizes, seed, new = {"handoff-minitron": ((5, 7, 6, 8), 2, 8),
                        "slot_migrate-mamba2": ((5, 9, 6, 7), 3, 6)}[case]
    assert got == _unmigrated(side, vocab, sizes, seed, new)


# ---------------------------------------------------------------------------
# the port alone: mirrors of tests/test_cluster.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port():
    """(cfg, port CPU model) of reduced fp32 minitron."""
    cfg, _, _, model = tiny()
    return cfg, model


def _mk(model, **kw):
    return ServingEngine(model, **{"n_slots": 2, "s_max": 32, "device": "cpu", **kw})


def _req(rng, cfg, rid, labels=None, *, n=6, new=4):
    if isinstance(labels, str):
        labels = {"data-type": labels}
    return Request(rid, rng.integers(2, cfg.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=new, labels=labels or {})


def test_plan_satisfaction_relation():
    assert plan_satisfies(PINNED, PHI_CONSTRAINT)
    assert not plan_satisfies(default_plan(), PHI_CONSTRAINT)
    assert plan_satisfies(ShardingPlan(device_constraints=(("pod", 0),)),
                          ShardingPlan(forbidden_collective_axes=("pod",)))
    assert not plan_satisfies(ShardingPlan(device_constraints=(("pod", 1),),
                                           forbidden_collective_axes=("pod",)),
                              PHI_CONSTRAINT)


def test_cluster_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingCluster()
    assert ServingCluster(device="cpu").mesh.devices.shape == (1, 1, 1)


def test_labeled_routing_lands_only_on_compliant_engines(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("pinned", _mk(model), plan=PINNED)
    cluster.register("open", _mk(model), plan=default_plan())
    cluster.set_route_constraint("phi", PHI_CONSTRAINT)
    rng = np.random.default_rng(0)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi"))
    assert cluster.engine("open").load == 0
    assert cluster.engine("pinned").load == 4
    assert cluster.submit(_req(rng, cfg, 10, "general")) == "open"


def test_trace_interleaves_routing_and_fail_closed(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("pinned", _mk(model), plan=PINNED)
    cluster.set_route_constraint("phi", PHI_CONSTRAINT)
    cluster.set_route_constraint("audio", ShardingPlan(device_constraints=(("pod", 1),)))
    rng = np.random.default_rng(20)
    trace = [_req(rng, cfg, 0, "phi", new=3), _req(rng, cfg, 1, "audio", new=3),
             _req(rng, cfg, 2, "phi", new=3)]
    placed = []
    for r in trace:
        try:
            placed.append(cluster.submit(r))
        except RoutingError:
            placed.append(None)
        cluster.step()
    cluster.run()
    assert placed == ["pinned", None, "pinned"]
    assert [r.rid for r in cluster.rejected] == [1]
    assert cluster.metrics()["completed"] == 2
    assert all(len(trace[i].tokens_out) == 3 for i in (0, 2))


def test_unroutable_request_fails_closed(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("open", _mk(model), plan=default_plan())
    cluster.set_route_constraint("phi", PHI_CONSTRAINT)
    rng = np.random.default_rng(1)
    with pytest.raises(RoutingError):
        cluster.submit(_req(rng, cfg, 0, "phi"))
    assert len(cluster.rejected) == 1
    cluster2 = ServingCluster(device="cpu")
    cluster2.register("general-only", _mk(model, labels={"data-type": "general"}),
                      plan=PINNED)
    with pytest.raises(RoutingError):
        cluster2.submit(_req(rng, cfg, 1, "phi"))


def test_lifecycle_state_machine(port):
    _, model = port
    eng = _mk(model)
    with pytest.raises(EngineStateError):
        eng.swap_plan(PINNED)
    eng.pause()
    with pytest.raises(EngineStateError):
        eng.step()
    assert eng.drain() == 0
    eng.swap_plan(PINNED)
    assert eng.plan is PINNED
    eng.resume()
    assert eng.step() == 0


def test_swap_plan_counts_params_and_cache_and_never_moves_shared_params(port):
    import torch
    _, model = port
    eng = _mk(model)
    eng.pause()
    assert eng.swap_plan(PINNED) == 0                       # no placement
    params_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(model.params))
    cache_bytes = sum(t.numel() * t.element_size() for t in eng.cache.values())
    before = {k: v.data_ptr() for k, v in eng.cache.items()}
    cpu = torch.device("cpu")
    assert eng.swap_plan(PINNED, placement={"params": cpu, "cache": cpu}) \
        == params_bytes + cache_bytes
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == before
    with pytest.raises(ValueError, match="params"):
        eng.swap_plan(PINNED, placement={"params": torch.device("meta"), "cache": cpu})


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_metrics_always_full_key_set(port):
    _, model = port
    eng = _mk(model)
    m = eng.metrics()
    assert set(m) == set(METRIC_KEYS)
    assert m["completed"] == 0 and np.isnan(m["ttft_mean_s"])
    cluster = ServingCluster(device="cpu")
    cluster.register("e", eng)
    assert set(cluster.metrics()) == set(METRIC_KEYS)


def test_swap_preserves_tokens_and_prepare_outweighs_the_window(port):
    cfg, model = port
    rng = np.random.default_rng(2)
    ps = [rng.integers(2, cfg.vocab_size, size=6).astype(np.int32) for _ in range(4)]
    ref = _mk(model)
    for rid, p in enumerate(ps):
        ref.submit(Request(rid, p, max_new_tokens=4))
    ref.run()
    expect = {r.rid: r.tokens_out for r in ref.done}

    cluster = ServingCluster(device="cpu")
    eng = _mk(model)
    cluster.register("e", eng)
    for rid, p in enumerate(ps[:2]):
        cluster.submit(Request(rid, p, max_new_tokens=4))
    cluster.step()
    report = cluster.reconfigure("e", PINNED, prefill_lengths=(6,))
    for rid, p in enumerate(ps[2:], start=2):
        cluster.submit(Request(rid, p, max_new_tokens=4))
    cluster.run()
    assert report.compiled_in_prepare == 2          # decode + prefill(6)
    assert report.prepare_s > 0 and report.downtime_s >= 0
    assert report.downtime_s < report.prepare_s
    assert report.migrate_bytes > 0
    assert eng.plan is PINNED
    assert {r.rid: r.tokens_out for r in eng.done} == expect


def test_prepare_touches_no_live_state(port):
    """PREPARE runs beside live decode: it warms on scratch state and
    leaves every live pool row, table and lane as it was."""
    cfg, model = port
    rng = np.random.default_rng(3)
    eng = _mk(model, n_slots=2)
    for rid in range(2):
        eng.submit(_req(rng, cfg, rid, new=6))
    eng.step()
    snap = {k: v.clone() for k, v in eng.cache.items()}
    tables = eng.page_tables.copy()
    import torch
    execs, n = eng.prepare_executables({"params": torch.device("cpu"),
                                        "cache": torch.device("cpu")},
                                       prefill_lengths=(6, 9), prefill_buckets=True)
    assert n == 1 + 2 + len(eng.bucket_lengths())
    assert sorted(execs["prefill"]) == [6, 9]
    assert sorted(execs["prefill_buckets"]) == eng.bucket_lengths()
    assert all(torch.equal(snap[k], eng.cache[k]) for k in snap)
    assert (eng.page_tables == tables).all()
    assert eng.load == 2


def test_apply_policy_conflicting_pins_stay_fail_closed(port):
    _, model = port
    comps = (Component("phi-a", {"data-type": "phi"}),
             Component("phi-b", {"data-type": "phi"}))

    class FakePolicy:
        plan_updates = {"phi-a": ShardingPlan(device_constraints=(("pod", 0),)),
                        "phi-b": ShardingPlan(device_constraints=(("pod", 1),))}

    cluster = ServingCluster(device="cpu")
    cluster.register("open", _mk(model), plan=default_plan())
    reports = cluster.apply_policy(FakePolicy(), components=comps)
    required = cluster.route_constraints()["phi"]
    assert required.forbidden_collective_axes == ("pod",)
    assert not plan_satisfies(default_plan(), required)
    assert "open" in reports
    assert plan_satisfies(cluster.engine("open").plan, required)

    class EmptyPolicy:
        plan_updates = {"phi-a": ShardingPlan()}

    cluster2 = ServingCluster(device="cpu")
    cluster2.register("e", _mk(model))
    cluster2.apply_policy(EmptyPolicy(), components=comps)
    assert cluster2.route_constraints() == {}


def test_e2e_intent_reconfigure_serve_roundtrip(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("edge0", _mk(model))
    rng = np.random.default_rng(3)
    for rid in range(2):
        cluster.submit(_req(rng, cfg, rid, "phi", new=3))
    cluster.run()
    res = Orchestrator().submit(PHI_INTENT, apply_to=cluster)
    assert res.success and "reconfigure" in res.timings
    report = res.reports["edge0"]
    assert report.downtime_s >= 0 and report.prepare_s > 0
    assert report.compiled_in_prepare > 0
    assert set(report.metrics_before) == set(METRIC_KEYS)
    assert report.metrics_before["completed"] == 2
    phi_req = _req(rng, cfg, 100, "phi", new=3)
    assert cluster.eligible(phi_req) == ["edge0"]
    assert "pod" in cluster.engine("edge0").plan.forbidden_collective_axes
    cluster.submit(phi_req)
    cluster.run()
    assert set(report.metrics_after) == set(METRIC_KEYS)
    assert report.metrics_after["completed"] == 1
    assert report.metrics_after["ttft_mean_s"] > 0


def test_multi_key_selector_route_fail_closed(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("pinned", _mk(model), plan=PINNED)
    cluster.register("open", _mk(model), plan=default_plan())
    cluster.set_route_predicate({"data-type": "phi", "app": "patient"}, PHI_CONSTRAINT)
    rng = np.random.default_rng(0)
    assert cluster.submit(_req(rng, cfg, 0, {"data-type": "phi", "app": "patient"})) == "pinned"
    cluster.submit(_req(rng, cfg, 1, "phi"))
    assert cluster.engine("open").load + cluster.engine("pinned").load == 2
    cluster.retire_engine("pinned")
    cluster.run()
    with pytest.raises(RoutingError):
        cluster.submit(_req(rng, cfg, 2, {"data-type": "phi", "app": "patient"}))
    assert cluster.rejected[-1].rid == 2


def test_predicate_route_and_merge_with_data_type(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("pinned", _mk(model), plan=PINNED)
    cluster.set_route_predicate(lambda labels: labels.get("tier") == "gold",
                                ShardingPlan(device_constraints=(("pod", 0),)))
    rng = np.random.default_rng(0)
    assert cluster.submit(_req(rng, cfg, 0, {"tier": "gold"})) == "pinned"
    cluster.set_route_constraint("phi", ShardingPlan(device_constraints=(("pod", 1),)))
    req = cluster.required_for({"data-type": "phi", "tier": "gold"})
    assert "pod" in req.forbidden_collective_axes
    assert not dict(req.device_constraints)
    assert plan_satisfies(PINNED, req)
    assert not plan_satisfies(default_plan(), req)
    assert cluster.submit(_req(rng, cfg, 1, {"data-type": "phi", "tier": "gold"})) == "pinned"


def test_selector_route_constrains_migration(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model), plan=PINNED)
    cluster.register("dst", _mk(model), plan=default_plan())
    rng = np.random.default_rng(0)
    cluster.submit(_req(rng, cfg, 0, {"data-type": "phi", "app": "patient"}))
    cluster.set_route_predicate({"data-type": "phi", "app": "patient"}, PHI_CONSTRAINT)
    with pytest.raises(RoutingError):
        cluster.migrate_requests("src", "dst")


# ---------------------------------------------------------------------------
# roles and the first-token handoff (mirrors of tests/test_disagg.py)
# ---------------------------------------------------------------------------


def test_engine_role_validation(port):
    _, model = port
    eng = _mk(model, role="prefill")
    assert eng.role == "prefill"
    with pytest.raises(ValueError):
        eng.role = "verifier"
    with pytest.raises(ValueError):
        _mk(model, role="Prefill")


def test_decode_engines_never_take_new_requests(port):
    cfg, model = port
    rng = np.random.default_rng(0)
    cluster = ServingCluster(device="cpu")
    cluster.register("dc", _mk(model), role="decode")
    with pytest.raises(RoutingError):
        cluster.submit(_req(rng, cfg, 0))
    assert [r.rid for r in cluster.rejected] == [0]
    cluster.register("pf", _mk(model), role="prefill")
    assert cluster.submit(_req(rng, cfg, 1)) == "pf"


def test_handoff_streams_bitwise_identical_with_accounting(port):
    """Requests admitted to a prefill engine hand off at their first token
    to the decode engine; streams equal the unified run's, and the
    handoff shows in the recorded events and the per-role metrics."""
    cfg, model = port
    ps = prompts(cfg.vocab_size, (5, 7, 6, 8), seed=1)
    ref = _mk(model, n_slots=4)
    for i, p in enumerate(ps):
        ref.submit(Request(i, p, max_new_tokens=8))
    ref.run()
    expect = {r.rid: list(r.tokens_out) for r in ref.done}
    with recording(Recorder()) as rec:
        cluster = ServingCluster(device="cpu")
        cluster.register("pf", _mk(model, n_slots=4), role="prefill")
        cluster.register("dc", _mk(model, n_slots=4), role="decode")
        reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
        for r in reqs:
            assert cluster.submit(r) == "pf"
        cluster.step()
        assert cluster.engine("pf").load == 0
        assert cluster.engine("dc").load == 4
        cluster.run()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect
    pauses = rec.events("migration.pause")
    assert len(pauses) == 4 and all(e.data["reason"] == "handoff" for e in pauses)
    assert all(e.data["batch"] == 4 for e in pauses)
    (cohort,) = rec.events("cluster.handoff")
    assert cohort.data["moved"] == 4
    assert cohort.data["pause_max_s"] == max(e.data["pause_s"] for e in pauses)
    assert any(s.name == "migration.pause" for s in rec.trace.spans())
    done = rec.events("request.complete")
    assert sorted(e.rid for e in done) == [0, 1, 2, 3]
    assert {e.data["role"] for e in done} == {"decode"}
    assert {e.data["role"] for e in rec.events("request.admit")} == {"prefill"}
    m = cluster.metrics_by_label()
    assert m["role:decode"]["completed"] == 4
    assert "role:prefill" not in m


def test_handoff_respects_decode_capacity(port):
    cfg, model = port
    ps = prompts(cfg.vocab_size, (6, 6, 6, 6), seed=2)
    ref = _mk(model, n_slots=4)
    for i, p in enumerate(ps):
        ref.submit(Request(i, p, max_new_tokens=8))
    ref.run()
    expect = {r.rid: list(r.tokens_out) for r in ref.done}
    cluster = ServingCluster(device="cpu")
    cluster.register("pf", _mk(model, n_slots=4), role="prefill")
    cluster.register("dc", _mk(model, n_slots=2), role="decode")
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
    for r in reqs:
        cluster.submit(r)
    cluster.step()
    assert cluster.engine("dc").load == 2
    assert cluster.engine("pf").load == 2
    cluster.run()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


# ---------------------------------------------------------------------------
# concurrent PREPARE (mirrors of tests/test_concurrent_prepare.py)
# ---------------------------------------------------------------------------


def _serve_until_done(cluster, ticket, deadline_s=DEADLINE_S):
    t0 = time.monotonic()
    while not ticket.done():
        assert time.monotonic() - t0 < deadline_s, f"ticket stuck: {ticket!r}"
        if cluster.step() == 0:
            time.sleep(0.002)


def test_reconfigure_async_overlaps_serving_and_is_token_exact(port):
    cfg, model = port
    ps = prompts(cfg.vocab_size, (6,) * 6, seed=0)
    ref = _mk(model)
    for i, p in enumerate(ps):
        ref.submit(Request(i, p, max_new_tokens=6))
    ref.run()
    expect = {r.rid: list(r.tokens_out) for r in ref.done}
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", _mk(model))
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(ps)]
    for r in reqs[:4]:
        cluster.submit(r)
    cluster.step()
    ticket = cluster.reconfigure_async("e0", PINNED, prefill_lengths=(6,))
    assert not ticket.done()
    assert cluster.prepare_pending() == [ticket]
    _serve_until_done(cluster, ticket)
    assert ticket.state == "swapped"
    report = ticket.result()
    assert report.engine == "e0" and report.event == "reconfigure"
    assert report.compiled_in_prepare == 2
    assert cluster.engine("e0").plan is PINNED
    for r in reqs[4:]:
        cluster.submit(r)
    cluster.run()
    assert cluster.pending_reports() == []
    assert set(report.metrics_after) == set(METRIC_KEYS)
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


def test_superseded_pending_swap_never_installs(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    eng = _mk(model)
    cluster.register("e0", eng)
    installs = []
    real_swap = eng.swap_plan
    eng.swap_plan = lambda *a, **kw: (installs.append(kw.get("executables")),
                                      real_swap(*a, **kw))[1]
    ticket_a = cluster.reconfigure_async("e0", default_plan(), prefill_lengths=(6,))
    assert ticket_a.wait_ready(DEADLINE_S)
    assert ticket_a.state == "ready"
    ticket_b = cluster.reconfigure_async("e0", PINNED, prefill_lengths=(7,))
    assert ticket_a.state == "cancelled"
    assert ticket_a.superseded_by is ticket_b
    _serve_until_done(cluster, ticket_b)
    assert ticket_b.state == "swapped"
    assert cluster.engine("e0").plan is PINNED
    assert len(installs) == 1 and sorted(installs[0]["prefill"]) == [7]
    with pytest.raises(PrepareCancelled):
        ticket_a.result()
    assert cluster.prepare_pending() == []


def test_ticket_cancel_before_commit_keeps_old_plan(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", _mk(model))
    old_plan = cluster.engine("e0").plan
    ticket = cluster.reconfigure_async("e0", PINNED)
    assert ticket.cancel()
    cluster.run(wait_pending=True)
    assert cluster.engine("e0").plan is old_plan
    assert cluster.prepare_pending() == []
    assert ticket.state == "cancelled"
    assert not ticket.cancel()


def test_retire_cancels_pending_ticket(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", _mk(model))
    cluster.register("e1", _mk(model))
    ticket = cluster.reconfigure_async("e0", PINNED)
    cluster.retire_engine("e0")
    assert ticket.state == "cancelled"
    cluster.run(wait_pending=True)
    assert "e0" not in cluster.engines()


def test_spawn_engine_async_joins_pool_only_at_commit(port):
    cfg, model = port
    rng = np.random.default_rng(1)
    cluster = ServingCluster(device="cpu")
    cluster.register("base", _mk(model))
    for rid in range(4):
        cluster.submit(_req(rng, cfg, rid, "phi", new=3))
    ticket = cluster.spawn_engine_async(
        "phi-1", _mk(model), labels={"data-type": "phi"},
        prefill_lengths=cluster.label_prompt_lengths("phi"))
    assert "phi-1" not in cluster.engines()
    assert cluster.pending_spawns() == ["phi-1"]
    with pytest.raises(ValueError):
        cluster.spawn_engine_async("phi-1", _mk(model))
    with pytest.raises(ValueError):
        cluster.register("phi-1", _mk(model))
    _serve_until_done(cluster, ticket)
    assert ticket.state == "swapped"
    assert "phi-1" in cluster.engines()
    report = ticket.result()
    assert report.event == "spawn" and report.compiled_in_prepare == 2
    for rid in range(10, 14):
        cluster.submit(_req(rng, cfg, rid, "phi", new=3))
    cluster.run()
    assert cluster.pending_reports() == []
    assert report.metrics_after["completed"] > 0


def test_failed_spawn_releases_its_name_reservation(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    eng = _mk(model)
    eng.prepare_executables = lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("boom"))
    ticket = cluster.spawn_engine_async("phi-1", eng)
    assert ticket.wait(DEADLINE_S) and ticket.state == "failed"
    with pytest.raises(RuntimeError, match="boom"):
        ticket.result()
    assert cluster.pending_spawns() == []
    cluster.register("phi-1", _mk(model))
    assert "phi-1" in cluster.engines()


def test_orchestrator_async_reconfig_finalizes_on_commit(port):
    cfg, model = port
    rng = np.random.default_rng(2)
    cluster = ServingCluster(device="cpu")
    cluster.register("edge0", _mk(model))
    for rid in range(2):
        cluster.submit(_req(rng, cfg, rid, "phi", new=3))
    res = Orchestrator().submit(PHI_INTENT, apply_to=cluster, async_reconfig=True)
    assert res.success
    ticket = res.reports["edge0"]
    assert hasattr(ticket, "state")
    _serve_until_done(cluster, ticket)
    report = ticket.result()
    assert report.engine == "edge0"
    assert "pod" in cluster.engine("edge0").plan.forbidden_collective_axes
    cluster.submit(_req(rng, cfg, 100, "phi", new=3))
    cluster.run()
    assert cluster.pending_reports() == []
    assert report.metrics_after["completed"] >= 1


N_THREADS = 4
PER_THREAD = 10


def test_stress_concurrent_submit_reconfigure_spawn(port):
    """Submitter threads race reconfigure_async (twice: the second
    supersedes the first), spawn_engine_async and the serving loop: no
    routing to an engine mid-swap, nothing dropped, every ticket terminal,
    every report finalized, and no route span overlaps a commit span."""
    import sys
    cfg, model = port
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with recording(Recorder()) as rec:
            cluster = ServingCluster(device="cpu")
            cluster.register("e0", _mk(model))
            cluster.register("e1", _mk(model))
            reqs = [[] for _ in range(N_THREADS)]
            errors = []

            def submitter(tid):
                rng = np.random.default_rng(100 + tid)
                try:
                    for i in range(PER_THREAD):
                        r = _req(rng, cfg, tid * 1000 + i, new=3)
                        reqs[tid].append(r)
                        cluster.submit(r)
                        time.sleep(0.001)
                except Exception as e:          # pragma: no cover - failure path
                    errors.append(e)

            threads = [threading.Thread(target=submitter, args=(tid,))
                       for tid in range(N_THREADS)]
            for t in threads:
                t.start()
            t_a = cluster.reconfigure_async("e0", default_plan(), prefill_lengths=(6,))
            t_b = cluster.reconfigure_async("e0", PINNED, prefill_lengths=(6,))
            t_spawn = cluster.spawn_engine_async("e2", _mk(model), prefill_lengths=(6,))
            deadline = time.monotonic() + DEADLINE_S
            while any(t.is_alive() for t in threads) \
                    or not all(t.done() for t in (t_b, t_spawn)):
                assert time.monotonic() < deadline, "stress run wedged"
                if cluster.step() == 0:
                    time.sleep(0.001)
            for t in threads:
                t.join(timeout=DEADLINE_S)
                assert not t.is_alive()
            cluster.run(wait_pending=True)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert t_a.state == "cancelled"
    assert t_b.state == "swapped" and t_spawn.state == "swapped"
    assert cluster.engine("e0").plan is PINNED and "e2" in cluster.engines()
    assert cluster.midswap_routes == 0
    submitted = [r for per in reqs for r in per]
    assert len(submitted) == N_THREADS * PER_THREAD and cluster.rejected == []
    assert cluster.metrics()["completed"] == len(submitted)
    assert all(len(r.tokens_out) == r.max_new_tokens for r in submitted)
    rng = np.random.default_rng(999)
    for rid in range(4):
        cluster.submit(_req(rng, cfg, 5000 + rid, new=2))
    cluster.run()
    assert cluster.pending_reports() == []
    for report in cluster.history:
        assert set(report.metrics_before) == set(METRIC_KEYS)
        assert set(report.metrics_after) == set(METRIC_KEYS)
    commits = [s for s in rec.trace.spans() if s.name in ("swap.commit", "spawn.commit")]
    routes = rec.trace.spans("route")
    assert {s.name for s in commits} == {"swap.commit", "spawn.commit"}
    assert len(routes) >= N_THREADS * PER_THREAD
    assert [(r, c) for c in commits for r in routes if overlaps(r, c)] == []
    states = {e.kind for e in rec.events("ticket")}
    assert {"ticket.preparing", "ticket.ready", "ticket.swapped",
            "ticket.cancelled"} <= states
