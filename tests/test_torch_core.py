"""The port's intent pipeline against the JAX package's, and the port's
artifact check.

Every entry of `CORPUS` goes through both packages' `Orchestrator` (the
deterministic and the faulty interpreter): the compiled policies and the
validator's checks must be equal, and applied to a cluster they must install
the same route constraints; on the port's cluster every engine that serves
a constrained label ends on the plan the reference's merge gives. The
sharding helpers are held against the reference's, and the collective
check against a real process group (gloo, one rank, in this process).
"""
import dataclasses
import itertools
import socket

import numpy as np
import pytest
import torch
from test_torch_cluster import tiny

import repro.core as jcore
import repro.serving as jserving
import repro.sharding.plan as jplan
from repro_torch.core import CORPUS, DeterministicInterpreter, FaultyInterpreter, Orchestrator
from repro_torch.core.validator import axes_crossed, check_collective_axes, validate
from repro_torch.serving import Collective, ServingCluster, ServingEngine
from repro_torch.sharding import plan as tplan


def _plain(obj):
    """A package-free view of a dataclass tree (the two packages' classes
    differ; their fields must not)."""
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


def _checks(report):
    return [(c.name, c.passed, c.detail) for c in report.checks]


INTERPRETERS = {
    "deterministic": (jcore.DeterministicInterpreter, DeterministicInterpreter, {}),
    "faulty": (jcore.FaultyInterpreter, FaultyInterpreter, {"rate": 0.5, "seed": 3}),
}


@pytest.mark.parametrize("backend", list(INTERPRETERS))
def test_corpus_compiles_and_validates_as_the_reference(backend):
    jint, tint, kw = INTERPRETERS[backend]
    jorch = jcore.Orchestrator(interpreter=jint(**kw))
    torch_orch = Orchestrator(interpreter=tint(**kw))
    assert len(CORPUS) == 90
    for entry in CORPUS:
        want = jorch.submit(entry.text)
        got = torch_orch.submit(entry.text)
        assert _plain(got.policy) == _plain(want.policy), entry.text
        assert _checks(got.report) == _checks(want.report), entry.text
        assert (got.applied, got.success) == (want.applied, want.success), entry.text
        assert (got.prompt_tokens, got.completion_tokens) \
            == (want.prompt_tokens, want.completion_tokens)
    assert {k: _plain(v) for k, v in torch_orch.state.plans.items()} \
        == {k: _plain(v) for k, v in jorch.state.plans.items()}
    assert torch_orch.state.placement == jorch.state.placement
    assert torch_orch.state.scale_bounds == jorch.state.scale_bounds


def _constraints(cluster):
    return {k: (v.device_constraints, v.forbidden_collective_axes)
            for k, v in cluster.route_constraints().items()}


@pytest.mark.parametrize("chunk", range(3))
def test_corpus_applied_to_a_port_cluster_installs_the_reference_policy(chunk):
    """Each corpus intent applied to a fresh cluster: the port's installs
    the reference cluster's route constraints, and every port engine that
    serves a constrained label is swapped onto the reference merge of its
    unsatisfied constraints (held against `repro.sharding.plan`)."""
    _, _, _, model = tiny()
    entries = CORPUS[chunk::3]
    for entry in entries:
        jcluster = jserving.ServingCluster()      # no engines: constraints only
        jres = jcore.Orchestrator().submit(entry.text, apply_to=jcluster)
        cluster = ServingCluster(device="cpu")
        for name, labels in (("phi0", {"data-type": "phi"}), ("open", {})):
            cluster.register(name, ServingEngine(model, n_slots=2, s_max=16,
                                                 labels=labels, device="cpu"))
        res = Orchestrator().submit(entry.text, apply_to=cluster)
        assert res.success == jres.success, entry.text
        assert _constraints(cluster) == _constraints(jcluster), entry.text
        for name in ("phi0", "open"):
            eng = cluster.engine(name)
            unsat = [jplan.ShardingPlan(device_constraints=d, forbidden_collective_axes=f)
                     for value, (d, f) in _constraints(jcluster).items()
                     if cluster._entries[name].serves({"data-type": value})
                     and not jplan.plan_satisfies(jplan.default_plan(), jplan.ShardingPlan(
                         device_constraints=d, forbidden_collective_axes=f))]
            want = jplan.merge_restrictions(jplan.default_plan(), *unsat)
            assert _plain(eng.plan) == _plain(want), (entry.text, name)
            assert (name in res.reports) == bool(unsat), (entry.text, name)


def test_orchestrator_on_a_port_cluster_reports_as_the_reference():
    """One intent, the same engines on both packages: the per-engine
    DowntimeReports agree on everything but the measured times."""
    cfg, jmodel, jparams, model = tiny()
    out = []
    for mk, cl, orch in (
            (lambda **kw: jserving.ServingEngine(jmodel, jparams, **kw),
             jserving.ServingCluster, jcore.Orchestrator),
            (lambda **kw: ServingEngine(model, device="cpu", **kw),
             lambda: ServingCluster(device="cpu"), Orchestrator)):
        cluster = cl()
        cluster.register("edge0", mk(n_slots=2, s_max=32, labels={"data-type": "phi"}))
        cluster.register("edge1", mk(n_slots=2, s_max=32))
        res = orch().submit("Phi traffic must remain inside the pod.", apply_to=cluster)
        out.append({k: (r.event, r.engine, r.compiled_in_prepare, r.migrate_bytes)
                    for k, r in res.reports.items()})
    assert out[0] == out[1] and set(out[1]) == {"edge0", "edge1"}


# ---------------------------------------------------------------------------
# sharding helpers against the reference
# ---------------------------------------------------------------------------

PINS = [(), (("pod", 0),), (("pod", 1),), (("pod", 0), ("data", 1))]
AXES = [(), ("pod",), ("data",), ("pod", "model")]


def _pair(pins, axes):
    return (jplan.ShardingPlan(device_constraints=pins, forbidden_collective_axes=axes),
            tplan.ShardingPlan(device_constraints=pins, forbidden_collective_axes=axes))


def test_plan_satisfies_and_merge_equal_the_reference():
    plans = [_pair(p, a) for p, a in itertools.product(PINS, AXES)]
    for (ja, ta), (jb, tb) in itertools.product(plans, plans):
        assert tplan.plan_satisfies(ta, tb) == jplan.plan_satisfies(ja, jb)
        assert _plain(tplan.merge_restrictions(ta, tb)) \
            == _plain(jplan.merge_restrictions(ja, jb))
    assert _plain(tplan.default_plan(multi_pod=True)) \
        == _plain(jplan.default_plan(multi_pod=True))


def test_plan_to_placement_keeps_the_modulo_rule():
    mesh = tplan.single_device_mesh("cpu")
    assert mesh.devices.shape == (1, 1, 1) and mesh.axis_names == ("pod", "data", "model")
    for pins in PINS:
        place = tplan.plan_to_placement(tplan.ShardingPlan(device_constraints=pins), mesh)
        assert place == {"params": torch.device("cpu"), "cache": torch.device("cpu")}
    devs = np.empty((2, 1, 1), dtype=object)
    devs[0, 0, 0], devs[1, 0, 0] = torch.device("cpu"), torch.device("meta")
    two = tplan.Mesh(devs)
    pod1 = tplan.ShardingPlan(device_constraints=(("pod", 1),))
    assert tplan.plan_to_placement(pod1, two)["cache"] == torch.device("meta")
    pod3 = tplan.ShardingPlan(device_constraints=(("pod", 3),))   # 3 % 2 == 1
    assert tplan.plan_to_placement(pod3, two)["params"] == torch.device("meta")
    with pytest.raises(ValueError, match="one"):
        tplan.plan_to_placement(tplan.default_plan(), two)
    with pytest.raises(ValueError):
        tplan.Mesh(devs, ("pod", "data"))


# ---------------------------------------------------------------------------
# the collective check
# ---------------------------------------------------------------------------

SHAPE, NAMES = (2, 2, 2), ("pod", "data", "model")


@pytest.mark.parametrize("ranks,want", [(None, ("data", "model", "pod")), ((3,), ()),
                                        ((0, 4), ("pod",)), ((0, 1), ("model",)),
                                        ((0, 2), ("data",)), ((0, 7), ("data", "model", "pod"))])
def test_axes_crossed(ranks, want):
    assert axes_crossed(ranks, SHAPE, NAMES) == want


def test_axes_crossed_matches_the_reference_on_groups():
    from repro.core.hlo_analysis import axes_crossed as jaxes
    for group in itertools.combinations(range(8), 2):
        assert axes_crossed(group, SHAPE, NAMES) \
            == jaxes(np.asarray([group]), None, SHAPE, NAMES)


def test_check_collective_axes():
    ok, msg = check_collective_axes([Collective("c10d.allreduce_", (0, 1))], ["pod"], SHAPE, NAMES)
    assert ok and "1 collectives checked" in msg
    ok, msg = check_collective_axes([Collective("c10d.allreduce_", (0, 4)),
                                     Collective("_c10d_functional.all_gather_into_tensor", None)],
                                    ["pod"], SHAPE, NAMES)
    assert not ok and msg.startswith("2 collectives cross forbidden axes")
    assert check_collective_axes([Collective("x", None)], ["pod"], (1, 1, 1), NAMES)[0]


def test_validator_checks_recorded_collectives():
    """The artifact check of the validator runs over recorded collectives
    for every routing constraint with forbidden axes."""
    orch = Orchestrator()
    text = "Phi traffic must remain inside the pod."
    clean = orch.submit(text, collective_modules={"phi-decode": []})
    assert clean.report.passed
    assert any(c.name.endswith("collectives[phi-decode]") and c.passed
               for c in clean.report.checks)
    bad = Orchestrator().submit(
        text, collective_modules={"phi-decode": [Collective("c10d.allreduce_", (0, 256))]})
    assert not bad.report.passed and not bad.applied
    other = Orchestrator().submit(
        text, collective_modules={"general": [Collective("c10d.allreduce_", (0, 256))]})
    assert other.report.passed                     # not a phi module: not checked
    policy = bad.policy
    rep = validate(policy, orch.fabric, orch.components,
                   collective_modules={"phi": [Collective("c10d.allreduce_", (0, 1))]},
                   mesh_shape=orch.fabric.mesh_shape, axis_names=orch.fabric.axis_names)
    assert rep.passed


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("paged", [True, False])
def test_no_process_group_traces_nothing_and_prepare_still_warms_decode(monkeypatch, paged):
    """Without a process group no collective can be dispatched: the check
    runs no decode step and records none; PREPARE still warms one decode
    step (on scratch state) and returns the reference's count."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    _, _, _, model = tiny()
    calls = []
    real = model.decode_step

    def counted(tokens, cache, pos):
        calls.append(tuple(tokens.shape))
        return real(tokens, cache, pos)

    monkeypatch.setattr(model, "decode_step", counted)
    eng = ServingEngine(model, n_slots=2, s_max=16, paged=paged, device="cpu")
    assert eng.decode_collectives() == [] and calls == []
    execs, n = eng.prepare_executables({"params": eng.device, "cache": eng.device}, (3, 5))
    assert n == 3 and execs["collectives"] == () and calls == [(2, 1)]


def test_decode_collectives_records_a_process_groups_collectives(monkeypatch):
    """A decode step that all-reduces over a process group is recorded with
    the group's ranks; without one, nothing is recorded."""
    import torch.distributed as dist
    _, _, _, model = tiny()
    eng = ServingEngine(model, n_slots=2, s_max=16, device="cpu")
    assert eng.decode_collectives() == []
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        real = model.decode_step

        def sharded_step(tokens, cache, pos):
            logits, cache = real(tokens, cache, pos)
            dist.all_reduce(logits)                 # a tensor-parallel sum
            return logits, cache

        monkeypatch.setattr(model, "decode_step", sharded_step)
        eng2 = ServingEngine(model, n_slots=2, s_max=16, paged=False, device="cpu")
        colls = eng2.decode_collectives()
        assert [c.op for c in colls] == ["c10d.allreduce_"]
        assert colls[0].ranks == (0,)
        assert eng2.decode_collectives() == colls       # recorded once
    finally:
        dist.destroy_process_group()
