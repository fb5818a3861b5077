"""The port's deprecated `ReconfigEngine` shim, held to the reference's two
callers (`tests/test_serving.py::test_reconfigure_preserves_outputs`,
`tests/test_system.py::test_e2e_intent_driven_serving_reconfiguration`):
the same flows on both packages from the same weights and prompts. The
swap changes no token, so each package's streams equal the other's; the
downtime is measured, a placement's bytes counted, and the metrics
finalized. The reference's shim takes NamedShardings; the port's takes the
placement `plan_to_placement` gives (one device).
"""
import jax
import numpy as np
import pytest
import torch
from test_torch_cluster import prompts, tiny

from repro.core import Orchestrator as JaxOrchestrator
from repro.core.reconfig import ReconfigEngine as JaxReconfigEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.core import Orchestrator, ReconfigEngine
from repro_torch.serving import Request, ServingEngine
from repro_torch.sharding import default_plan, plan_to_placement, single_device_mesh


def _streams(engine):
    return {r.rid: list(r.tokens_out) for r in engine.done}


def test_reconfigure_preserves_outputs():
    cfg, jmodel, jparams, model = tiny()
    ps = prompts(cfg.vocab_size, [6] * 4, seed=2)

    jeng = JaxServingEngine(jmodel, jparams, n_slots=2, s_max=48)
    eng = ServingEngine(model, n_slots=2, s_max=48, device="cpu")
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        for rid, p in enumerate(ps[:2]):
            e.submit(R(rid, p, max_new_tokens=4))
        for _ in range(2):
            e.step()

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    with pytest.warns(DeprecationWarning):
        jrc = JaxReconfigEngine(jeng)
    jreport = jrc.reconfigure(new_shardings={
        "params": jax.tree.map(lambda _: repl, jeng.params),
        "cache": jax.tree.map(lambda _: repl, jeng.cache)})
    with pytest.warns(DeprecationWarning, match="ServingCluster.reconfigure"):
        rc = ReconfigEngine(eng)
    report = rc.reconfigure(
        new_shardings=plan_to_placement(default_plan(), single_device_mesh("cpu")))
    assert rc.history == [report]

    for e, R in ((jeng, JaxRequest), (eng, Request)):
        for rid, p in enumerate(ps[2:], start=2):
            e.submit(R(rid, p, max_new_tokens=4))
        e.run()
    jrc.finalize_metrics(jreport)
    rc.finalize_metrics(report)

    for r in (jreport, report):
        assert r.downtime_s >= 0 and r.prepare_s >= 0
        assert r.migrate_bytes > 0
    assert len(eng.done) == 4 and report.metrics_after["completed"] == 4
    assert _streams(eng) == _streams(jeng)
    assert not eng.paused


def test_e2e_intent_driven_serving_reconfiguration():
    cfg, jmodel, jparams, model = tiny("qwen2_moe_a2_7b")
    ps = prompts(cfg.vocab_size, [5, 5], seed=0)
    jeng = JaxServingEngine(jmodel, jparams, n_slots=2, s_max=32)
    eng = ServingEngine(model, n_slots=2, s_max=32, device="cpu")
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        for rid, p in enumerate(ps):
            e.submit(R(rid, p, max_new_tokens=3, labels={"data-type": "phi"}))
        e.step()

    for orch in (JaxOrchestrator(), Orchestrator()):
        res = orch.submit("Phi traffic must remain inside the pod.")
        assert res.success
        assert any("phi" in k for k in orch.state.plans), orch.state.plans

    with pytest.warns(DeprecationWarning):
        jrc = JaxReconfigEngine(jeng)
        rc = ReconfigEngine(eng)
    jreport, report = jrc.reconfigure(), rc.reconfigure()
    assert report.migrate_bytes == 0            # no placement: nothing moves
    for e, c, r in ((jeng, jrc, jreport), (eng, rc, report)):
        e.run()
        c.finalize_metrics(r)
        assert r.downtime_s >= 0.0
        assert e.metrics()["completed"] == 2
    assert _streams(eng) == _streams(jeng)


def test_prepare_callables_become_the_swaps_executables():
    cfg, _, _, model = tiny()
    eng = ServingEngine(model, n_slots=2, s_max=16, device="cpu")
    calls = []
    with pytest.warns(DeprecationWarning):
        rc = ReconfigEngine(eng)
    report = rc.reconfigure(make_prefill=lambda: calls.append("prefill") or [4],
                            make_decode=lambda: calls.append("decode"))
    assert calls == ["decode", "prefill"] and report.prepare_s >= 0


def test_a_placement_off_the_params_device_raises():
    cfg, _, _, model = tiny()
    eng = ServingEngine(model, n_slots=2, s_max=16, device="cpu")
    with pytest.warns(DeprecationWarning):
        rc = ReconfigEngine(eng)
    with pytest.raises(ValueError, match="placement puts the params"):
        rc.reconfigure(new_shardings={"params": torch.device("meta"),
                                      "cache": torch.device("meta")})
    assert rc.history == []
