"""The port's entry points `repro_torch.launch.quickstart` and
`repro_torch.launch.serve_intents` against the reference's examples
(`examples/quickstart.py`, `examples/serve_intents.py`), whose flows run here
through `repro`'s public API, on the CPU.

Latency and wall times are not compared: the intents' outcomes, the waves'
greedy streams, PREPARE's count, the bytes a swap places and the fail-closed
rejection are.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np

import repro.serving as jserving
from repro.configs import get_reduced_config as jax_reduced
from repro.core import Orchestrator as JaxOrchestrator
from repro.models import build_model as jax_build
from repro.sharding import default_plan as jax_default_plan
from repro_torch.configs import get_reduced_config
from repro_torch.launch import quickstart, serve_intents
from repro_torch.models import Model


def _summary(s):
    """A validator summary without its wall time."""
    return re.sub(r", [0-9.]+ ms$", "", s)


def test_quickstart_equals_the_reference_orchestrator(capsys):
    """Every intent's domain, complexity, validator verdict and checks,
    ``applied``, first manifest and first flow rule, then the final
    placement and flow counts, equal the reference `Orchestrator`'s."""
    got = quickstart.main([])
    assert "final placement" in capsys.readouterr().out
    orch = JaxOrchestrator()
    for text, port in zip(quickstart.INTENTS, got["intents"]):
        r = orch.submit(text)
        assert (port["domain"], port["complexity"]) == (r.policy.intent.domain,
                                                        r.policy.intent.complexity)
        assert _summary(port["summary"]) == _summary(r.report.summary())
        assert port["checks"] == [(c.name, c.passed) for c in r.report.checks]
        assert port["applied"] == r.applied
        assert port["manifest"] == (r.policy.manifests[0] if r.applied and r.policy.manifests
                                    else None)
        assert port["flow_rule"] == (r.policy.flow_rules[0]
                                     if r.applied and r.policy.flow_rules else None)
    assert len(got["intents"]) == 4 and [i["applied"] for i in got["intents"]][-1] is False
    assert got["placement"] == orch.state.placement
    assert (got["flow_rules"], got["flows"]) == (len(orch.state.flow_rules),
                                                 len(orch.state.flows))


def _reference_flow(jmodel, jparams):
    """`examples/serve_intents.py`'s flow on the reference, its requests
    kept: (wave 1 and wave 2 streams, the swap's report, the rejection)."""
    cfg = jmodel.cfg
    cluster = jserving.ServingCluster()
    cluster.register("edge0", jserving.ServingEngine(jmodel, jparams, n_slots=4, s_max=48),
                     plan=jax_default_plan())
    rng = np.random.default_rng(0)

    def load(n, base, labels):
        reqs = [jserving.Request(base + rid, rng.integers(2, cfg.vocab_size, size=8)
                                 .astype(np.int32), max_new_tokens=8, labels=labels)
                for rid in range(n)]
        for r in reqs:
            cluster.submit(r)
        return reqs

    wave1 = load(4, 0, {"data-type": "phi"}) + load(4, 10, {"data-type": "general"})
    cluster.run()
    res = JaxOrchestrator().submit(serve_intents.INTENT, apply_to=cluster)
    assert res.success
    wave2 = load(8, 100, {"data-type": "phi"})
    cluster.run()
    strict = jserving.ServingCluster()
    strict.register("noncompliant", jserving.ServingEngine(jmodel, jparams, n_slots=2,
                                                           s_max=48))
    strict.set_route_constraint("phi", cluster.route_constraints()["phi"])
    try:
        strict.submit(jserving.Request(999, rng.integers(2, cfg.vocab_size, size=8)
                                       .astype(np.int32), labels={"data-type": "phi"}))
    except jserving.RoutingError as e:
        rejected = str(e)
    return ({r.rid: list(r.tokens_out) for r in wave1},
            {r.rid: list(r.tokens_out) for r in wave2}, res.reports["edge0"], rejected)


def test_serve_intents_equals_the_reference_flow(capsys):
    """``serve_intents --device cpu --reduced`` over the same weights as the
    reference's flow: both waves' streams, PREPARE's count, the bytes the
    swap places and the rejection equal the reference's; every wave-2
    admission runs the exact-length prefill executable PREPARE built from
    wave 1's lengths."""
    fp32 = dict(param_dtype="float32", activ_dtype="float32")
    model = Model(dataclasses.replace(get_reduced_config("qwen2-moe-a2.7b"), **fp32),
                  device="cpu", seed=0)
    jmodel = jax_build(dataclasses.replace(jax_reduced("qwen2-moe-a2.7b"), **fp32))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), model.params)
    wave1, wave2, report, rejected = _reference_flow(jmodel, jparams)

    got = serve_intents.main(["--device", "cpu", "--reduced"], model=model)
    out = capsys.readouterr().out
    assert "rejected as expected" in out and f"AOT x{report.compiled_in_prepare}" in out
    assert got["wave1"] == wave1 and got["wave2"] == wave2
    assert got["report"].compiled_in_prepare == report.compiled_in_prepare == 2
    assert got["report"].migrate_bytes == report.migrate_bytes
    assert got["rejected"] == rejected
    assert got["prefill_stats"]["exact"] == len(wave2)
    assert got["prefill_stats"]["eager"] == len(wave1)
