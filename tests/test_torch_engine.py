"""The port's paged `ServingEngine` against the JAX engine on the CPU.

Greedy token streams of reduced fp32 ``minitron_4b`` and ``qwen2_moe_a2_7b``
must equal the reference engine's (`conftest.baseline_streams`: paged,
``n_slots=4``, ``s_max=32``, ``page_size=16``), with more requests than
lanes so that admission queues and lanes are re-packed, and the page pool
must be pristine after `run()`.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
from conftest import baseline_streams

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.models import Model
from repro_torch.serving import (
    METRIC_KEYS,
    EngineStateError,
    PoolOOM,
    Request,
    ServingEngine,
    compute_metrics,
)
from repro_torch.serving.kvpool import SCRATCH_PAGE

SIZES = (5, 11, 5, 17, 11, 3)
NEW = 5


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


def _prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in sizes]


@pytest.fixture(scope="module", params=["minitron_4b", "qwen2_moe_a2_7b"])
def served(request):
    """(port Model on the CPU, prompts, the JAX engine's streams)."""
    arch = request.param
    jcfg = _fp32(jax_reduced(arch))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    prompts = _prompts(jcfg.vocab_size, SIZES)
    oracle = baseline_streams(jmodel, jparams, prompts, NEW, n_slots=4, s_max=32)
    cfg = _fp32(get_reduced_config(arch))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return Model(cfg, params, device="cpu"), prompts, oracle


def _run(model, prompts, **kw):
    eng = ServingEngine(model, n_slots=4, s_max=32, device="cpu", **kw)
    reqs = [Request(i, p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, {r.rid: list(r.tokens_out) for r in reqs}


def _assert_pristine(eng):
    assert eng.pool.free_pages == eng.pool.n_pages
    assert eng.kv_allocated_tokens == 0 and eng.kv_utilization == 0.0
    assert (eng.page_tables == SCRATCH_PAGE).all()
    assert all(r is None for r in eng.slot_req) and not eng.queue


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
def test_streams_equal_reference_engine(served, buckets):
    """Exact-length and padded-bucket (``true_len``) prefill both give the
    reference engine's streams."""
    model, prompts, oracle = served
    eng, streams = _run(model, prompts, prefill_buckets=buckets)
    assert streams == oracle
    assert all(len(s) == NEW for s in streams.values())
    assert len(eng.done) == len(prompts)
    _assert_pristine(eng)


def test_token_budget_gates_admission(served):
    """A 32-token budget of 8-token pages holds two 6+4-token requests:
    the others wait queued (fail closed), and all finish in order."""
    model, prompts, _ = served
    eng = ServingEngine(model, n_slots=4, s_max=32, page_size=8, kv_tokens=32,
                        device="cpu")
    reqs = [Request(i, p[:6] if len(p) >= 6 else np.resize(p, 6), max_new_tokens=4)
            for i, p in enumerate(prompts[:4])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert sum(r is not None for r in eng.slot_req) == 2 and len(eng.queue) == 2
    assert 0.0 < eng.kv_utilization <= 1.0
    assert eng.free_tokens == 0 and eng.kv_token_capacity == 32
    assert eng.admission_tokens(10) == 16 and not eng.fits_inflight([8])
    with pytest.raises(PoolOOM):
        eng.pool.alloc(1)
    eng.run()
    assert [len(r.tokens_out) for r in reqs] == [4] * 4
    _assert_pristine(eng)


def test_pause_queues_and_resume_serves(served):
    model, prompts, oracle = served
    eng = ServingEngine(model, n_slots=4, s_max=32, device="cpu")
    eng.pause()
    r = Request(0, prompts[0], max_new_tokens=NEW)
    eng.submit(r)
    with pytest.raises(EngineStateError):
        eng.step()
    assert eng.load == 1 and eng.drain() == 0
    eng.resume()
    eng.run()
    assert r.tokens_out == oracle[0]
    m = eng.metrics()
    assert set(m) == set(METRIC_KEYS) and m["completed"] == 1
    assert r.ttft >= 0 and r.tpot >= 0


def test_compute_metrics_empty_window_is_nan():
    m = compute_metrics([])
    assert m["completed"] == 0
    assert all(math.isnan(m[k]) for k in METRIC_KEYS if k != "completed")


def test_engine_rejects_unknown_role_and_device_mismatch():
    """Cluster knobs (``role``, ``labels``) and sampling modes other than
    greedy are not ported: the engine refuses them rather than ignore them."""
    model = Model(_fp32(get_reduced_config("minitron_4b")), device="cpu")
    for knob in ({"role": "router"}, {"labels": {"data-type": "phi"}}, {"greedy": False}):
        with pytest.raises(TypeError):
            ServingEngine(model, device="cpu", **knob)
    with pytest.raises(ValueError, match="lives on"):
        ServingEngine(model, device="meta")
