"""The port's `ServingEngine` against the JAX engine on the CPU.

Greedy token streams of reduced fp32 ``minitron_4b`` and ``qwen2_moe_a2_7b``
(paged pool) and ``mamba2_370m`` (slot-granular pool) must equal the
reference engine's (`conftest.baseline_streams`: ``n_slots=4``,
``s_max=32``, ``page_size=16``), with more requests than lanes so that
admission queues and lanes are re-packed (or slots refilled over a used
state), and the pool must be pristine after `run()`.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import baseline_streams

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.serving.engine import _write_slot as jax_write_slot
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
from repro_torch.serving.engine import _write_slot
from repro_torch.serving.kvpool import SCRATCH_PAGE

SIZES = (5, 11, 5, 17, 11, 3)
NEW = 5


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


def _prompts(vocab, sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32) for n in sizes]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(JAX model, its params, port Model on the CPU with the same weights,
    prompts, the JAX engine's streams)."""
    jcfg = _fp32(jax_reduced(arch))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    prompts = _prompts(jcfg.vocab_size, SIZES)
    oracle = baseline_streams(jmodel, jparams, prompts, NEW, n_slots=4, s_max=32)
    cfg = _fp32(get_reduced_config(arch))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jmodel, jparams, Model(cfg, params, device="cpu"), prompts, oracle


@pytest.fixture(params=["minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m"])
def served(request):
    """(port Model on the CPU, prompts, the JAX engine's streams)."""
    return _reference(request.param)[2:]


@pytest.fixture(params=["minitron_4b", "qwen2_moe_a2_7b"])
def served_paged(request):
    """`served` for the models that serve on the paged pool."""
    return _reference(request.param)[2:]


def _run(model, prompts, **kw):
    eng = ServingEngine(model, **{"n_slots": 4, "s_max": 32, "device": "cpu", **kw})
    reqs = [Request(i, p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, {r.rid: list(r.tokens_out) for r in reqs}


def _assert_pristine(eng):
    assert eng.kv_allocated_tokens == 0 and eng.kv_utilization == 0.0
    assert eng.free_tokens == eng.kv_token_capacity
    assert all(r is None for r in eng.slot_req) and not eng.queue
    if eng.paged:
        assert eng.pool.free_pages == eng.pool.n_pages
        assert (eng.page_tables == SCRATCH_PAGE).all()


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
def test_streams_equal_reference_engine(served, buckets):
    """Exact-length and padded-bucket (``true_len``) prefill both give the
    reference engine's streams (an SSM model has no buckets: exact only)."""
    model, prompts, oracle = served
    eng, streams = _run(model, prompts, prefill_buckets=buckets)
    assert eng.paged == (model.cfg.family != "ssm")
    assert streams == oracle
    assert all(len(s) == NEW for s in streams.values())
    assert len(eng.done) == len(prompts)
    _assert_pristine(eng)


def test_token_budget_gates_admission(served_paged):
    """A 32-token budget of 8-token pages holds two 6+4-token requests:
    the others wait queued (fail closed), and all finish in order."""
    model, prompts, _ = served_paged
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
    """The cluster knobs are ported and an unknown ``role`` is refused
    fail-closed; sampling modes other than greedy are not ported: the engine
    refuses them rather than ignore them."""
    model = Model(_fp32(get_reduced_config("minitron_4b")), device="cpu")
    with pytest.raises(ValueError, match="unknown engine role"):
        ServingEngine(model, device="cpu", role="router")
    with pytest.raises(TypeError):
        ServingEngine(model, device="cpu", greedy=False)
    eng = ServingEngine(model, device="cpu", role="decode", labels={"data-type": "phi"})
    assert eng.role == "decode" and eng.labels == {"data-type": "phi"}
    with pytest.raises(ValueError, match="lives on"):
        ServingEngine(model, device="meta")


def test_slot_pool_serves_one_slot():
    """With one slot the port's slot pool still gives the JAX engine's
    ``n_slots=4`` streams: the slot is found on axis 1 by the layout (the
    reference's own ``_write_slot`` finds no axis at one slot and drops every
    prefilled state)."""
    _, _, model, prompts, oracle = _reference("mamba2_370m")
    eng, streams = _run(model, prompts, n_slots=1)
    assert not eng.paged and streams == oracle
    _assert_pristine(eng)


def test_ssm_model_cannot_be_paged_or_padded():
    _, _, model, _, _ = _reference("mamba2_370m")
    with pytest.raises(ValueError, match="cannot be paged"):
        ServingEngine(model, paged=True, device="cpu")
    eng = ServingEngine(model, s_max=32, prefill_buckets=True, device="cpu")
    assert not eng.supports_padded_prefill() and eng.bucket_lengths() == []


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
def test_slot_pool_serves_attention_models(buckets):
    """``paged=False`` serves an attention model on the slot pool, with the
    paged engine's streams (bucket slack past the prompt is never read)."""
    _, _, model, prompts, oracle = _reference("minitron_4b")
    eng, streams = _run(model, prompts, paged=False, prefill_buckets=buckets)
    assert not eng.paged and eng.pool is None and streams == oracle
    _assert_pristine(eng)


def test_slot_pool_capacity_properties():
    """A slot pool spends a whole ``s_max`` per request, as the reference's
    does."""
    _, _, model, prompts, _ = _reference("mamba2_370m")
    eng = ServingEngine(model, n_slots=3, s_max=32, device="cpu")
    assert eng.kv_token_capacity == 96 and eng.free_tokens == 96
    assert eng.cache_batch == 3 and eng.admission_tokens(5) == 32
    assert eng.single_layout() == model.cache_shapes(1, 32)
    assert {k: tuple(v.shape) for k, v in eng.cache.items()} == model.cache_shapes(3, 32)
    for i, p in enumerate(prompts[:2]):
        eng.submit(Request(i, p, max_new_tokens=NEW))
    eng.step()
    assert eng.kv_allocated_tokens == 64 and eng.free_tokens == 32
    assert eng.kv_used_tokens == len(prompts[0]) + len(prompts[1]) + 2
    assert eng.fits_inflight([1000]) and not eng.fits_inflight([1, 1])
    eng.run()
    _assert_pristine(eng)


def test_slot_pool_rounds_conv_histories_as_the_reference():
    """The reference keeps the conv histories in the cache's dtype (bf16)
    even for an fp32 model, so a slot write rounds them. The first decode
    after admission matches the JAX engine's pool to 1e-5 only if the port
    rounds them the same way: kept in fp32 they move the logits by ~1e-3."""
    jmodel, jparams, model, prompts, _ = _reference("mamba2_370m")
    prompt = prompts[3]
    S = len(prompt)
    jlogits, jcache1 = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)[None]})
    jpool = jax_write_slot(jmodel.init_cache(2, 32), jcache1, 0, S, 32)
    tok = np.array([[int(np.argmax(jlogits[0]))], [0]], np.int32)
    gold, _ = jmodel.decode_step(jparams, jnp.asarray(tok), jpool, jnp.asarray([S, 0], jnp.int32))
    gold = np.asarray(gold[0])

    eng = ServingEngine(model, n_slots=2, s_max=32, device="cpu")
    assert eng.cache["conv_x"].dtype == torch.bfloat16
    assert eng.cache["ssm"].dtype == torch.float32
    eng.submit(Request(0, prompt, max_new_tokens=NEW))
    eng._admit()
    tt, pos = torch.as_tensor(tok, dtype=torch.long), torch.tensor([S, 0])
    logits, _ = model.decode_step(tt, eng.cache, pos)
    np.testing.assert_allclose(logits[0].numpy(), gold, atol=1e-5, rtol=1e-5)

    _, cache1 = model.prefill({"tokens": torch.as_tensor(prompt, dtype=torch.long)[None]})
    fp32_pool = model.init_cache(2, 32, dtype=torch.float32)
    _write_slot(fp32_pool, cache1, 0)
    unrounded, _ = model.decode_step(tt, fp32_pool, pos)
    assert np.abs(unrounded[0].numpy() - gold).max() > 1e-4
