"""The port's `ServingEngine` over the new decoder families against the JAX
engine on the CPU.

Greedy token streams of reduced fp32 ``minicpm3_4b`` (MLA: the paged pool
over the latent cache, absorbed decode; exact and bucket-padded prefill),
``qwen2_vl_2b`` (M-RoPE positions on the paged pool) and ``jamba_v0_1_52b``
(hybrid periods: the slot-granular pool, two slots refilled over used state)
must equal the reference engine's, with more requests than lanes. The
reference runs Jamba at ``n_slots=2``: its ``_write_slot`` drops every
prefilled state at one slot. A Jamba request moved mid-decode from one slot
engine to another continues the stream it has unmoved.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
from conftest import baseline_streams

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.kvpool import SCRATCH_PAGE

#: prompt lengths: Jamba's cross its reduced chunk (32) and end on it
SIZES = {"minicpm3_4b": (5, 11, 5, 17, 11, 3),
         "qwen2_vl_2b": (5, 11, 5, 17, 11, 3),
         "jamba_v0_1_52b": (5, 33, 17, 32, 11)}
NEW = 5
S_MAX = {"minicpm3_4b": 32, "qwen2_vl_2b": 32, "jamba_v0_1_52b": 48}
N_SLOTS = {"minicpm3_4b": 4, "qwen2_vl_2b": 4, "jamba_v0_1_52b": 2}


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(port Model on the CPU with the reference's weights, prompts, the
    JAX engine's streams)."""
    jcfg = _fp32(jax_reduced(arch))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n).astype(np.int32)
               for n in SIZES[arch]]
    oracle = baseline_streams(jmodel, jparams, prompts, NEW,
                              n_slots=N_SLOTS[arch], s_max=S_MAX[arch])
    cfg = _fp32(get_reduced_config(arch))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return Model(cfg, params, device="cpu"), prompts, oracle


def _engine(arch, model, **kw):
    return ServingEngine(model, **{"n_slots": N_SLOTS[arch], "s_max": S_MAX[arch],
                                   "device": "cpu", **kw})


def _run(eng, prompts):
    reqs = [Request(i, p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: list(r.tokens_out) for r in reqs}


def _assert_pristine(eng):
    assert eng.kv_allocated_tokens == 0 and eng.free_tokens == eng.kv_token_capacity
    assert all(r is None for r in eng.slot_req) and not eng.queue
    if eng.paged:
        assert eng.pool.free_pages == eng.pool.n_pages
        assert (eng.page_tables == SCRATCH_PAGE).all()


@pytest.mark.parametrize("arch,buckets", [("minicpm3_4b", False), ("minicpm3_4b", True),
                                          ("qwen2_vl_2b", False), ("qwen2_vl_2b", True),
                                          ("jamba_v0_1_52b", False)])
def test_streams_equal_reference_engine(arch, buckets):
    """MLA and M-RoPE serve paged (exact and bucket-padded prefill), the
    hybrid on the slot pool, each with the reference engine's streams."""
    model, prompts, oracle = _reference(arch)
    eng = _engine(arch, model, prefill_buckets=buckets)
    assert eng.paged == (arch != "jamba_v0_1_52b")
    assert eng.supports_padded_prefill() == eng.paged
    assert bool(eng.bucket_lengths()) == eng.paged
    streams = _run(eng, prompts)
    assert streams == oracle
    assert all(len(s) == NEW for s in streams.values())
    _assert_pristine(eng)


def test_mla_pool_pages_the_latent_cache():
    """The paged store of an MLA model holds the latent ``ckv``/``kpe``
    leaves, paged on axis 1 with the sequence on axis 2."""
    model, _, _ = _reference("minicpm3_4b")
    eng = _engine("minicpm3_4b", model, page_size=8)
    m = model.cfg.mla
    L, pages = model.cfg.num_layers, eng.pool.store_batch
    assert {k: tuple(v.shape) for k, v in eng.cache.items()} == {
        "ckv": (L, pages, 8, m.kv_lora_rank), "kpe": (L, pages, 8, m.qk_rope_head_dim)}
    assert eng._pax == {"ckv": 1, "kpe": 1} and eng._sax == {"ckv": 2, "kpe": 2}


def test_prepare_warms_mrope_prefill_and_swaps_in_buckets():
    """PREPARE warms Qwen2-VL's prefill at each length and bucket; after the
    swap the engine serves through the buckets (M-RoPE over the padded
    length) with the reference engine's streams."""
    model, prompts, oracle = _reference("qwen2_vl_2b")
    eng = _engine("qwen2_vl_2b", model)
    exes, n = eng.prepare_executables({"cache": eng.device}, (5, 11), prefill_buckets=True)
    assert sorted(exes["prefill"]) == [5, 11] and sorted(exes["prefill_buckets"]) == [8, 16, 32]
    assert n == 1 + 2 + 3
    eng.pause()
    eng.swap_plan(executables=exes)
    eng.resume()
    assert _run(eng, prompts) == oracle


def test_hybrid_request_migrates_mid_decode():
    """A Jamba request exported mid-decode from one slot engine (its
    attention K/V and every Mamba sub-layer's state) and imported into
    another continues the stream it has unmoved; the source's other
    requests finish unchanged."""
    model, prompts, oracle = _reference("jamba_v0_1_52b")
    src = _engine("jamba_v0_1_52b", model)
    dst = _engine("jamba_v0_1_52b", model)
    reqs = [Request(i, p, max_new_tokens=NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        src.submit(r)
    src.step()
    src.step()
    moving = next(r for r in src.slot_req if r is not None)
    assert 1 < len(moving.tokens_out) < NEW
    snap = src.export_slot(moving.rid)
    assert set(snap.kv) == set(model.cache_shapes(1, S_MAX["jamba_v0_1_52b"]))
    assert snap.nbytes > 0 and any(k.startswith("pos4/") for k in snap.kv)
    assert dst.import_slot(snap) == snap.nbytes
    src.run()
    dst.run()
    assert {r.rid: list(r.tokens_out) for r in reqs} == oracle
    assert [r.rid for r in dst.done] == [moving.rid]
    _assert_pristine(src)
    _assert_pristine(dst)


def test_hybrid_slot_pool_serves_one_slot():
    """With one slot the port's pool still gives the JAX engine's two-slot
    streams: every leaf's slot is axis 1 by the layout, the attention K/V
    and the Mamba state alike (the reference's ``_write_slot`` finds no
    axis at one slot and drops every prefilled state of this model too)."""
    model, prompts, oracle = _reference("jamba_v0_1_52b")
    eng = _engine("jamba_v0_1_52b", model, n_slots=1)
    assert _run(eng, prompts) == oracle
    _assert_pristine(eng)
