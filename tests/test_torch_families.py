"""The port's other decoder families against the JAX reference on the CPU.

Reduced fp32 configs of the six architectures beyond the first three:
``deepseek_coder_33b`` (dense GQA, rmsnorm, silu), ``nemotron_4_340b`` (dense
GQA, layernorm, relu2), ``moonshot_v1_16b_a3b`` (MoE, top-6 with shared
experts and renormalised weights), ``minicpm3_4b`` (MLA with absorbed
decode), ``qwen2_vl_2b`` (M-RoPE) and ``jamba_v0_1_52b`` (hybrid periods of
Mamba2, attention and MoE sub-layers, at one and at two periods), with the
reference's own ``init_params(PRNGKey(0))`` weights carried over by
`repro_torch.bridge`. Tolerance atol = rtol = 1e-4 unless stated: XLA and
PyTorch sum in different orders on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import Model, attention, lm
from repro_torch.models.common import mrope_cos_sin
from repro_torch.models.lm import layer_params, leaf_name
from repro_torch.models.ssm import state_dtype

TOL = dict(atol=1e-4, rtol=1e-4)
NEW_ARCHS = ["deepseek_coder_33b", "nemotron_4_340b", "moonshot_v1_16b_a3b",
             "minicpm3_4b", "qwen2_vl_2b", "jamba_v0_1_52b"]
#: each new arch's reduced config; Jamba also at two periods (16 layers)
CASES = NEW_ARCHS + ["jamba_v0_1_52b@16"]
DECODER_ARCHS = ["minicpm3_4b", "nemotron_4_340b", "minitron_4b", "deepseek_coder_33b",
                 "qwen2_vl_2b", "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b",
                 "jamba_v0_1_52b", "mamba2_370m"]


def _fp32(cfg, layers=None):
    cfg = dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(jax cfg, jax params, port Model on the CPU) with shared weights."""
    arch, _, layers = case.partition("@")
    layers = int(layers) if layers else None
    jcfg = _fp32(jax_reduced(arch), layers)
    jparams = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(arch), layers)
    tparams = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, Model(cfg, tparams, device="cpu")


@pytest.fixture(params=CASES)
def pair(request):
    return _pair(request.param)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)), **(tol or TOL))


def _flat(tree):
    """The reference's nested cache as the port's flat keys."""
    return {"/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat):
    """The port's flat cache keys as the reference's nested cache."""
    out = {}
    for key, v in flat.items():
        pre, _, leaf = key.rpartition("/")
        (out.setdefault(pre, {}) if pre else out)[leaf] = v
    return out


def test_prefill_logits_and_cache_match_reference(pair):
    jcfg, jparams, model = pair
    toks = _tokens(jcfg, 2, 37)       # past the reduced Jamba's chunk of 32
    jlogits, jcache = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks, dtype=torch.long)})
    _close(logits, jlogits)
    jflat = _flat(jcache)
    assert sorted(cache) == sorted(jflat)
    for name, leaf in cache.items():
        assert leaf.shape == tuple(jflat[name].shape), name
        _close(leaf, jflat[name])


@pytest.mark.parametrize("per_row", [True, False], ids=["pos_per_row", "pos_scalar"])
def test_decode_step_over_bf16_cache_matches_reference(pair, per_row):
    """Decode reads a bf16 cache (fp32 SSM state) and upcasts it, as the
    reference does for an fp32 model; the written entries round to bf16."""
    jcfg, jparams, model = pair
    B, S = 3, 16
    rng = np.random.default_rng(2)
    state = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in model.cache_shapes(B, S).items()}
    dt = {k: state_dtype(leaf_name(k), torch.bfloat16) for k in state}
    # copies: decode writes the port's cache in place, and the reference may
    # still read its (zero-copy) arrays from the same numpy memory
    tcache = {k: torch.tensor(a).to(dt[k]) for k, a in state.items()}
    jcache = _nested({k: jnp.asarray(a, jnp.bfloat16 if dt[k] == torch.bfloat16
                                     else jnp.float32) for k, a in state.items()})
    toks = _tokens(jcfg, B, 1, seed=3)
    pos = np.array([4, 9, 15], np.int32) if per_row else np.int32(7)
    jlogits, jnew = jax.jit(lambda p, t, c, q: jlm.decode_step(jcfg, p, t, c, q))(
        jparams, jnp.asarray(toks), jcache, jnp.asarray(pos))
    logits, new = model.decode_step(torch.as_tensor(toks, dtype=torch.long), tcache,
                                    torch.as_tensor(pos, dtype=torch.long))
    _close(logits, jlogits)
    jflat = _flat(jnew)
    for name, leaf in new.items():
        tol = TOL if leaf.dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
        _close(leaf, jflat[name], **tol)


@pytest.mark.parametrize("case", ["minicpm3_4b", "qwen2_vl_2b"])
def test_prefill_true_len_reads_the_padded_bucket(case):
    """The attention families pad to a bucket: logits read at ``true_len -
    1`` are the reference's and the exact-length prefill's."""
    jcfg, jparams, model = _pair(case)
    toks = _tokens(jcfg, 1, 16, seed=1)
    jlogits, _ = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks), "true_len": jnp.asarray(11, jnp.int32)})
    tt = torch.as_tensor(toks, dtype=torch.long)
    logits, _ = model.prefill({"tokens": tt, "true_len": 11})
    _close(logits, jlogits)
    exact, _ = model.prefill({"tokens": tt[:, :11]})
    _close(logits, exact, atol=1e-5, rtol=1e-5)


def test_mla_long_prefill_attends_in_chunks_as_the_reference(monkeypatch):
    """From `FLASH_THRESHOLD` on, MLA prefill attends through the chunked
    plain path with v padded to the qk head dim, as the reference does (the
    threshold lowered on both packages, so a short prompt takes it)."""
    jcfg, jparams, model = _pair("minicpm3_4b")
    monkeypatch.setattr(jattn, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 8)
    toks = _tokens(jcfg, 2, 13, seed=4)
    jlogits, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks, dtype=torch.long)})
    _close(logits, jlogits)
    _close(cache["ckv"], jcache["ckv"])
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 8192)
    whole, _ = model.prefill({"tokens": torch.as_tensor(toks, dtype=torch.long)})
    _close(logits, whole, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_mrope_cos_sin_with_three_distinct_streams(sections):
    """Three different (temporal, height, width) streams: each frequency
    takes its section's stream (three equal streams would give RoPE's
    cos/sin and could not tell the two apart)."""
    rot = 2 * sum(sections)
    rng = np.random.default_rng(5)
    positions = rng.integers(0, 4096, size=(3, 2, 11)).astype(np.int32)
    assert (positions[0] != positions[1]).any() and (positions[1] != positions[2]).any()
    jcos, jsin = jcommon.mrope_cos_sin(jnp.asarray(positions), rot, 1e6, sections)
    cos, sin = mrope_cos_sin(torch.as_tensor(positions), rot, 1e6, sections)
    assert cos.shape == (2, 11, rot // 2)
    _close(cos, jcos, atol=1e-5, rtol=1e-5)
    _close(sin, jsin, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        mrope_cos_sin(torch.as_tensor(positions), rot + 2, 1e6, sections)


def test_mrope_prefill_with_distinct_streams_matches_reference():
    """Qwen2-VL prefill over given (3, B, S) positions (a vision stub's
    streams), and the text-only default equal to passing three copies of
    the token positions."""
    jcfg, jparams, model = _pair("qwen2_vl_2b")
    toks = _tokens(jcfg, 2, 9, seed=6)
    positions = np.random.default_rng(7).integers(0, 64, size=(3, 2, 9)).astype(np.int32)
    jlogits, _ = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(positions)})
    tt = torch.as_tensor(toks, dtype=torch.long)
    logits, _ = model.prefill({"tokens": tt, "positions": torch.as_tensor(positions)})
    _close(logits, jlogits)
    default, _ = model.prefill({"tokens": tt})
    text = torch.arange(9, dtype=torch.int32).expand(3, 2, 9)
    given, _ = model.prefill({"tokens": tt, "positions": text})
    assert torch.equal(default, given) and not torch.allclose(default, logits)


@pytest.mark.parametrize("per_row", [True, False], ids=["pos_per_row", "pos_scalar"])
def test_mla_absorbed_decode_matches_reference_absorbed_and_expanded(per_row):
    """One MLA layer's decode over a bf16 latent cache: the port's absorbed
    form against the reference's absorbed and expanded forms."""
    jcfg, jparams, model = _pair("minicpm3_4b")
    cfg = model.cfg
    B, S = 3, 16
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    lat = {k: rng.standard_normal(s[1:]).astype(np.float32)
           for k, s in model.cache_shapes(B, S).items()}
    pos = np.array([3, 8, 15], np.int32) if per_row else np.int32(6)
    positions = pos[:, None] if per_row else np.full((B, 1), pos, np.int32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    tp = layer_params(model.params["layers"], 0)["mixer"]
    gold = {}
    for absorbed in (True, False):
        jc = {k: jnp.asarray(a, jnp.bfloat16) for k, a in lat.items()}
        gold[absorbed], jnew = jattn.mla_attention(
            jcfg, jp, jnp.asarray(x), positions=jnp.asarray(positions), mode="decode",
            cache=jc, pos=jnp.asarray(pos), absorbed_decode=absorbed)
    tc = {k: torch.as_tensor(a).to(torch.bfloat16) for k, a in lat.items()}
    out, new = attention.mla_attention(
        cfg, tp, torch.as_tensor(x), positions=torch.as_tensor(positions),
        mode="decode", cache=tc, pos=torch.as_tensor(pos, dtype=torch.long))
    assert new is tc
    _close(out, gold[True])
    _close(out, gold[False])
    for k in ("ckv", "kpe"):
        _close(new[k], jnew[k], atol=1e-2, rtol=1e-2)


def test_hybrid_layout_is_stacked_over_periods():
    """Jamba at two periods: every layer leaf and cache leaf leads with the
    scan steps (2), not the layers (16), under the ``pos{off}`` keys."""
    _, _, model = _pair("jamba_v0_1_52b@16")
    cfg = model.cfg
    assert lm.n_scan_steps(cfg) == 2
    kinds = lm.layer_kinds(cfg)
    assert [m for m, _ in kinds].count("attn") == 1 and [f for _, f in kinds].count("moe") == 4
    assert sorted(model.params["layers"]) == [f"pos{i}" for i in range(8)]
    assert all(t.shape[0] == 2 for _, t in _leaves(model.params["layers"]))
    shapes = model.cache_shapes(2, 24)
    assert shapes["pos4/k"] == (2, 2, 24, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert "pos0/ssm" in shapes and "pos4/ssm" not in shapes
    assert all(lm.is_positional(k) == (leaf_name(k) in ("k", "v")) for k in shapes)
    with pytest.raises(ValueError, match="periods"):
        lm.n_scan_steps(dataclasses.replace(cfg, num_layers=12))


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield path + k, v


@pytest.mark.parametrize("S", [31, 32, 33], ids=lambda s: f"S{s}")
def test_hybrid_decode_continues_prefill(S):
    """Jamba at two periods: prefill(S) and one decode step of token S give
    prefill(S + 1)'s logits around the reduced chunk (32), over an fp32
    cache."""
    jcfg, _, model = _pair("jamba_v0_1_52b@16")
    toks = torch.as_tensor(_tokens(jcfg, 1, S + 1, seed=9), dtype=torch.long)
    _, cache = model.prefill({"tokens": toks[:, :S]})
    pool = model.init_cache(1, S + 1, dtype=torch.float32)
    for k, v in cache.items():
        (pool[k][:, :, :S] if lm.is_positional(k) else pool[k]).copy_(v)
    stepped, _ = model.decode_step(toks[:, S:], pool, torch.tensor(S))
    full, _ = model.prefill({"tokens": toks})
    _close(stepped, full.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_full_width_cache_layout_matches_reference(arch):
    """The port's cache at the published widths is the reference's, leaf
    for leaf under the flat keys (shapes only; nothing is allocated)."""
    jshapes = _flat(jax_build(jax_config(arch)).cache_shapes(2, 64))
    shapes = lm.cache_shape(get_config(arch), 2, 64)
    assert sorted(shapes) == sorted(jshapes)
    for k, s in shapes.items():
        assert s == tuple(jshapes[k].shape), k


def test_bridge_checks_the_period_and_latent_leaves():
    """`bridge` reads the hybrid ``pos{off}`` subtrees and the MLA leaves
    off `lm.param_layout`: a wrong shape names its path, a missing leaf
    raises, a stray one too."""
    for arch, path in (("jamba_v0_1_52b", ("layers", "pos4", "mixer", "wq")),
                       ("minicpm3_4b", ("layers", "mixer", "w_uk"))):
        jcfg = _fp32(jax_reduced(arch))
        tree = jax.tree.map(np.asarray, jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
        cfg = _fp32(get_reduced_config(arch))
        parent = functools.reduce(lambda t, k: t[k], path[:-1], tree)
        good = parent[path[-1]]
        parent[path[-1]] = good[..., :-1]
        with pytest.raises(ValueError, match="/".join(path)):
            bridge.params_from_numpy(cfg, tree, device="cpu")
        del parent[path[-1]]
        with pytest.raises(KeyError):
            bridge.params_from_numpy(cfg, tree, device="cpu")
        parent[path[-1]] = good
        parent["stray"] = good
        with pytest.raises(ValueError, match="not a parameter"):
            bridge.params_from_numpy(cfg, tree, device="cpu")
