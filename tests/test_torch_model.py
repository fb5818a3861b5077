"""The port's model against the JAX reference on the CPU.

Reduced fp32 ``minitron_4b`` (dense, GQA, layernorm, relu2) and
``qwen2_moe_a2_7b`` (MoE with shared experts, rmsnorm, silu), with the
reference's own ``init_params(PRNGKey(0))`` weights carried over by
`repro_torch.bridge`. Tolerance atol = rtol = 1e-4: XLA and PyTorch sum in
different orders on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro_torch import bridge
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import Model, lm, mlp
from repro_torch.models.lm import layer_params

ARCHS = ["minitron_4b", "qwen2_moe_a2_7b"]
#: every decoder-only architecture of the reference (all ported)
DECODER_ARCHS = ["minicpm3_4b", "nemotron_4_340b", "minitron_4b", "deepseek_coder_33b",
                 "qwen2_vl_2b", "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b",
                 "jamba_v0_1_52b", "mamba2_370m"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port Model on the CPU) with shared weights."""
    arch = request.param
    jcfg = _fp32(jax_reduced(arch))
    jparams = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(arch))
    tparams = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, Model(cfg, tparams, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def test_prefill_logits_and_cache_match_reference(pair):
    jcfg, jparams, model = pair
    toks = _tokens(jcfg, 2, 13)
    jlogits, jcache = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks, dtype=torch.long)})
    assert logits.shape == tuple(jlogits.shape)
    _close(logits, jlogits)
    for name in ("k", "v"):
        assert cache[name].shape == tuple(jcache[name].shape)
        _close(cache[name], jcache[name])


def test_prefill_true_len_reads_the_padded_bucket(pair):
    jcfg, jparams, model = pair
    toks = _tokens(jcfg, 1, 16, seed=1)
    true_len = 11
    jlogits, _ = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks), "true_len": jnp.asarray(true_len, jnp.int32)})
    tt = torch.as_tensor(toks, dtype=torch.long)
    logits, _ = model.prefill({"tokens": tt, "true_len": true_len})
    _close(logits, jlogits)
    exact, _ = model.prefill({"tokens": tt[:, :true_len]})
    _close(logits, exact.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_row", [True, False], ids=["pos_per_row", "pos_scalar"])
def test_decode_step_over_bf16_cache_matches_reference(pair, per_row):
    """Decode reads a bf16 cache and upcasts it (the reference's default
    cache dtype, even for an fp32 model)."""
    jcfg, jparams, model = pair
    B, S = 3, 16
    rng = np.random.default_rng(2)
    shape = (jcfg.num_layers, B, S, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    kv = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    jcache = {n: jnp.asarray(a, jnp.bfloat16) for n, a in kv.items()}
    tcache = {n: torch.as_tensor(a).to(torch.bfloat16) for n, a in kv.items()}
    toks = _tokens(jcfg, B, 1, seed=3)
    pos = np.array([4, 9, 15], np.int32) if per_row else np.int32(7)
    jlogits, jnew = jax.jit(lambda p, t, c, q: jlm.decode_step(jcfg, p, t, c, q))(
        jparams, jnp.asarray(toks), jcache, jnp.asarray(pos))
    logits, new = model.decode_step(torch.as_tensor(toks, dtype=torch.long), tcache,
                                    torch.as_tensor(pos, dtype=torch.long))
    _close(logits, jlogits)
    for n in ("k", "v"):   # the one written entry per row rounds to bf16
        _close(new[n], jnp.asarray(jnew[n], jnp.float32), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("S", [7, 600], ids=["dropfree", "capacity"])
def test_moe_ffn_matches_reference(S):
    """Both routes (kernel wrapper on the CPU and plain `router_topk`)
    against `repro.models.mlp.moe_ffn`; S=600 makes a group over
    EXACT_SMALL_G, where capacity drops tokens."""
    jcfg = _fp32(jax_reduced("qwen2_moe_a2_7b"))
    jparams = jax_build(jcfg).init_params(jax.random.PRNGKey(1))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    cfg = _fp32(get_reduced_config("qwen2_moe_a2_7b"))
    tp = layer_params(bridge.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")["layers"], 0)["ffn"]
    x = np.random.default_rng(4).standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(lambda p, x: jmlp.moe_ffn(jcfg, p, x))(jp, jnp.asarray(x))
    for kernel in (True, False):
        out, aux = mlp.moe_ffn(cfg, tp, torch.as_tensor(x), kernel=kernel, want_aux=True)
        _close(out, jout)
        _close(aux, jaux)
        out_serving, no_aux = mlp.moe_ffn(cfg, tp, torch.as_tensor(x), kernel=kernel)
        assert no_aux is None and torch.equal(out_serving, out)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_full_width_layout_matches_reference(arch):
    """The port's parameter layout at the published widths is the
    reference's pytree, leaf for leaf (shapes and dtypes; nothing is
    allocated)."""
    jshapes = jax_build(jax_config(arch)).param_shapes()
    layout = lm.param_layout(get_config(arch))
    flat = {}
    lm.map_layout(lambda path, leaf: flat.setdefault(path, leaf), layout)
    jflat = {"/".join(k.key for k in path): s
             for path, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert sorted(flat) == sorted(jflat)
    for path, leaf in flat.items():
        assert leaf.shape == tuple(jflat[path].shape), path
        assert str(leaf.dtype).replace("torch.", "") == str(jflat[path].dtype), path


def test_init_params_keeps_the_reference_std_rule():
    """Expert weights ``(E_pad, d, ff)`` get std ``E_pad ** -0.5`` (fan-in is
    shape[0]), so the random model has the reference's activation scale."""
    cfg = _fp32(get_reduced_config("qwen2_moe_a2_7b"))
    model = Model(cfg, device="cpu", seed=0)
    e_pad = mlp.padded_experts(cfg.moe.num_experts)
    w_up = model.params["layers"]["ffn"]["w_up"]
    assert w_up.shape == (cfg.num_layers, e_pad, cfg.d_model, cfg.moe.d_expert)
    assert abs(w_up.std().item() / e_pad ** -0.5 - 1) < 0.05
    wq = model.params["layers"]["mixer"]["wq"]
    assert abs(wq.std().item() / cfg.d_model ** -0.5 - 1) < 0.05
    again = Model(cfg, device="cpu", seed=0)
    assert torch.equal(again.params["embed"], model.params["embed"])


def test_bridge_checks_every_shape():
    jcfg = _fp32(jax_reduced("minitron_4b"))
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init_params(jax.random.PRNGKey(0)))
    cfg = _fp32(get_reduced_config("minitron_4b"))
    tree["layers"]["mixer"]["wq"] = tree["layers"]["mixer"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="layers/mixer/wq"):
        bridge.params_from_numpy(cfg, tree, device="cpu")
    del tree["layers"]["mixer"]["wq"]
    with pytest.raises(KeyError):
        bridge.params_from_numpy(cfg, tree, device="cpu")
