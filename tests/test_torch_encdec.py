"""The port's enc-dec Whisper against `repro.models.encdec` on the CPU.

A reduced fp32 ``whisper_large_v3`` with the reference's weights: prefill
logits, the self and cross K/V caches, and four greedy decode steps (one
position for the batch, then one per row) within atol = rtol = 1e-4 (XLA and
PyTorch sum in different orders), with the same greedy tokens. Plus the
shared primitives the family brings (`sinusoidal_positions`, `vocab_mask`,
the tanh GELU) and the parameter layout, leaf for leaf.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import Model, encdec
from repro_torch.models.common import act_fn, sinusoidal_positions, vocab_mask

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper_large_v3"


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = _fp32(jax_reduced(ARCH))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(ARCH))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg, params, device="cpu")


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **TOL)


def test_layout_matches_the_reference():
    _, jparams, model = _pair()
    want = {"/".join(str(k.key) for k in p): np.shape(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {n: tuple(t.shape) for n, t in tree_util.items(model.params)}
    assert got == want
    full = encdec.param_layout(get_config(ARCH))
    assert full["pos_embed"].shape == (32_768, 1280)
    assert full["enc_layers"]["attn"]["wq"].shape == (32, 1280, 1280)


def test_prefill_and_greedy_decode_match_the_reference():
    jmodel, jparams, model = _pair()
    cfg = model.cfg
    rng = np.random.default_rng(0)
    B, S, new, s_max = 2, 7, 4, 16
    frames = rng.standard_normal((B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)

    jlogits, jpre = jmodel.prefill(jparams, {"frames": jnp.asarray(frames),
                                             "tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, pre = model.prefill({"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(tokens)})
    _close(logits, jlogits)
    for part in ("self", "cross"):
        for leaf in ("k", "v"):
            _close(pre[f"{part}/{leaf}"], jpre[part][leaf])

    jcache = jmodel.init_cache(B, s_max, dtype=jnp.float32)
    jcache = {"self": {k: jcache["self"][k].at[:, :, :S].set(jpre["self"][k]) for k in "kv"},
              "cross": jpre["cross"]}
    cache = model.init_cache(B, s_max, dtype=torch.float32)
    for key, t in pre.items():
        cache[key][:, :, :t.shape[2]] = t
    jl, tl = jlogits, logits
    for i in range(new):
        jnext = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        tnext = tl.argmax(dim=-1, keepdim=True).to(torch.int32)
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        # the last two steps pass one position per row, as a serving engine does
        jpos = jnp.asarray(S + i, jnp.int32) if i < 2 else jnp.full((B,), S + i, jnp.int32)
        jl, jcache = jmodel.decode_step(jparams, jnext, jcache, jpos)
        with torch.no_grad():
            tl, cache = model.decode_step(tnext, cache, torch.tensor(np.asarray(jpos)))
        _close(tl, jl)
    for leaf in ("k", "v"):
        _close(cache[f"self/{leaf}"], jcache["self"][leaf])


def test_train_loss_on_the_facade_and_missing_inputs():
    _, _, model = _pair()
    with pytest.raises(KeyError):
        model.train_loss({"tokens": torch.zeros((1, 5), dtype=torch.int32)})
    with pytest.raises(ValueError, match="encoder output"):
        encdec.decode_stack(model.cfg, model.params, torch.zeros((1, 3), dtype=torch.int32),
                            mode="train")


def test_shared_primitives_match_the_reference():
    # sin and cos of fp32 arguments up to ~36 rad: one ulp of the argument
    # (the two frameworks' exp) is ~4e-6 there
    np.testing.assert_allclose(sinusoidal_positions(37, 64).numpy(),
                               np.asarray(jcommon.sinusoidal_positions(37, 64)), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(vocab_mask(250, 256).numpy(),
                                  np.asarray(jcommon.vocab_mask(250, 256)))
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(act_fn("gelu")(torch.from_numpy(x)).numpy(),
                               np.asarray(jcommon.act_fn("gelu")(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
