"""The port's Mamba2 pieces against the JAX reference on the CPU.

The SSD scan's plain version (`kernels.ops.ssd_scan` on a CPU tensor) against
the Pallas kernel, run as `tests/test_kernels.py` runs it (through
`repro.kernels.ops`, in interpret mode), and against the reference's
`ssd_scan_ref`; then `ssm_block` and the reduced fp32 ``mamba2_370m`` with
the reference's own weights carried over by `repro_torch.bridge`. Tolerance
atol = rtol = 1e-4, as in `tests/test_kernels.py`: the sums run in other
orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, ssm
from repro_torch.models.common import gated_rmsnorm
from repro_torch.models.lm import layer_params

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2_370m"


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


def _close(port, gold, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(gold, np.float32), **(tol or TOL))


def _ssd_inputs(B, S, H, P, G, N, seed):
    """Numpy inputs as `tests/test_kernels.py` draws them: dt after softplus,
    A = -exp(0.5 z)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f),
            (-np.exp(0.5 * rng.standard_normal(H))).astype(f),
            rng.standard_normal((B, S, G, N)).astype(f),
            rng.standard_normal((B, S, G, N)).astype(f))


@pytest.mark.parametrize("HG", [(2, 1), (4, 2), (4, 4)], ids=lambda hg: f"H{hg[0]}G{hg[1]}")
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [37, 96])
def test_ssd_scan_matches_pallas_kernel_and_reference(S, chunk, HG):
    H, G = HG
    inp = _ssd_inputs(1, S, H, 16, G, 32, seed=S + chunk + H + G)
    y, h = ops.ssd_scan(*map(torch.as_tensor, inp), chunk=chunk)
    jin = [jnp.asarray(a) for a in inp]
    for gold_y, gold_h in (jops.ssd_scan(*jin, chunk=chunk),
                           jssm.ssd_scan_ref(*jin, chunk=chunk)):
        _close(y, gold_y)
        _close(h, gold_h)
    assert y.dtype == torch.float32 and h.shape == (1, H, 16, 32)


def test_chunked_scan_equals_stepwise_recurrence():
    """The chunked scan (ragged S, an initial state) equals the per-token
    recurrence `ssd_step_ref` that decode runs."""
    B, S, H, P, G, N = 2, 37, 4, 8, 2, 16
    x, dt, A, Bm, Cm = map(torch.as_tensor, _ssd_inputs(B, S, H, P, G, N, seed=7))
    h0 = torch.as_tensor(np.random.default_rng(1).standard_normal((B, H, P, N)),
                         dtype=torch.float32)
    y_chunk, h_chunk = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=16, init_state=h0)
    h, ys = h0, []
    for t in range(S):
        y_t, h = ssm.ssd_step_ref(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y_t)
    _close(y_chunk, torch.stack(ys, dim=1).numpy())
    _close(h_chunk, h.numpy())


def test_gated_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x, z = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(32).astype(np.float32)
    out = gated_rmsnorm(*map(torch.as_tensor, (x, z, scale)), 1e-5)
    _close(out, jcommon.gated_rmsnorm(*map(jnp.asarray, (x, z, scale)), 1e-5),
           atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port Model on the CPU) with shared weights."""
    jcfg = _fp32(jax_reduced(ARCH))
    jparams = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(ARCH))
    tparams = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, Model(cfg, tparams, device="cpu")


def test_ssm_block_prefill_and_decode_match_reference(pair):
    jcfg, jparams, model = pair
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    p = layer_params(model.params["layers"], 0)["mixer"]
    xin = np.random.default_rng(3).standard_normal((2, 45, jcfg.d_model)).astype(np.float32)
    jblock = jax.jit(lambda p, x, s: jssm.ssm_block(jcfg, p, x, mode="decode" if s else "prefill",
                                                     state=s))
    jout, jstate = jblock(jp, jnp.asarray(xin), None)
    out, state = ssm.ssm_block(model.cfg, p, torch.as_tensor(xin), mode="prefill")
    _close(out, jout)
    assert set(state) == set(jstate)
    for k in state:
        _close(state[k], jstate[k])
    x1 = np.random.default_rng(4).standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jout, jstate = jblock(jp, jnp.asarray(x1), jstate)
    out, state2 = ssm.ssm_block(model.cfg, p, torch.as_tensor(x1), mode="decode", state=state)
    assert state2 is state                     # decode updates in place
    _close(out, jout)
    for k in state:
        _close(state[k], jstate[k])


def test_decode_from_a_zero_state_matches_reference(pair):
    """`init_ssm_state` is the reference's zero state, bf16 conv histories
    and an fp32 ``ssm`` leaf."""
    jcfg, jparams, model = pair
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    p = layer_params(model.params["layers"], 0)["mixer"]
    state = ssm.init_ssm_state(model.cfg, 2, device=torch.device("cpu"))
    jstate = jssm.init_ssm_state(jcfg, 2)
    assert {k: v.dtype for k, v in state.items()} == {
        "conv_x": torch.bfloat16, "conv_B": torch.bfloat16, "conv_C": torch.bfloat16,
        "ssm": torch.float32}
    x1 = np.random.default_rng(5).standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jout, jstate = jax.jit(lambda p, x, s: jssm.ssm_block(jcfg, p, x, mode="decode", state=s))(
        jp, jnp.asarray(x1), jstate)
    out, state = ssm.ssm_block(model.cfg, p, torch.as_tensor(x1), mode="decode", state=state)
    _close(out, jout)
    for k in state:
        _close(state[k], np.asarray(jstate[k], np.float32))


def test_mamba2_prefill_and_decode_logits_match_reference(pair):
    jcfg, jparams, model = pair
    toks = np.random.default_rng(0).integers(2, jcfg.vocab_size, size=(2, 45)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: jlm.prefill(jcfg, p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill({"tokens": torch.as_tensor(toks, dtype=torch.long)})
    _close(logits, jlogits)
    assert model.cache_shapes(2, 99) == {k: tuple(v.shape) for k, v in jcache.items()}
    for k in cache:
        _close(cache[k], jcache[k])
    jdecode = jax.jit(lambda p, t, c, pos: jlm.decode_step(jcfg, p, t, c, pos))
    for step in range(3):
        nxt = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
        pos = 45 + step
        jlogits, jcache = jdecode(jparams, jnp.asarray(nxt), jcache, jnp.asarray(pos, jnp.int32))
        logits, cache = model.decode_step(torch.as_tensor(nxt, dtype=torch.long), cache,
                                          torch.tensor(pos))
        _close(logits, jlogits)
    for k in cache:
        _close(cache[k], jcache[k])


def test_param_layout_and_init_follow_reference():
    """In the reference's bf16 tree ``dt_bias``, ``A_log`` and ``D`` are
    fp32: the bridge carries the tree over only if every key, shape and
    dtype agrees. Random init keeps the reference's deterministic leaves."""
    jcfg = jax_reduced(ARCH)
    jparams = jax_build(jcfg).init_params(jax.random.PRNGKey(0))
    cfg = get_reduced_config(ARCH)
    tparams = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    mixer = tparams["layers"]["mixer"]
    assert set(tparams["layers"]) == {"mixer_norm", "mixer"}
    assert {k for k, v in mixer.items() if v.dtype == torch.float32} == {"dt_bias", "A_log", "D"}
    fresh = Model(cfg, device="cpu").params["layers"]["mixer"]
    for k in ("dt_bias", "A_log", "D", "conv_x_b", "norm_scale"):
        assert fresh[k].dtype == mixer[k].dtype
        _close(fresh[k], np.asarray(jparams["layers"]["mixer"][k], np.float32), atol=1e-6, rtol=1e-6)
    assert torch.allclose(fresh["conv_x_w"].float().std(), torch.tensor(0.5), rtol=0.1)
