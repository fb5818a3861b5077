"""The port's train step against the reference's `make_train_step` on the
CPU: one step from the same weights, AdamW state and batch, without and with
gradient accumulation (and with bf16 gradient reduction).

Tolerances: the loss (the mean over microbatches) and the last microbatch's
metrics within 1e-5 relative. Parameters after the step within atol 1e-6 +
rtol 1e-5, except where Adam's first step flips: it moves each coordinate by
~lr sign(g), so a coordinate whose gradient is ~0 (a few ulps, below the two
frameworks' rounding difference) can move the other way. Such a coordinate
must still be within 2 lr (1 + weight decay) + 1e-6 of the reference's, and
they must be at most 0.1 % of all. The moments within atol 1e-7 + rtol
1e-4; with bf16 gradient reduction all but 0.1 % of them: a gradient whose
fp32 values straddle a bf16 rounding boundary rounds one bf16 ulp (2**-8
relative) apart in the two frameworks, and its moment with it.

With bf16 parameters and activations (the reduced configs as they stand,
fp32 moments, Adam's first step at the LR the card's train phase runs): the
loss within 1e-3 relative (each bf16 rounding is 2**-9 relative, and the
two frameworks round in other places), and the parameters after the step
equal bit for bit, except where the two bf16 forwards give a gradient
opposite signs: there the first step (~lr sign(g)) moves the other way, so
such a coordinate must be within 2 lr (1 + weight decay |p|) + one bf16 ulp
(2**-7 |p|) of the reference's, and at most 0.5 % of all (0.12-0.16 %
seen). The step moves a third or more of the coordinates, so a fault of the
in-place update's bf16 write-back could not pass.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_reduced_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamW

LR, WD = 1e-3, 0.1
CASES = [("minitron_4b", 1, None), ("minitron_4b", 2, None), ("minitron_4b", 2, "bfloat16"),
         ("qwen2_moe_a2_7b", 2, None), ("mamba2_370m", 1, None), ("qwen2_vl_2b", 2, None),
         ("whisper_large_v3", 2, None)]


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = _fp32(jax_reduced(arch))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    return jmodel, jparams, _fp32(get_reduced_config(arch))


def _batch(cfg, B=4, S=16):
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    tokens[1, 4] = 1
    out = {"tokens": tokens, "loss_mask": (tokens[:, 1:] != 1).astype(np.float32)}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.pos_type == "mrope":
        a = np.arange(S + 1)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([a, a // 2, a % 3])[:, None], (3, B, S + 1)).astype(np.int32))
    return out


def _named(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,accum,reduce_dtype", CASES,
                         ids=[f"{a}-accum{n}-{d or 'fp32'}" for a, n, d in CASES])
def test_train_step_matches_reference(arch, accum, reduce_dtype):
    jmodel, jparams, cfg = _setup(arch)
    batch = _batch(cfg)
    kw = dict(lr=LR, weight_decay=WD)
    # a nonzero state, so the step's moments and bias corrections all count
    rng = np.random.default_rng(5)
    jstate = {"m": jax.tree.map(lambda p: jnp.asarray(
                  1e-3 * rng.standard_normal(p.shape), p.dtype), jparams),
              "v": jax.tree.map(lambda p: jnp.asarray(
                  1e-6 * rng.random(p.shape), p.dtype), jparams),
              "count": jnp.asarray(0, jnp.int32)}
    state_np = jax.tree.map(np.asarray, jstate)
    jstep = jax_make_train_step(jmodel, JaxAdamW(**kw), accum_steps=accum,
                                grad_reduce_dtype=reduce_dtype)
    jp, js, jloss, jmet = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    state = bridge.opt_state_from_numpy(cfg, state_np, device="cpu")
    step = make_train_step(Model(cfg, params, device="cpu"), AdamW(**kw), accum_steps=accum,
                           grad_reduce_dtype=reduce_dtype)
    tp, ts, loss, met = step(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert tp is params and ts is state

    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for key in ("ce", "moe_aux"):
        assert abs(float(met[key]) - float(jmet[key])) <= 1e-5 * max(abs(float(jmet[key])), 1e-6)
    assert int(ts["count"]) == int(js["count"]) == 1
    want = _named(jp)
    flipped = total = 0
    for name, t in tree_util.items(tp):
        got, ref = t.numpy(), want[name]
        close = np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref)
        flipped += int((~close).sum())
        total += got.size
        bound = 2 * LR * (1 + WD * np.abs(ref)) + 1e-6 + 1e-5 * np.abs(ref)
        assert (np.abs(got - ref) <= bound).all(), name
    assert flipped <= 1e-3 * total, (flipped, total)
    for key in ("m", "v"):
        want = _named(js[key])
        apart = 0
        for name, t in tree_util.items(ts[key]):
            close = np.isclose(t.numpy(), want[name], atol=1e-7, rtol=1e-4)
            assert reduce_dtype is not None or close.all(), f"{key}/{name}"
            apart += int((~close).sum())
        assert apart <= 1e-3 * total, (key, apart, total)


BF16_CASES = ["minitron_4b", "mamba2_370m", "whisper_large_v3"]


@pytest.mark.parametrize("arch", BF16_CASES)
def test_bf16_train_step_matches_reference(arch):
    jcfg = jax_reduced(arch)
    cfg = get_reduced_config(arch)
    assert jcfg.param_dtype == cfg.param_dtype == "bfloat16" == cfg.activ_dtype
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    kw = dict(lr=1e-4, weight_decay=WD)
    jstate = JaxAdamW(**kw).init(jparams)
    jstep = jax_make_train_step(jmodel, JaxAdamW(**kw))
    start = _named(jparams)
    jp, _, jloss, _ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    opt = AdamW(**kw)
    state = opt.init(params)
    step = make_train_step(Model(cfg, params, device="cpu"), opt)
    tp, _, loss, _ = step(params, state, {k: torch.as_tensor(v) for k, v in batch.items()})

    assert abs(float(loss) - float(jloss)) <= 1e-3 * abs(float(jloss))
    want = _named(jp)
    dtypes = {"/".join(str(k.key) for k in path): v.dtype.name
              for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flipped = moved = total = 0
    for name, t in tree_util.items(tp):
        assert str(t.dtype).removeprefix("torch.") == dtypes[name], name
        got, ref = t.float().numpy(), want[name]
        bound = 2 * kw["lr"] * (1 + WD * np.abs(ref)) + 2.0 ** -7 * np.abs(ref)
        assert (np.abs(got - ref) <= bound).all(), name
        flipped += int((got != ref).sum())
        moved += int((ref != start[name]).sum())
        total += got.size
    assert moved >= total // 3, (moved, total)
    assert flipped <= 5e-3 * total, (flipped, total)


def test_accumulation_splits_positions_on_their_batch_axis():
    from repro_torch.launch.steps import _split_micro
    batch = {"tokens": torch.arange(24).reshape(4, 6),
             "positions": torch.arange(72).reshape(3, 4, 6)}
    micro = _split_micro(batch, 2)
    assert len(micro) == 2
    torch.testing.assert_close(micro[1]["tokens"], batch["tokens"][2:])
    torch.testing.assert_close(micro[1]["positions"], batch["positions"][:, 2:])
    with pytest.raises(ValueError, match="multiple"):
        _split_micro(batch, 3)
