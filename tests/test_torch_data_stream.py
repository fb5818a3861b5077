"""The port's synthetic data stream against the reference's, bit for bit.

The port draws the reference's threefry bits with its key law
(`repro_torch.data.threefry`), so `make_batch` gives the reference's
tokens, loss mask, bf16 frames and M-RoPE positions at every (seed, step),
on every reduced config; three witnesses at larger shapes; each step's keys
and bits; a slice of rows drawn alone. A CUDA stream equals the CPU stream
(marked ``cuda``: it skips without a card). Last, the port's `TrainRunner`
over its own stream follows the reference runner over the reference's
(within the 1e-4 relative of `tests/test_torch_runtime.py`).

The reference is imported inside the tests that read it, so the card's
machine (no JAX) collects the ``cuda`` test alone.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, ShapeCell, get_reduced_config
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.data import threefry as tf

WITNESSES = [(1000, 256, 16, 1, 7), (32000, 1024, 4, 0, 0), (256, 32, 4, 0, 11)]


def _bits(x):
    """An array's bits, so equality is bit for bit (bf16 as int16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _port_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_same_batch(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        want, got = _bits(ref[k]), _port_bits(port[k])
        assert got.dtype == want.dtype, k
        assert got.shape == want.shape, k
        assert np.array_equal(got, want), (k, float(np.mean(got == want)))


@pytest.mark.parametrize("step", [0, 1, 7])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_equals_reference(arch, step):
    from repro.configs import get_reduced_config as jax_reduced
    from repro.configs.base import ShapeCell as JaxShapeCell
    from repro.data import make_batch as jax_make_batch
    B, S = 3, 24
    ref = jax_make_batch(jax_reduced(arch), JaxShapeCell("t", "train", S, B), step=step, seed=2)
    port = make_batch(get_reduced_config(arch), ShapeCell("t", "train", S, B), step=step,
                      seed=2, device="cpu")
    _assert_same_batch(port, ref)


@pytest.mark.parametrize("vocab,seq,batch,seed,step", WITNESSES)
def test_witnesses_equal_reference(vocab, seq, batch, seed, step):
    from repro.data import SyntheticLM as JaxSyntheticLM
    ref = JaxSyntheticLM(vocab, seq, batch, seed=seed).batch_at(step)
    port = SyntheticLM(vocab, seq, batch, seed=seed, device="cpu").batch_at(step)
    _assert_same_batch(port, ref)


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (3, 11), (-5, 2), (2 ** 32 - 1, 123456)])
def test_keys_and_bits_equal_reference(seed, step):
    import jax
    import jax.numpy as jnp
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    key = tf.fold_in(tf.prng_key(seed), step)
    assert key == tuple(int(w) for w in np.asarray(jax.random.key_data(jkey)))
    for jk, k in zip(jax.random.split(jkey), tf.split(key)):
        assert k == tuple(int(w) for w in np.asarray(jax.random.key_data(jk)))
        shape = (5, 37)
        assert np.array_equal(tf.uniform(k, shape, device="cpu").numpy().view(np.int32),
                              np.asarray(jax.random.uniform(jk, shape)).view(np.int32))
        assert np.array_equal(_port_bits(tf.normal_bf16(k, shape, device="cpu")),
                              _bits(jax.random.normal(jk, shape, jnp.bfloat16)))


def test_pow_unit_is_the_references_power_on_every_uniform():
    """Every fp32 uniform (2^23 of them): `pow_unit(u, 4.0)` is the
    reference's ``u ** 4.0`` (the C library's ``powf``, which torch's
    ``pow`` is not, and differently on the CPU and the card)."""
    import jax.numpy as jnp
    u = ((torch.arange(2 ** 23, dtype=torch.int64) | 0x3F800000)
         .to(torch.int32).view(torch.float32) - 1.0)
    want = np.asarray(jnp.asarray(u.numpy()) ** 4.0)
    assert np.array_equal(tf.pow_unit(u, 4.0).numpy().view(np.int32), want.view(np.int32))


def test_prng_key_refuses_a_seed_wider_than_32_bits():
    with pytest.raises(ValueError):
        tf.prng_key(2 ** 32)


def test_rows_drawn_alone_equal_the_batch():
    ds = SyntheticLM(500, 40, 7, seed=4, device="cpu")
    whole = ds.batch_at(3)
    for lo, hi in [(0, 7), (0, 2), (2, 5), (6, 7), (3, 3)]:
        part = ds.rows_at(3, (lo, hi))
        for k in whole:
            assert torch.equal(part[k], whole[k][lo:hi]), (k, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron_4b", "whisper_large_v3", "qwen2_vl_2b"])
def test_cuda_stream_equals_cpu_stream(arch):
    """At the published vocab and frame widths: a token's integer part
    turns on the last bit of ``u ** 4``, a frame on ``erfinv``'s."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cell = ShapeCell("t", "train", 1024, 4)
    for step in (0, 5):
        cpu = make_batch(cfg, cell, step=step, seed=1, device="cpu")
        gpu = make_batch(cfg, cell, step=step, seed=1, device="cuda")
        for k in cpu:
            assert torch.equal(_as_bits(gpu[k].cpu()), _as_bits(cpu[k])), (arch, step, k)


def _as_bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_runner_on_its_own_stream_follows_the_reference_runner(tmp_path):
    import jax

    from repro.configs import get_reduced_config as jax_reduced
    from repro.data import SyntheticLM as JaxSyntheticLM
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import build_model as jax_build
    from repro.optim import AdamW as JaxAdamW
    from repro.optim import warmup_cosine as jax_warmup_cosine
    from repro.runtime import TrainRunner as JaxTrainRunner
    from repro_torch import bridge
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime import TrainRunner

    fp32 = dict(param_dtype="float32", activ_dtype="float32")
    jcfg = dataclasses.replace(jax_reduced("minitron_4b"), **fp32)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-3, 5, 100))
    jrunner = JaxTrainRunner(step_fn=jax.jit(jax_make_train_step(jmodel, jopt)),
                             params=jparams, opt_state=jopt.init(jparams),
                             dataset=JaxSyntheticLM(jcfg.vocab_size, 32, 4, seed=0),
                             ckpt_dir=tmp_path / "ref", ckpt_every=100)
    jrunner.run(12)

    cfg = dataclasses.replace(get_reduced_config("minitron_4b"), **fp32)
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    model = Model(cfg, params, device="cpu")
    opt = AdamW(lr=warmup_cosine(1e-3, 5, 100))
    runner = TrainRunner(step_fn=make_train_step(model, opt), params=model.params,
                         opt_state=opt.init(model.params),
                         dataset=SyntheticLM(cfg.vocab_size, 32, 4, seed=0, device="cpu"),
                         ckpt_dir=tmp_path / "port", ckpt_every=100)
    runner.run(12)
    np.testing.assert_allclose(runner.losses, jrunner.losses, rtol=1e-4, atol=0)
    assert runner.losses[-1] < runner.losses[0]
