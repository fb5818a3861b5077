"""The port's training loss and gradients against the JAX reference on the CPU.

Seven reduced fp32 architectures, one per family the reference trains:
dense GQA (``minitron_4b``), MoE with its aux loss (``qwen2_moe_a2_7b``),
Mamba2 (``mamba2_370m``), hybrid periods (``jamba_v0_1_52b``), MLA
(``minicpm3_4b``), M-RoPE (``qwen2_vl_2b``, with three distinct position
streams) and the enc-dec Whisper (``whisper_large_v3``), with the reference's
own ``init_params(PRNGKey(0))`` weights carried over by `repro_torch.bridge`.
Tolerances: the loss and its metrics within 1e-5 relative, every gradient
within atol 1e-5 + rtol 1e-4 (XLA and PyTorch sum in different orders). The
train path must reach no kernel wrapper.
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
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import Model, lm

ARCHS = ["minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m", "jamba_v0_1_52b",
         "minicpm3_4b", "qwen2_vl_2b", "whisper_large_v3"]
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 16


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


def train_batch(cfg, seed=0, batch=B, seq=S):
    """A numpy train batch: ``tokens (B, S + 1)`` with a BOS inside, its
    loss mask, stub frames for an enc-dec model, and M-RoPE positions whose
    three streams differ."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    tokens[0, 5] = 1
    out = {"tokens": tokens, "loss_mask": (tokens[:, 1:] != 1).astype(np.float32)}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.pos_type == "mrope":
        a = np.arange(seq + 1)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([a, a // 2, a % 3])[:, None], (3, batch, seq + 1)).astype(np.int32))
    return out


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(jax model, jax params, the port's fp32 config, its params on the
    CPU) with shared weights."""
    jcfg = _fp32(jax_reduced(arch))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(arch))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, cfg, params


def _named(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's (loss, metrics, named grads) on `train_batch`."""
    jmodel, jparams, cfg, _ = pair(arch)
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, batch), has_aux=True)(jparams)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _named(grads)


def port_loss_and_grads(model, batch, params=None):
    """The port's (loss, metrics, grads in `tree.items` order)."""
    params = model.params if params is None else params
    leaves = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    loss, metrics = model.train_loss(batch, params=tree_util.like(params, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _torch_batch(cfg, **kw):
    return {k: torch.as_tensor(v) for k, v in train_batch(cfg, **kw).items()}


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper raises: the train path must never reach one."""
    def refuse(*_, **__):
        raise AssertionError("the train path reached a kernel wrapper")
    for name in ("flash_attention", "moe_topk", "ssd_scan"):
        monkeypatch.setattr(ops, name, refuse)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, no_kernels):
    _, _, cfg, params = pair(arch)
    want_loss, want_metrics, want_grads = reference(arch)
    loss, metrics, grads = port_loss_and_grads(Model(cfg, params, device="cpu"),
                                               _torch_batch(cfg))
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for key in ("ce", "moe_aux"):
        assert abs(metrics[key] - want_metrics[key]) <= LOSS_RTOL * max(abs(want_metrics[key]), 1e-6)
    if cfg.moe is not None:
        assert metrics["moe_aux"] > 0
    names = [name for name, _ in tree_util.items(params)]
    assert names == list(want_grads)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_chunk_gives_the_unchunked_loss(arch):
    """The chunked cross-entropy (each chunk recomputed in backward) gives
    the unchunked loss and gradients."""
    _, _, cfg, params = pair(arch)
    batch = _torch_batch(cfg)
    whole = port_loss_and_grads(Model(cfg, params, device="cpu"), batch)
    chunked = port_loss_and_grads(Model(cfg, params, device="cpu", loss_chunk=4), batch)
    assert abs(whole[0] - chunked[0]) <= 1e-6 * abs(whole[0])
    for a, b in zip(whole[2], chunked[2]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        Model(cfg, params, device="cpu", loss_chunk=5).train_loss(batch)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper_large_v3"])
def test_remat_policies_give_equal_grads(arch):
    """"nothing", "dots" and no remat at all give the same gradients (the
    recompute runs the same ops); an unknown policy raises."""
    _, _, cfg, params = pair(arch)
    batch = _torch_batch(cfg)
    grads = {p: port_loss_and_grads(Model(cfg, params, device="cpu", remat_policy=p), batch)[2]
             for p in ("nothing", "dots")}
    leaves = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    tokens = batch["tokens"]
    positions = batch.get("positions")
    hidden, _, aux = lm.forward(cfg, tree_util.like(params, leaves), tokens[:, :-1],
                                mode="train", remat=False,
                                positions=None if positions is None else positions[..., :-1])
    loss = lm.cross_entropy(cfg, tree_util.like(params, leaves), hidden, tokens[:, 1:],
                            mask=batch["loss_mask"]) + 0.01 * aux
    grads["none"] = torch.autograd.grad(loss, leaves)
    for policy in ("dots", "none"):
        for a, b in zip(grads["nothing"], grads[policy]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="remat policy"):
        Model(cfg, params, device="cpu", remat_policy="everything").train_loss(batch)
