"""The port's AdamW, LR schedule and int8 gradient compression against the
JAX reference on the CPU, on identical numpy inputs.

AdamW: three steps of `update` from one state, with clipping on (a global
norm above the clip, so the scale bites) and off, and with bf16 moments;
parameters and moments within 1e-6 (atol = rtol; both compute in fp32 in the
same order of operations, the port in place). Compression: ``q`` equal,
scales and residuals equal (both round half to even).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.compress import compress_grads_int8 as jax_compress
from repro.optim.compress import decompress_grads_int8 as jax_decompress
from repro_torch import bridge, tree as tree_util
from repro_torch.optim import (AdamW, compress_grads_int8, decompress_grads_int8,
                               init_residual, warmup_cosine)

TOL = dict(atol=1e-6, rtol=1e-6)


def _tree(rng, scale=1.0):
    """A small nested tree: 2-D and 3-D leaves (decayed) and a 1-D one (not)."""
    return {"a": {"w": (scale * rng.standard_normal((4, 6))).astype(np.float32),
                  "b": (scale * rng.standard_normal((6,))).astype(np.float32)},
            "z": (scale * rng.standard_normal((2, 3, 5))).astype(np.float32)}


def _torch(tree, dtype=None):
    return tree_util.map_tree(
        lambda _, a: torch.from_numpy(np.array(a)).to(dtype or torch.from_numpy(np.array(a)).dtype),
        tree)


def _numpy(tree):
    return tree_util.map_tree(lambda _, t: t.float().numpy(), tree)


def test_warmup_cosine_matches_reference():
    j = jax_warmup_cosine(3e-4, 5, 40, floor=0.1)
    t = warmup_cosine(3e-4, 5, 40, floor=0.1)
    for step in range(0, 46):
        want = float(j(jnp.asarray(step, jnp.int32)))
        assert abs(float(t(step)) - want) <= 1e-6 * want + 1e-12, step
        assert abs(float(t(torch.tensor(step, dtype=torch.int32))) - want) <= 1e-6 * want + 1e-12


@pytest.mark.parametrize("clip,state_dtype,lr", [
    (1.0, None, 1e-2), (None, None, 1e-2), (1.0, "bfloat16", 1e-2),
    (0.5, None, "schedule")], ids=["clip", "no_clip", "bf16_state", "schedule"])
def test_adamw_update_matches_reference(clip, state_dtype, lr):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(3)]      # global norm ~> the clip
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=clip,
              state_dtype=state_dtype)
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-2, 2, 10) if lr == "schedule" else lr, **kw)
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10) if lr == "schedule" else lr, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch(params)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        out_p, out_s = topt.update(_torch(g), ts, tp)
        assert out_p is tp and out_s is ts                    # in place
    assert int(ts["count"]) == int(js["count"]) == 3
    for name, t in tree_util.items(tp):
        np.testing.assert_allclose(t.numpy(), _named(jp)[name], err_msg=name, **TOL)
    for key in ("m", "v"):
        want = _named(js[key])
        for name, t in tree_util.items(ts[key]):
            assert t.dtype == (torch.bfloat16 if state_dtype else torch.float32)
            np.testing.assert_allclose(t.float().numpy(), np.asarray(want[name], np.float32),
                                       err_msg=f"{key}/{name}", **TOL)


def _named(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_adamw_state_carries_over_from_the_reference():
    """`bridge.opt_state_from_numpy` starts the port's AdamW from the
    reference's state (a reduced model's layout), leaf for leaf."""
    import dataclasses

    from repro.configs import get_reduced_config as jax_reduced
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_reduced_config
    cfg = dataclasses.replace(get_reduced_config("minitron_4b"), param_dtype="float32",
                              activ_dtype="float32")
    jparams = jax_build(dataclasses.replace(jax_reduced("minitron_4b"), param_dtype="float32",
                                            activ_dtype="float32")).init_params(
        jax.random.PRNGKey(0))
    js = {"m": jax.tree.map(lambda p: p * 0.5, jparams), "v": jax.tree.map(jnp.abs, jparams),
          "count": jnp.asarray(7, jnp.int32)}
    ts = bridge.opt_state_from_numpy(cfg, jax.tree.map(np.asarray, js), device="cpu")
    assert int(ts["count"]) == 7 and ts["count"].dtype == torch.int32
    for key in ("m", "v"):
        want = _named(js[key])
        got = dict(tree_util.items(ts[key]))
        assert list(got) == list(want)
        for name, t in got.items():
            np.testing.assert_array_equal(t.numpy(), want[name])


def test_adamw_optimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.ones(4) * 5.0}
    state = opt.init(params)
    for _ in range(100):
        opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_compression_matches_reference():
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal((40, 30)).astype(np.float32),
         "b": np.linspace(-1, 1, 1000).astype(np.float32)}
    # ties at .5 after scaling: 127 * k / 254 lands on half-integers
    g["t"] = (np.arange(-254, 255, dtype=np.float32) / 254.0)
    jres = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, g))
    tres = init_residual(_torch(g))
    for _ in range(3):
        jq, js, jres = jax_compress(jax.tree.map(jnp.asarray, g), jres)
        tq, ts, tres = compress_grads_int8(_torch(g), tres)
        for name, q in tree_util.items(tq):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), _named(jq)[name], err_msg=name)
            np.testing.assert_array_equal(dict(tree_util.items(ts))[name].numpy(),
                                          _named(js)[name])
            np.testing.assert_array_equal(dict(tree_util.items(tres))[name].numpy(),
                                          _named(jres)[name])
    back = decompress_grads_int8(tq, ts)
    want = jax_decompress(jq, js)
    for name, t in tree_util.items(back):
        np.testing.assert_array_equal(t.numpy(), _named(want)[name])


def test_grad_compression_error_feedback():
    g = {"w": torch.linspace(-1, 1, 1000)}
    res = init_residual(g)
    acc = torch.zeros_like(g["w"])
    for _ in range(20):
        q, scales, res = compress_grads_int8(g, res)
        acc = acc + decompress_grads_int8(q, scales)["w"]
    assert float((acc - 20 * g["w"]).abs().max()) / 20 < 1e-2
