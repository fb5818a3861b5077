"""The port's plain kernel versions against the Pallas kernels.

The JAX side runs as `tests/test_kernels.py` runs it on the CPU:
`repro.kernels.ops` in interpret mode. The same numpy inputs go through
both packages. The Hopper kernels themselves run only on the card
(`tests/test_torch_cuda.py`, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.attention import sdpa as jax_sdpa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import top_k


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("heads,S", [((4, 2), 200), ((6, 2), 128)],
                         ids=["gqa4-2_ragged200", "gqa6-2_s128"])
def test_flash_ref_matches_pallas_kernel_and_sdpa(causal, heads, S):
    Hq, Hkv = heads
    q, k, v = _qkv(2, S, Hq, Hkv, 32, seed=S + Hq)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, q_block=64, k_block=64)
    gold = jax_sdpa(jq, jk, jv, scale=32 ** -0.5, causal=causal)
    out = ref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)), causal=causal,
                                  q_chunk=64, k_chunk=64).numpy()
    np.testing.assert_allclose(out, np.asarray(kernel), atol=5e-6, rtol=5e-6)
    np.testing.assert_allclose(out, np.asarray(gold), atol=5e-6, rtol=5e-6)


def _logits_with_ties(T, E, seed):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    x[3] = 0.25                               # every expert ties
    x[5, :] = np.tile([1.0, 2.0, 2.0], E)[:E]  # ties among the largest
    return x


# (E, k) of the repo's MoE configs: qwen2_moe, moonshot, jamba, reduced ones
MOE_SHAPES = [(60, 4), (64, 6), (16, 2), (8, 2), (8, 3), (4, 2)]


def _tie_ids(E, k):
    """Row 5 of `_logits_with_ties`: its 2.0s, then its 1.0s, in index order."""
    return sorted(range(E), key=lambda e: (e % 3 == 0, e))[:k]


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_topk"])
@pytest.mark.parametrize("E,k", MOE_SHAPES, ids=[f"E{E}_k{k}" for E, k in MOE_SHAPES])
def test_moe_topk_ref_matches_pallas_kernel(E, k, norm):
    """Ids exactly equal (the lowest index wins a tie, as in `lax.top_k`),
    weights within 1e-6."""
    x = _logits_with_ties(200, E, seed=1)
    jw, ji = jops.moe_topk(jnp.asarray(x), k, norm_topk=norm)
    w, i = ref.moe_topk_ref(torch.as_tensor(x), k, norm_topk=norm)
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    assert i[3].tolist() == list(range(k))
    assert i[5].tolist() == _tie_ids(E, k)


def test_top_k_has_lax_order():
    x = _logits_with_ties(64, 60, seed=2)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    v, i = top_k(torch.as_tensor(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers return the plain versions' results and
    launch nothing."""
    ops.reset_launches()
    q, k, v = map(torch.as_tensor, _qkv(1, 77, 4, 2, 16, seed=3))
    np.testing.assert_array_equal(ops.flash_attention(q, k, v).numpy(),
                                  ref.flash_attention_ref(q, k, v).numpy())
    x = torch.as_tensor(_logits_with_ties(33, 60, seed=4))
    for a, b in zip(ops.moe_topk(x, 4, norm_topk=True),
                    ref.moe_topk_ref(x, 4, norm_topk=True)):
        assert torch.equal(a, b)
    ssd = [torch.randn(1, 20, 2, 16), torch.rand(1, 20, 2), -torch.rand(2),
           torch.randn(1, 20, 1, 16), torch.randn(1, 20, 1, 16)]
    for a, b in zip(ops.ssd_scan(*ssd, chunk=16), ref.ssd_scan_ref(*ssd, chunk=16)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == {"flash_attention": 0, "moe_topk": 0, "ssd_scan": 0}


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU goes to the kernel path, which raises for what
    it does not take: here a device that is not CUDA."""
    ops.reset_launches()
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.moe_topk(torch.empty((4, 60), device="meta"), 4)
    x = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, :1], x[:, :, :1], chunk=16)
    assert ops.LAUNCHES == {"flash_attention": 0, "moe_topk": 0, "ssd_scan": 0}
