"""The KV cache in ``float8_e4m3fn`` (the dry run's ``optimized`` profile)
against the reference's, on the CPU, on one device.

Reduced fp32 Minitron-4B (GQA), MiniCPM3 (MLA) and Whisper (its self- and
cross-caches) with the reference's weights: a prefill, its cache cast into
a zeroed fp8 cache of ``S_MAX`` positions, then four greedy decode steps
(one position for the batch, then one per row). The decode casts each new
K/V (or latent) entry to fp8 on write and upcasts the cache for its fp32
math, as the reference does. Every step's logits are within ``REL`` of the
step's largest logit of the reference's `decode_step` on
`Model.init_cache(..., dtype=jnp.float8_e4m3fn)`, the picks are equal, and
every cache leaf is equal bit for bit after the last step. Both sides start
from the same fp8 bytes: cast from each framework's own fp32 prefill, one
value of reduced Whisper's cross-cache lands on either side of an fp8
rounding midpoint (`test_fp8_cast_of_each_prefill` pins where and why).

torch and ``ml_dtypes`` (the reference's fp8) round every value up to 464 in
magnitude alike (to nearest, ties to even: 464, the midpoint above 448, the
largest finite value, rounds to 448). Above 464 they part: torch saturates
to ±448 (infinities too), ``ml_dtypes`` gives NaN.
`test_fp8_rounding_matches_to_464_and_saturates_above` pins both; the
reduced models' K/V stay far below 448.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.models import Model
from repro_torch.models.lm import is_positional
from repro_torch.serving import kvpool

ARCHS = ("minitron_4b", "minicpm3_4b", "whisper_large_v3")
REL = 1e-5
B, S, NEW, S_MAX = 2, 7, 4, 16
FP8 = torch.float8_e4m3fn


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jmodel = jax_build(_fp32(jax_reduced(arch)))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = _fp32(get_reduced_config(arch))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg, params, device="cpu")


def _batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _flat(tree, prefix=""):
    """The reference's cache tree by the port's flat keys (``self/k``, ...)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's prefill, its fp8 cache and four greedy steps: each
    step's logits, the prefill's cache in fp32 and after the cast into the
    fp8 cache, and the cache after the last step (flat keys; fp8 as
    bytes)."""
    jmodel, jparams, _ = _pair(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(jmodel.cfg).items()}
    logits, pre = jmodel.prefill(jparams, batch)

    def fill(path, z, c):
        if path[-1].key in ("k", "v", "ckv", "kpe") and c.shape[2] < z.shape[2]:
            return z.at[:, :, :c.shape[2]].set(c.astype(z.dtype))
        return c.astype(z.dtype)

    cache = jax.tree_util.tree_map_with_path(
        fill, jmodel.init_cache(B, S_MAX, dtype=jnp.float8_e4m3fn), pre)
    filled = {k: _bits(v) for k, v in _flat(cache).items()}
    steps = [np.asarray(logits)]
    for i in range(NEW):
        tok = jnp.argmax(logits[:, :jmodel.cfg.vocab_size], axis=-1)[:, None].astype(jnp.int32)
        pos = jnp.asarray(S + i, jnp.int32) if i < 2 else jnp.full((B,), S + i, jnp.int32)
        logits, cache = jmodel.decode_step(jparams, tok, cache, pos)
        steps.append(np.asarray(logits))
    pre = {k: np.asarray(v) for k, v in _flat(pre).items()}
    return steps, pre, filled, {k: _bits(v) for k, v in _flat(cache).items()}


def _port_prefill(model):
    """The port's prefill: its logits and its cache (fp32)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    with torch.no_grad():
        return model.prefill(batch)


def _fill(model, pre):
    """A zeroed fp8 cache of ``S_MAX`` positions with ``pre`` (fp32, by
    flat key) cast into its first positions, as the serving path writes a
    prefill into its cache."""
    cache = model.init_cache(B, S_MAX, dtype=FP8)
    for k, v in pre.items():
        v = torch.tensor(v)
        if is_positional(k) and v.shape[2] < cache[k].shape[2]:
            cache[k][:, :, :v.shape[2]] = v
        else:
            cache[k].copy_(v)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_decode_matches_the_reference(arch):
    """Prefill, then four greedy steps over an fp8 cache that starts from
    the same bytes on both sides (the reference's prefill cast into it):
    the prefill's logits and each step's within REL of the step's largest
    logit, picks equal, every cache leaf in fp8 and equal bit for bit after
    the last step (each step's new entries cast on write on either side)."""
    want, _, want_filled, want_cache = _reference(arch)
    _, _, model = _pair(arch)
    logits, _ = _port_prefill(model)
    cache = model.init_cache(B, S_MAX, dtype=FP8)
    assert set(cache) == set(want_filled)
    for k, v in want_filled.items():
        cache[k].view(torch.uint8).copy_(torch.from_numpy(v.copy()))
    got = [logits.numpy().copy()]
    with torch.no_grad():
        for i in range(NEW):
            tok = logits[:, :model.cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
            pos = torch.tensor(S + i) if i < 2 else torch.full((B,), S + i)
            logits, cache = model.decode_step(tok, cache, pos)
            got.append(logits.numpy().copy())
    V = model.cfg.vocab_size
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max()), i
        assert np.array_equal(g[:, :V].argmax(-1), w[:, :V].argmax(-1)), i
    assert all(v.dtype == FP8 for v in cache.values())
    for k in want_cache:
        assert np.array_equal(_bits(cache[k]), want_cache[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_cast_of_each_prefill(arch):
    """The cast into the fp8 cache: the port's cast of the reference's fp32
    prefill cache equals the reference's fp8 cache bit for bit. Cast from
    each framework's own prefill, the two caches can part where the fp32
    values differ (the frameworks sum in different orders) and an fp8
    rounding midpoint lies between them: reduced Whisper's ``cross/k`` at 1
    of its 8,192 values (0.06054643 in the port, 0.06054693 in the
    reference, either side of 0.060546875). Every byte where they part is
    one of those, and the rounding of each side's own value is the same in
    torch and ``ml_dtypes``."""
    _, want_pre, want_filled, _ = _reference(arch)
    _, _, model = _pair(arch)
    ref_cast = _fill(model, want_pre)
    _, pre = _port_prefill(model)
    own_cast = _fill(model, {k: v.numpy() for k, v in pre.items()})
    parted = 0
    for k, want in want_filled.items():
        assert np.array_equal(_bits(ref_cast[k]), want), k
        differ = _bits(own_cast[k]) != want
        if not differ.any():
            continue
        n = want_pre[k].shape[2]
        mine = pre[k].numpy()[:, :, :n]
        theirs = want_pre[k]
        idx = differ[:, :, :n]
        assert not differ[:, :, n:].any(), k
        assert (mine[idx] != theirs[idx]).all(), k
        for side in (mine[idx], theirs[idx]):
            assert np.array_equal(_bits(torch.from_numpy(side).to(FP8)),
                                  side.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)), k
        parted += int(idx.sum())
    assert parted <= 1e-3 * sum(v.size for v in want_filled.values())


def test_fp8_paged_decode_equals_the_dense_decode():
    """The paged pool over an fp8 store (`write_pages`, `gather_pages`,
    `scatter_token`, `make_paged_decode`): three steps of Minitron give the
    dense fp8 cache's logits and entries bit for bit."""
    _, _, model = _pair("minitron_4b")
    pool = kvpool.PagedKVPool(4, 8)
    store = pool.init_store(model, dtype=FP8)
    pax, sax = kvpool.page_axes(model)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    with torch.no_grad():
        logits, pre = model.prefill(batch)
        dense = model.init_cache(B, 16, dtype=FP8)
        for k, v in pre.items():
            dense[k][:, :, :S] = v
        for b in range(B):
            kvpool.write_pages(store, {k: v[:, b:b + 1] for k, v in pre.items()},
                               tables[b].tolist(), pax, sax)
        step = kvpool.make_paged_decode(model, pax, sax)
        tok = logits[:, :model.cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
        for i in range(3):
            pos = torch.full((B,), S + i)
            paged_logits, store = step(tok, store, pos, tables)
            dense_logits, dense = model.decode_step(tok, dense, pos)
            assert torch.equal(paged_logits, dense_logits), i
            tok = dense_logits[:, :model.cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
    got = kvpool.gather_pages(store, tables, pax, sax)
    for k in dense:
        assert got[k].dtype == FP8
        assert torch.equal(_as_int(got[k][:, :, :S + 3]), _as_int(dense[k][:, :, :S + 3])), k


def _as_int(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8)


def test_fp8_rounding_matches_to_464_and_saturates_above():
    """Every fp8 value and the midpoints between neighbours (ties to even),
    a step either side of each, and a random spread convert alike in torch
    and ``ml_dtypes`` up to 464 in magnitude (464 itself to 448). Above 464
    (and at ±inf) torch gives ±448 and ``ml_dtypes`` NaN; NaN stays NaN in
    both."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    finite = np.unique(codes[np.isfinite(codes)])
    mids = (finite[1:] + finite[:-1]) / 2
    rng = np.random.default_rng(0)
    x = np.concatenate([finite, mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
                        rng.standard_normal(100_000).astype(np.float32) * 50,
                        rng.uniform(-464, 464, 100_000).astype(np.float32),
                        np.array([464.0, -464.0], np.float32)])
    x = x[np.abs(x) <= 464].astype(np.float32)
    got = _bits(torch.from_numpy(x).to(FP8))
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    assert np.array_equal(got, want)

    big = np.array([np.nextafter(np.float32(464), np.float32(np.inf)), 465.0, 1000.0, 3.0e38,
                    np.inf], dtype=np.float32)
    big = np.concatenate([big, -big])
    torch_side = torch.from_numpy(big).to(FP8).float().numpy()
    assert np.array_equal(torch_side, np.sign(big) * 448.0)
    assert np.isnan(big.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)).all()
    assert np.isnan(np.asarray(jnp.asarray(big).astype(jnp.float8_e4m3fn)).astype(np.float32)).all()
    assert torch.tensor([float("nan")]).to(FP8).float().isnan().all()
    assert np.isnan(np.array([np.nan], np.float32).astype(ml_dtypes.float8_e4m3fn)
                    .astype(np.float32)).all()
