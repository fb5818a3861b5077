"""The port's prefill executables (`repro_torch.serving.executable.PrefillExecutable`)
against the JAX engine's, on the CPU.

The reference's PREPARE (`aot_executables`) compiles one prefill per prompt
length and, on request, one per padded bucket; its swap installs them, a
swap that moves the state first dropping the old ones; its `_admit` picks
the exact length's executable, else the smallest bucket that holds the
prompt, else the JIT. The port's PREPARE builds a `PrefillExecutable` for
each (a CUDA graph on the card; on the CPU the same prefill run eagerly
over the same static buffers), and its `_admit` must pick where the
reference's tables pick and leave the pool as the reference's leaves it:
an exact-length prefill writes no padding into the request's pages. The
graphs themselves need the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.configs import get_reduced_config as jax_reduced
from repro.models import build_model as jax_build
from repro.sharding import default_plan as jax_default_plan
from repro.sharding import plan_to_shardings
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.executable import PrefillExecutable

N_SLOTS = 4
S_MAX = 16
NEW = 4
CPU = {"params": torch.device("cpu"), "cache": torch.device("cpu")}
# the serve: the lengths PREPARE is given, then two others, one below and
# one above the largest; after the second swap, a length no table holds
FIRST = {"lengths": (5, 9), "buckets": True, "prompts": (5, 9, 7, 13)}
SECOND = {"lengths": (5,), "buckets": False, "prompts": (7,)}
# prefill logits of the port against the reference's (tests/test_torch_engine.py)
LOGITS_TOL = 1e-5
# the bf16 pools: a K/V entry computed in fp32 by each framework rounds to
# bf16 alike but at a rounding boundary, where the two differ by one bf16
# step (at most 2**-7 of the value); the padding the repaired fault wrote
# was O(1) where the reference's pool holds 0
POOL_RTOL = 2.0 ** -7


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def tiny(arch):
    """(JAX model, its params, the port's CPU model with the same weights):
    the reduced fp32 config, the port's weights from seed 0 carried over to
    the reference (the two trees share one layout; the port draws them
    faster than the reference's init runs on the CPU)."""
    model = Model(_fp32(get_reduced_config(arch)), device="cpu", seed=0)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), model.params)
    return jax_build(_fp32(jax_reduced(arch))), jparams, model


def reference_pick(jeng, S):
    """Where the reference's `_admit` sends a prompt of ``S`` tokens, read
    from its installed tables."""
    if S in jeng._prefill_exec:
        return "exact"
    if any(b >= S for b in jeng._bucket_lengths):
        return "bucket"
    return "eager"


def swap_both(jeng, eng, step):
    """PREPARE then swap on both engines (the state placed anew), and hold
    the port's count and tables to the reference's."""
    jmodel = jeng.model
    sh = plan_to_shardings(jmodel.cfg, jax_default_plan(), jserving.ServingCluster().mesh,
                           n_slots=jeng.cache_batch)
    jexe, want = jeng.aot_executables(sh, prefill_lengths=step["lengths"],
                                      prefill_buckets=step["buckets"])
    exe, n = eng.prepare_executables(CPU, prefill_lengths=step["lengths"],
                                     prefill_buckets=step["buckets"])
    assert n == want
    assert all(isinstance(e, PrefillExecutable) and not e.padded and e.length == S
               for S, e in exe["prefill"].items())
    assert all(isinstance(e, PrefillExecutable) and e.padded and e.length == S
               for S, e in exe["prefill_buckets"].items())
    jeng.pause()
    jeng.swap_plan(shardings=sh, executables=jexe)
    jeng.resume()
    eng.pause()
    eng.swap_plan(placement=CPU, executables=exe)
    eng.resume()
    exact, buckets = eng.prefill_executables
    assert sorted(exact) == sorted(jeng._prefill_exec)
    assert sorted(buckets) == eng._bucket_lengths == jeng._bucket_lengths
    assert all(exact[S] is exe["prefill"][S] for S in exact)


def assert_pools_equal(jeng, eng):
    for k, v in eng.cache.items():
        np.testing.assert_allclose(v.float().numpy(), np.asarray(jeng.cache[k], np.float32),
                                   rtol=POOL_RTOL, atol=LOGITS_TOL, err_msg=k)


def serve_one_at_a_time(jeng, eng, lengths, rid0, rng):
    """Admit each prompt alone (then one decode step), holding the port's
    pick, prefill logits and pool to the reference's after each."""
    jparams = jeng.params
    vocab = jeng.model.cfg.vocab_size
    ref, port = [], []
    for rid, S in enumerate(lengths, start=rid0):
        prompt = rng.integers(2, vocab, size=S).astype(np.int32)
        want = reference_pick(jeng, S)
        before = dict(eng.prefill_stats)
        ref.append(jserving.Request(rid, prompt, max_new_tokens=NEW))
        port.append(Request(rid, prompt, max_new_tokens=NEW))
        jeng.submit(ref[-1])
        eng.submit(port[-1])
        jeng.step()
        eng.step()
        got = [w for w in ("exact", "bucket", "eager") if eng.prefill_stats[w] != before[w]]
        assert got == [want], (S, got, want)
        # the reference's executable for this pick, run again on its batch
        batch = {"tokens": jnp.asarray(prompt)[None]}
        run = {"exact": jeng._prefill_exec.get(S), "eager": jeng._prefill}.get(want)
        if want == "bucket":
            b = next(b for b in jeng._bucket_lengths if b >= S)
            batch = {"tokens": jnp.pad(batch["tokens"], ((0, 0), (0, b - S))),
                     "true_len": jnp.asarray(S, jnp.int32)}
            run = jeng._bucket_exec[b]
        gold, _ = run(jparams, batch)
        np.testing.assert_allclose(eng.prefill_logits[rid].numpy(), np.asarray(gold[0]),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
        assert_pools_equal(jeng, eng)
    jeng.run()
    eng.run()
    assert [r.tokens_out for r in port] == [list(r.tokens_out) for r in ref]
    assert_pools_equal(jeng, eng)


@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m"])
def test_admission_picks_and_writes_what_the_reference_does(arch):
    """After PREPARE at lengths 5 and 9 with buckets and a swap, prompts of
    5 and 9 run their exact-length executables and 7 and 13 a bucket's
    (Mamba2 has no buckets: eager), as the reference's tables pick; each
    prefill's logits, the pool after each admission and the streams equal
    the reference engine's, and so does PREPARE's count. On Minitron a
    second swap, of a PREPARE at length 5 without buckets, leaves no bucket
    behind, and a 7 then runs eagerly, as the reference's does."""
    jmodel, jparams, model = tiny(arch)
    jeng = jserving.ServingEngine(jmodel, jparams, n_slots=N_SLOTS, s_max=S_MAX)
    eng = ServingEngine(model, n_slots=N_SLOTS, s_max=S_MAX, device="cpu")
    eng.record_logits = True
    rng = np.random.default_rng(0)
    swap_both(jeng, eng, FIRST)
    serve_one_at_a_time(jeng, eng, FIRST["prompts"], 0, rng)
    s = eng.prefill_stats
    padded = eng.supports_padded_prefill()
    assert (s["exact"], s["bucket"], s["eager"]) == ((2, 2, 0) if padded else (2, 0, 2))
    assert s["replays"] == s["captures"] == 0        # no graph on the CPU
    if arch != "minitron_4b":
        return
    swap_both(jeng, eng, SECOND)
    assert eng._bucket_lengths == [] and eng.prefill_executables[1] == {}
    serve_one_at_a_time(jeng, eng, SECOND["prompts"], 10, rng)
    assert (s["exact"], s["bucket"], s["eager"]) == (2, 2, 1)


def test_bucket_executable_reads_true_len_from_its_buffer():
    """One bucket executable of 16 run with prompts of 3 and then 11 tokens
    from the same static buffers: each run's logits, greedy pick and the
    cache's first positions are the unpadded prefill's (the length is read
    on the device, not fixed when the executable was built)."""
    _, _, model = tiny("minitron_4b")
    vocab = model.cfg.vocab_size
    exe = PrefillExecutable(model, 16, padded=True, device=torch.device("cpu"))
    assert not exe.capture()
    rng = np.random.default_rng(1)
    for S in (3, 11):
        prompt = rng.integers(2, vocab, size=S).astype(np.int32)
        exe.load(prompt)
        assert int(exe.true_len) == S and int(exe.tokens[0, S:].abs().sum()) == 0
        exe.run()
        gold, cache = model.prefill({"tokens": torch.as_tensor(prompt, dtype=torch.long)[None]})
        np.testing.assert_allclose(exe.logits.numpy(), gold.numpy(),
                                   atol=LOGITS_TOL, rtol=LOGITS_TOL)
        assert int(exe.next_tok[0]) == int(np.argmax(gold[0, :vocab].numpy()))
        for k, v in cache.items():
            np.testing.assert_allclose(exe.cache1[k][:, :, :S].numpy(), v.numpy(),
                                       atol=LOGITS_TOL, rtol=LOGITS_TOL)
    with pytest.raises(ValueError, match="at most 16"):
        exe.load(np.zeros(17, np.int32))
    with pytest.raises(ValueError):
        PrefillExecutable(model, 8, device=torch.device("cpu")).load(np.zeros(5, np.int32))


def test_captured_launches_count_at_replay_not_at_capture():
    """A launch inside `captured_launches` goes to the graph's tally, not
    to `LAUNCHES`; `add_launches` adds a tally, as each replay does."""
    before = dict(ops.LAUNCHES)
    try:
        with ops.captured_launches() as tally:
            ops._count("flash_attention")
            ops._count("flash_attention")
            ops._count("moe_topk")
        assert ops.LAUNCHES == before
        assert tally == {"flash_attention": 2, "moe_topk": 1, "ssd_scan": 0}
        ops._count("ssd_scan")                  # outside the capture: counted
        ops.add_launches(tally)
        ops.add_launches(tally)
        assert ops.LAUNCHES == {"flash_attention": before["flash_attention"] + 4,
                                "moe_topk": before["moe_topk"] + 2,
                                "ssd_scan": before["ssd_scan"] + 1}
    finally:
        ops.LAUNCHES.update(before)
