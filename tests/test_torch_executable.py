"""The port's decode executable (`repro_torch.serving.executable`) against the
JAX engine's compiled decode, on the CPU.

On the CPU a `DecodeExecutable` runs the decode step eagerly over the same
static buffers (tokens, positions, page tables, the on-device greedy pick)
that the card's CUDA graph reads, so these tests exercise the buffer
plumbing: greedy streams of reduced fp32 models equal the JAX engine's with
uneven completions (paged lanes compact and refill, so the table buffer
must be refreshed), with buckets on and off; PREPARE returns the executable
the swap installs and `step` then runs; ``n_compiled`` is the reference's
count; an executable over a replaced pool is discarded at the swap and
rebuilt; ``torch.argmax`` breaks ties as ``np.argmax`` does. Capture and
replay themselves need the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from conftest import build_tiny_model

import repro.serving as jserving
from repro.sharding import default_plan as jax_default_plan
from repro.sharding import plan_to_shardings
from repro_torch import bridge
from repro_torch.configs import get_reduced_config
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.executable import DecodeExecutable

SIZES = (5, 11, 7, 17, 3, 9)
NEWS = (3, 8, 5, 2, 6, 4)          # uneven: lanes free at different steps
N_SLOTS = 3
S_MAX = 32
CPU = {"params": torch.device("cpu"), "cache": torch.device("cpu")}


@functools.lru_cache(maxsize=None)
def tiny(arch):
    """(JAX model, its params, the port's CPU model with the same weights,
    prompts)."""
    cfg, jmodel, jparams = build_tiny_model(arch)
    tcfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                               activ_dtype="float32")
    params = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(0)
    prompts = tuple(rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in SIZES)
    return jmodel, jparams, Model(tcfg, params, device="cpu"), prompts


@functools.lru_cache(maxsize=None)
def reference_streams(arch):
    """The JAX engine's streams over the uneven requests (exact-length
    prefill; a padded bucket gives the same tokens)."""
    jmodel, jparams, _, prompts = tiny(arch)
    eng = jserving.ServingEngine(jmodel, jparams, n_slots=N_SLOTS, s_max=S_MAX)
    reqs = [jserving.Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, NEWS))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: list(r.tokens_out) for r in reqs}


def port_engine(arch, **kw):
    return ServingEngine(tiny(arch)[2], n_slots=N_SLOTS, s_max=S_MAX, device="cpu", **kw)


def port_requests(arch):
    return [Request(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(tiny(arch)[3], NEWS))]


def checked_tables(eng):
    """Make the installed executable assert, at every step it runs, that its
    table buffer holds the engine's page tables (a paged pool only)."""
    exe = eng.decode_executable
    step = exe.forward

    def forward():
        if exe.tables is not None:
            assert torch.equal(exe.tables, torch.as_tensor(eng.page_tables))
        step()

    exe.forward = forward


def serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.step()
    checked_tables(eng)
    eng.run()
    return {r.rid: list(r.tokens_out) for r in reqs}


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m"])
def test_streams_equal_reference_through_the_executable(arch, buckets):
    """Six requests of uneven length over three lanes: paged lanes compact
    and refill (the table buffer follows every change), slots refill over a
    used state; the streams equal the JAX engine's. On the CPU every step
    runs the executable eagerly, none is captured."""
    eng = port_engine(arch, prefill_buckets=buckets)
    assert eng.decode_executable is None
    streams = serve(eng, port_requests(arch))
    assert streams == reference_streams(arch)
    assert isinstance(eng.decode_executable, DecodeExecutable)
    assert eng.decode_stats["eager"] == eng.steps > len(SIZES)
    assert eng.decode_stats["replays"] == eng.decode_stats["captures"] == 0
    assert eng.paged == (arch != "mamba2_370m")


@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_370m"], ids=["paged", "slot"])
def test_prepare_returns_the_executable_the_swap_installs_and_step_runs(arch):
    """PREPARE builds a decode executable over the live pool without
    installing it or writing the pool; the swap installs that very object,
    and every later step runs it."""
    eng = port_engine(arch)
    reqs = port_requests(arch)
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    before = eng.decode_executable
    live = {k: v.clone() for k, v in eng.cache.items()}
    execs, _ = eng.prepare_executables(CPU, prefill_lengths=(5, 9))
    decode = execs["decode"]
    assert isinstance(decode, DecodeExecutable) and decode is not before
    assert decode.bound_to(eng.cache)
    assert eng.decode_executable is before
    assert all(torch.equal(live[k], eng.cache[k]) for k in live)
    runs = []
    real = decode.run
    decode.run = lambda: (runs.append(eng.steps), real())[1]
    eng.pause()
    eng.swap_plan(placement=CPU, executables=execs)
    eng.resume()
    assert eng.decode_executable is decode and eng.decode_stats["installs"] == 1
    assert eng.decode_stats["discards"] == 0
    checked_tables(eng)
    steps = eng.steps
    eng.run()
    assert runs == list(range(steps, eng.steps))
    assert {r.rid: r.tokens_out for r in reqs} == reference_streams(arch)


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "bucketed"])
@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_370m"], ids=["paged", "slot"])
def test_n_compiled_equals_the_reference_count(arch, buckets):
    """1 (decode) + the prompt lengths + the buckets, as the reference's
    ``aot_executables`` counts (an SSM model has no buckets)."""
    jmodel, jparams, _, _ = tiny(arch)
    jeng = jserving.ServingEngine(jmodel, jparams, n_slots=N_SLOTS, s_max=S_MAX)
    sh = plan_to_shardings(jmodel.cfg, jax_default_plan(), jserving.ServingCluster().mesh,
                           n_slots=jeng.cache_batch)
    _, want = jeng.aot_executables(sh, prefill_lengths=(5, 9), prefill_buckets=buckets)
    execs, n = port_engine(arch).prepare_executables(CPU, prefill_lengths=(5, 9),
                                                     prefill_buckets=buckets)
    assert n == want == 3 + len(execs["prefill_buckets"])
    assert isinstance(execs["decode"], DecodeExecutable)


@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_370m"], ids=["paged", "slot"])
def test_executable_over_a_replaced_pool_is_discarded_and_rebuilt(arch):
    """A pool tensor replaced between PREPARE and the swap: the swap
    discards PREPARE's executable and the installed one (both hold the old
    tensor), and the next step rebuilds one over the live pool; the streams
    are unchanged."""
    eng = port_engine(arch)
    reqs = port_requests(arch)
    for r in reqs:
        eng.submit(r)
    eng.step()
    old = eng.decode_executable
    execs, _ = eng.prepare_executables(CPU, prefill_lengths=(5,))
    name = next(iter(eng.cache))
    eng.cache[name] = eng.cache[name].clone()
    eng.pause()
    eng.swap_plan(executables=execs)
    eng.resume()
    assert eng.decode_stats["discards"] == 1 and eng.decode_stats["installs"] == 0
    assert eng.decode_executable is None
    eng.step()
    rebuilt = eng.decode_executable
    assert rebuilt not in (None, old, execs["decode"]) and rebuilt.bound_to(eng.cache)
    eng.run()
    assert {r.rid: r.tokens_out for r in reqs} == reference_streams(arch)


def test_a_pool_replaced_outside_a_swap_fails_the_step():
    """The installed executable never runs over a pool the engine no
    longer holds: the step raises rather than write the old tensors."""
    eng = port_engine("minitron_4b")
    for r in port_requests("minitron_4b"):
        eng.submit(r)
    eng.step()
    eng.cache = {k: v.clone() for k, v in eng.cache.items()}
    with pytest.raises(RuntimeError, match="no longer holds"):
        eng.step()


def test_migration_refreshes_the_importers_table_buffer():
    """Two decoding requests move between paged engines: the importer's
    table buffer follows the pages it reserved (and the exporter's the
    pages it freed), and the streams equal the JAX engine's."""
    arch = "minitron_4b"
    src, dst = port_engine(arch), port_engine(arch)
    reqs = port_requests(arch)
    for r in reqs:
        src.submit(r)
    src.step()
    dst.submit(Request(99, tiny(arch)[3][0], max_new_tokens=2))
    dst.step()
    checked_tables(src)
    checked_tables(dst)
    src.step()
    for rid in [r.rid for r in src.slot_req if r is not None][:2]:
        dst.import_slot(src.export_slot(rid))
    while src.load or dst.load:
        src.step()
        dst.step()
    assert {r.rid: r.tokens_out for r in reqs} == reference_streams(arch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_argmax_breaks_ties_at_the_first_index_as_numpy(dtype):
    """The device pick (``torch.argmax``) and the reference's ``np.argmax``
    agree on tied rows: all equal, a tie at the top, ties after the top."""
    rows = np.array([[0.5] * 7,
                     [1.0, 3.0, 2.0, 3.0, 3.0, 0.0, 3.0],
                     [-1.0, -1.0, -2.0, -1.0, -3.0, -1.0, -1.0],
                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 9.0],
                     [2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 2.0]], dtype=np.float32)
    picks = torch.argmax(torch.as_tensor(rows).to(dtype), dim=-1)
    assert picks.tolist() == [int(np.argmax(r)) for r in rows] == [0, 1, 0, 6, 0]
