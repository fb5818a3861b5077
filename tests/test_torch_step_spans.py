"""The spans and counters inside the port's serving step
(`repro_torch.obs.trace.StepSpan`, the engine's ``decode_stats``):

- ``kv_gathered_bytes`` is the dense copy the paged step gathers, and
  ``kv_live_bytes`` the positions attention needs, each computed here
  independently of the engine from the store's leaves;
- with no recorder nothing is counted and no ``record_function`` opened;
- with a recorder on a `FakeClock` the simulated clock reads as it does
  without one, replays stay identical, and the recorder's span ring holds
  no step span;
- under `torch.profiler` the step spans are ``user_annotation`` events
  nested as the layers nest, inside the caller's ``cluster.step``, and
  ``decode_s`` is the sum of the ``engine.decode`` spans there.
"""
import contextlib
import json
import math

import numpy as np
import pytest
import torch
from test_torch_cluster import prompts, tiny

from repro_torch.obs import Recorder, recording
from repro_torch.obs.trace import StepSpan
from repro_torch.serving import (
    FakeClock,
    Request,
    ServingCluster,
    ServingEngine,
    kvpool,
    simulated_time,
)

#: every span the serving step opens, and where each must sit
PARENT = {"engine.step": "cluster.step", "engine.admit": "engine.step",
          "engine.prefill": "engine.admit", "pool.write": "engine.admit",
          "pool.compact": "engine.step", "engine.decode": "engine.step",
          "engine.decode.launch": "engine.decode", "engine.bookkeeping": "engine.step"}
NEW_KEYS = ("decode_s", "decode_spans", "kv_gathered_bytes", "kv_live_bytes")
SIZES = (5, 9, 7, 12, 6, 4)


def _serve(arch="minitron_4b", *, paged=True, new=6, seed=1, step=None, **kw):
    """A cluster over one reduced CPU engine serving ``SIZES`` to the end,
    two lanes fewer than requests, budgets of ``new`` to ``new + 2`` (so
    lanes free out of order, refill and compact);
    ``step`` wraps each cluster step. Returns (engine, the positions
    attention needed at each step's decoded lanes, per step)."""
    cfg, _, _, model = tiny(arch)
    eng = ServingEngine(model, n_slots=4, s_max=32, page_size=8, paged=paged,
                        device="cpu", **kw)
    eng.record_logits = True
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", eng)
    reqs = {}
    for rid, p in enumerate(prompts(cfg.vocab_size, SIZES, seed=seed)):
        reqs[rid] = Request(rid, p, max_new_tokens=new + rid % 3)
        cluster.submit(reqs[rid])
    needed = []
    while eng.load:
        with (step() if step is not None else contextlib.nullcontext()):
            cluster.step()
        # a lane that decoded the k-th token of a prompt of S attended
        # positions 0 .. S + k - 1
        needed.append([len(reqs[rid].prompt) + len(reqs[rid].tokens_out) - 1
                       for _, rid in eng.last_lanes])
    return eng, needed


def _position_bytes(store):
    """A position's KV bytes: each leaf is (L, pages, page_size, ...)."""
    return sum(leaf.element_size() * leaf.shape[0] * math.prod(leaf.shape[3:])
               for leaf in store.values())


@pytest.mark.parametrize("arch", ["minitron_4b", "minicpm3_4b"])
def test_gathered_bytes_are_the_dense_copy_of_every_step(arch):
    """GQA K/V and MLA's latent leaves: each decode step adds the bytes of
    an ``(n_slots, pages_per_seq * page_size)`` dense cache of every leaf."""
    with recording(Recorder()):
        eng, needed = _serve(arch)
    dense = sum(leaf.element_size() * leaf.shape[0] * eng.n_slots * eng.pages_per_seq
                * eng.page_size * math.prod(leaf.shape[3:]) for leaf in eng.cache.values())
    tables = torch.ones((eng.n_slots, eng.pages_per_seq), dtype=torch.long)
    gathered = kvpool.gather_pages(eng.cache, tables, eng._pax, eng._sax)
    assert sum(v.nbytes for v in gathered.values()) == dense
    s = eng.decode_stats
    assert s["decode_spans"] == eng.steps == len(needed) > 0
    assert s["kv_gathered_bytes"] == eng.steps * dense


@pytest.mark.parametrize("arch", ["minitron_4b", "minicpm3_4b"])
def test_live_bytes_are_the_positions_attention_needs(arch):
    with recording(Recorder()):
        eng, needed = _serve(arch)
    assert eng.decode_stats["kv_live_bytes"] \
        == sum(map(sum, needed)) * _position_bytes(eng.cache) > 0
    assert 0 < eng.decode_stats["kv_live_bytes"] < eng.decode_stats["kv_gathered_bytes"]


@pytest.mark.parametrize("arch,paged", [("mamba2_370m", None), ("minitron_4b", False)],
                         ids=["ssm", "attention"])
def test_a_slot_pool_gathers_nothing(arch, paged):
    with recording(Recorder()):
        eng, _ = _serve(arch, paged=paged)
    s = eng.decode_stats
    assert not eng.paged
    assert s["kv_gathered_bytes"] == s["kv_live_bytes"] == 0
    assert s["decode_spans"] == eng.steps > 0 and s["decode_s"] > 0


@pytest.fixture
def opened(monkeypatch):
    """The names of every ``torch.profiler.record_function`` opened."""
    names = []
    real = torch.profiler.record_function

    def counting(name, args=None):
        names.append(name)
        return real(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profiled"])
def test_no_recorder_counts_nothing_and_opens_nothing(opened, profiled):
    """With no recorder the step opens no span, profiler or not, and the
    new keys stay 0; a recorder without a profiler opens none either."""
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
            if profiled else contextlib.nullcontext())
    with prof:
        eng, _ = _serve()
    assert opened == []
    assert all(eng.decode_stats[k] == 0 for k in NEW_KEYS)
    with recording(Recorder()):
        eng, _ = _serve()
    assert opened == [] and eng.decode_stats["decode_spans"] == eng.steps


def _simulated(record):
    """One served run on a `FakeClock`: (the clock's reading at the end,
    the token streams, the event stream, decode_stats, the span ring, the
    engine's steps)."""
    with simulated_time(FakeClock(tick=1e-6)) as clock:
        with (recording(Recorder(decode_stride=4)) if record
              else contextlib.nullcontext()) as rec:
            eng, _ = _serve()
    streams = [(r.rid, list(r.tokens_out), r.t_submit, r.t_first, r.t_done)
               for r in eng.done]
    events = ([(e.seq, e.ts, e.kind, e.rid, json.dumps(e.data, sort_keys=True))
               for e in rec.events()] if record else None)
    spans = [s.name for s in rec.trace.spans()] if record else None
    return clock.now, streams, events, dict(eng.decode_stats), spans, eng.steps


def test_recording_on_a_fake_clock_advances_nothing_and_replays_identically():
    bare = _simulated(False)
    a, b = _simulated(True), _simulated(True)
    assert a == b
    assert a[:2] == bare[:2]                   # the same reads of the clock
    assert a[3]["decode_spans"] == a[5] > 0 and a[1]
    assert a[3]["decode_s"] == 0.0             # non-advancing reads only
    assert a[4] and not set(a[4]) & set(PARENT)    # no step span in the ring
    # the strided progress event stays on the bus beside the step spans
    progress = [json.loads(e[4])["step"] for e in a[2] if e[2] == "engine.decode"]
    assert progress == list(range(4, a[5] + 1, 4)) and progress


def test_profiler_trace_nests_the_step_spans_inside_cluster_step(tmp_path):
    def step():
        return torch.profiler.record_function("cluster.step")
    path = tmp_path / "trace.json"
    with recording(Recorder()):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            eng, _ = _serve(step=step)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert set(PARENT) <= set(by_name)
    assert len(by_name["engine.decode"]) == eng.steps
    assert len(by_name["engine.admit"]) == len(SIZES)

    def inside(e, parent):
        return any(p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in by_name[parent])
    for name, parent in PARENT.items():
        assert all(inside(e, parent) for e in by_name[name]), name
    traced = sum(e["dur"] for e in by_name["engine.decode"]) * 1e-6
    assert eng.decode_stats["decode_s"] == pytest.approx(traced, rel=0.05)


def test_step_span_times_into_its_keys_and_names_only_under_the_profiler(opened):
    stats = {"x_s": 0.0, "x_spans": 0}
    with StepSpan("x", stats, "x"):
        np.ones(1000).sum()
    with StepSpan("y"):
        pass
    assert stats["x_spans"] == 1 and stats["x_s"] > 0 and opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with StepSpan("x", stats, "x"), StepSpan("y"):
            pass
    assert opened == ["x", "y"] and stats["x_spans"] == 2
