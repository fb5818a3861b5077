"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
decision is made inside the test, never at import). On a machine with an
H100 run ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances are those of ``tests/test_kernels.py``: 1e-5 in fp32 (atol and
rtol; the sums run in another order) and 2e-2 in bf16 (the output rounds to
bf16; both compute in fp32 in between, the softmax weights included). The
SSD scan: 1e-4 in fp32, as there; in bf16 y at 2e-2 (it rounds to bf16) and
the fp32 state at 1e-3 (both sides widen to fp32; only the order of the sums
differs).
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's Hopper kernels)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", [(1, 200, 16, 16, 128), (2, 77, 6, 2, 64),
                                   (2, 17, 6, 2, 16), (2, 257, 6, 2, 32),
                                   (2, 200, 6, 2, 64), (1, 257, 4, 4, 128), (1, 1, 4, 2, 64),
                                   (1, 17, 32, 8, 128), (1, 1000, 32, 8, 128),
                                   (1, 100, 12, 2, 128), (1, 384, 12, 2, 128)],
                         ids=["qwen_ragged", "gqa_d64", "gqa_s17_d16", "gqa_s257_d32",
                              "gqa_s200_d64", "s257_d128", "s1", "jamba_s17", "jamba_s1000",
                              "qwen2vl_s100", "qwen2vl_s384"])
def test_flash_kernel_matches_plain(gen, shape, causal, dtype, tol):
    B, S, Hq, Hkv, D = shape
    q = torch.randn(B, S, Hq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda").to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("S", [384, 1000])
def test_flash_kernel_head_dim_192_matches_plain(gen, S, causal, dtype, tol):
    """Nemotron-4-340B's prefill heads: 96 over 8 of 192, at a full tile and
    a ragged length."""
    q = torch.randn(1, S, 96, 192, generator=gen, device="cuda").to(dtype)
    k = torch.randn(1, S, 8, 192, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, S, 8, 192, generator=gen, device="cuda").to(dtype)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=tol, rtol=tol)


MOE_SHAPES = [(60, 4), (64, 6), (16, 2), (8, 2), (8, 3), (4, 2)]


def _moe_tokens():
    """T = 1, 2, one short of and one past a block's rows, 17, 384, one past
    48 and 128 full blocks (a last block with one live row), one and two
    dispatch groups (1024, 2048)."""
    from repro_torch.kernels.moe_dispatch import BLOCK_ROWS as r
    return sorted({1, 2, r - 1, r + 1, 17, 384, 385, 1024, 1025, 2048})


def _moe_logits(gen, T, E, dtype):
    x = torch.randn(T, E, generator=gen, device="cuda")
    if T > 5:
        x[3] = 0.5                                    # every expert ties
        x[5] = torch.tensor(([1.0, 2.0, 2.0] * E)[:E], device="cuda")
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_topk"])
@pytest.mark.parametrize("E,k", MOE_SHAPES, ids=[f"E{E}_k{k}" for E, k in MOE_SHAPES])
def test_moe_topk_kernel_matches_plain(gen, E, k, norm, dtype):
    for T in _moe_tokens():
        x = _moe_logits(gen, T, E, dtype)
        before = ops.LAUNCHES["moe_topk"]
        w, i = ops.moe_topk(x, k, norm_topk=norm)
        wr, ir = ref.moe_topk_ref(x, k, norm_topk=norm)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["moe_topk"] == before + 1
        assert w.shape == (T, k) and w.dtype == torch.float32 and i.dtype == torch.int32
        assert torch.equal(i, ir), f"T={T}"
        torch.testing.assert_close(w, wr, atol=1e-6, rtol=0)
        if T > 5:
            assert i[3].tolist() == list(range(k))
            assert i[5].tolist() == sorted(range(E), key=lambda e: (e % 3 == 0, e))[:k]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_moe_topk_kernel_takes_unaligned_rows(gen, dtype):
    """A base off the vector loads' alignment, or an E that is no multiple
    of their width, takes the kernel's scalar loads: the same answer."""
    flat = torch.randn(384 * 60 + 1, generator=gen, device="cuda").to(dtype)
    for x in (flat[1:].view(384, 60), flat[: 384 * 59].view(384, 59)):
        assert x.is_contiguous()
        w, i = ops.moe_topk(x, 4, norm_topk=True)
        wr, ir = ref.moe_topk_ref(x, 4, norm_topk=True)
        torch.cuda.synchronize()
        assert torch.equal(i, ir)
        torch.testing.assert_close(w, wr, atol=1e-6, rtol=0)


def _ssd_case(gen, B, S, H, G, P, N, dtype):
    x = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device="cuda"))
    Bm, Cm = (torch.randn(B, S, G, N, generator=gen, device="cuda").to(dtype) for _ in "BC")
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype,tol_y,tol_h", [(torch.float32, 1e-4, 1e-4),
                                               (torch.bfloat16, 2e-2, 1e-3)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 257, 32, 1, 64, 128, 256), (2, 77, 8, 2, 16, 32, 32),
                                   (1, 40, 8, 1, 16, 16, 32), (1, 17, 32, 1, 64, 128, 256),
                                   (1, 255, 32, 1, 64, 128, 256), (2, 77, 8, 1, 16, 128, 32),
                                   (1, 257, 8, 2, 16, 64, 256), (1, 200, 4, 1, 32, 32, 80),
                                   (1, 300, 4, 1, 32, 48, 128), (1, 1100, 4, 1, 32, 128, 1024),
                                   (1, 1, 4, 1, 16, 16, 16), (1, 17, 128, 1, 64, 16, 256),
                                   (1, 256, 128, 1, 64, 16, 256), (1, 257, 128, 1, 64, 16, 256),
                                   (1, 1000, 128, 1, 64, 16, 256)],
                         ids=["mamba2_ragged257", "grouped", "mamba2_reduced", "mamba2_s17",
                              "mamba2_s255", "p16_s77_chunk32", "grouped_p16_s257",
                              "chunk80_partial_tile", "n48_padded", "chunk1024", "s1",
                              "jamba_s17", "jamba_s256", "jamba_s257", "jamba_s1000"])
def test_ssd_scan_kernel_matches_plain(gen, shape, dtype, tol_y, tol_h):
    B, S, H, G, P, N, chunk = shape
    inp = _ssd_case(gen, B, S, H, G, P, N, dtype)
    before = ops.LAUNCHES["ssd_scan"]
    y, h = ops.ssd_scan(*inp, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = ref.ssd_scan_ref(*inp, chunk=chunk)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol_y, rtol=tol_y)
    torch.testing.assert_close(h, h_ref, atol=tol_h, rtol=tol_h)


def test_kernels_raise_on_what_they_do_not_take(gen):
    q = torch.randn(1, 16, 2, 128, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    flat = torch.randn(q.numel() + 1, generator=gen, device="cuda").bfloat16()
    odd = flat[1:].view(q.shape)              # contiguous, but 2 bytes off 16
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError):
        ops.moe_topk(torch.randn(4, 65, generator=gen, device="cuda"), 4)
    x, dt, A, Bm, Cm = _ssd_case(gen, 1, 8, 4, 1, 16, 16, torch.float32)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt, A, Bm.bfloat16(), Cm.bfloat16(), chunk=16)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=24)
    with pytest.raises(ValueError):
        ops.ssd_scan(x[..., :8].contiguous(), dt, A, Bm, Cm, chunk=16)


# ---------------------------------------------------------------------------
# the engine lifecycle on the card: export/import, swap_plan, PREPARE
# ---------------------------------------------------------------------------


def _card_model(arch):
    """A reduced fp32 model on the card, random weights from seed 0."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                              activ_dtype="float32")
    return Model(cfg, device="cuda", seed=0)


def _card_prompts(cfg, sizes=(5, 9, 17, 12)):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in sizes]


@pytest.mark.parametrize("arch,paged", [("minitron_4b", True), ("minitron_4b", False),
                                        ("mamba2_370m", False), ("minicpm3_4b", True),
                                        ("jamba_v0_1_52b", False)],
                         ids=["paged", "attn_slot", "ssm_slot", "mla_paged", "hybrid_slot"])
def test_export_import_on_the_card(gen, arch, paged):
    """Two requests move mid-decode between two engines on the card: the
    streams equal one engine's, every export and import leaves no queued
    device work behind (they synchronise), and the pool is pristine after."""
    from repro_torch.serving import Request, ServingEngine
    model = _card_model(arch)
    ps = _card_prompts(model.cfg)

    def engine():
        return ServingEngine(model, n_slots=4, s_max=64, paged=paged)

    ref = engine()
    want = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
    for r in want:
        ref.submit(r)
    ref.run()
    src, dst = engine(), engine()
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
    for r in reqs:
        src.submit(r)
    src.step()
    src.step()
    for rid in (1, 2):
        snap = src.export_slot(rid)
        assert torch.cuda.current_stream().query()
        assert snap.kv is not None and all(t.is_cuda for t in snap.kv.values())
        assert dst.import_slot(snap) == snap.nbytes > 0
        assert torch.cuda.current_stream().query()
    while src.load or dst.load:
        src.step()
        dst.step()
    assert [r.tokens_out for r in reqs] == [r.tokens_out for r in want]
    for eng in (src, dst):
        assert eng.kv_allocated_tokens == 0 and eng.free_tokens == eng.kv_token_capacity


def test_swap_plan_and_prepare_on_the_card(gen):
    """PREPARE warms on scratch state on the card (flash launches once per
    layer per warmed prefill, no live row changes); swap_plan counts params
    + cache, moves nothing on its own card and refuses to move shared
    params."""
    from repro_torch.serving import EngineStateError, Request, ServingEngine
    from repro_torch.sharding import ShardingPlan, plan_to_placement, single_device_mesh
    model = _card_model("minitron_4b")
    eng = ServingEngine(model, n_slots=2, s_max=64)
    eng.submit(Request(0, _card_prompts(model.cfg)[0], max_new_tokens=8))
    eng.step()
    live = {k: v.clone() for k, v in eng.cache.items()}
    plan = ShardingPlan(device_constraints=(("pod", 1),), forbidden_collective_axes=("pod",))
    place = plan_to_placement(plan, single_device_mesh(eng.device))
    assert place == {"params": eng.device, "cache": eng.device}
    before = ops.LAUNCHES["flash_attention"]
    execs, n = eng.prepare_executables(place, prefill_lengths=(5, 33))
    assert n == 3 and sorted(execs["prefill"]) == [5, 33]
    assert ops.LAUNCHES["flash_attention"] - before == 2 * model.cfg.num_layers
    assert all(torch.equal(live[k], eng.cache[k]) for k in live)
    with pytest.raises(EngineStateError):
        eng.swap_plan(plan, placement=place)
    eng.pause()
    ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
    nbytes = eng.swap_plan(plan, placement=place, executables=execs)
    assert nbytes == sum(t.numel() * t.element_size() for t in _leaves(model.params)) \
        + sum(t.numel() * t.element_size() for t in eng.cache.values())
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
    with pytest.raises(ValueError, match="params"):
        eng.swap_plan(plan, placement={"params": torch.device("cpu"), "cache": eng.device})
    eng.resume()
    assert eng.plan is plan and eng.decode_collectives() == []
    eng.run()
    assert len(eng.done) == 1 and len(eng.done[0].tokens_out) == 8


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# the decode step as a CUDA graph (`serving/executable.py`)
# ---------------------------------------------------------------------------


def _card_requests(prompts, new=8):
    """Uneven requests: lanes free at different steps."""
    from repro_torch.serving import Request
    return [Request(i, p, max_new_tokens=new + i % 3) for i, p in enumerate(prompts)]


def _serve_card(eng, prompts):
    reqs = _card_requests(prompts)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: r.tokens_out for r in reqs}


def _eager_streams(model, prompts, **kw):
    """The streams of an engine whose every decode step runs eagerly: the
    oracle the graph is held to (a switch of this test, not of the
    package)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.executable import DecodeExecutable
    with pytest.MonkeyPatch.context() as m:
        m.setattr(DecodeExecutable, "capture", lambda self, warm_up: False)
        m.setattr(DecodeExecutable, "run", DecodeExecutable.forward)
        eng = ServingEngine(model, **kw)
        streams = _serve_card(eng, prompts)
    assert eng.decode_stats["eager"] == eng.steps and eng.decode_stats["captures"] == 0
    return streams


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_370m", "minicpm3_4b", "qwen2_vl_2b",
                                  "jamba_v0_1_52b"],
                         ids=["qwen_paged", "mamba2_slot", "mla_paged", "mrope_paged",
                              "hybrid_slot"])
def test_graph_streams_equal_eager_streams(gen, arch):
    """Six uneven requests over three lanes: the first decode step runs
    eagerly and captures, every later one replays the graph; the streams
    equal the eager steps'."""
    from repro_torch.serving import ServingEngine
    model = _card_model(arch)
    prompts = _card_prompts(model.cfg, sizes=(5, 9, 17, 12, 3, 7))
    kw = {"n_slots": 3, "s_max": 64}
    want = _eager_streams(model, prompts, **kw)
    eng = ServingEngine(model, **kw)
    assert _serve_card(eng, prompts) == want
    stats = eng.decode_stats
    assert eng.paged == (arch not in ("mamba2_370m", "jamba_v0_1_52b"))
    assert stats["eager"] == 1 and stats["captures"] == 1 and stats["capture_s"] > 0
    assert stats["replays"] == eng.steps - 1
    assert eng.decode_executable.pool_bytes() > 0


def test_prepare_captures_on_a_worker_beside_serving(gen):
    """PREPARE captures on a worker thread while the main thread steps the
    same engine; the swap installs that graph and the streams are the eager
    steps'."""
    import threading

    from repro_torch.serving import ServingEngine
    model = _card_model("qwen2_moe_a2_7b")
    prompts = _card_prompts(model.cfg, sizes=(5, 9, 17, 12, 3, 7))
    kw = {"n_slots": 3, "s_max": 64}
    want = _eager_streams(model, prompts, **kw)
    eng = ServingEngine(model, **kw)
    reqs = _card_requests(prompts)
    for r in reqs:
        eng.submit(r)
    eng.step()
    out = {}
    worker = threading.Thread(target=lambda: out.update(execs=eng.prepare_executables(
        {"params": eng.device, "cache": eng.device}, prefill_lengths=(5, 9))[0]))
    worker.start()
    for _ in range(6):                  # leave requests decoding for after the swap
        if worker.is_alive():
            eng.step()
    worker.join(timeout=120)
    assert not worker.is_alive() and out["execs"]["decode"].graph is not None
    old = eng.decode_executable
    eng.pause()
    eng.swap_plan(placement={"params": eng.device, "cache": eng.device},
                  executables=out["execs"])
    eng.resume()
    assert eng.decode_executable is out["execs"]["decode"]
    assert old.graph is not None        # freed at the next step, outside the window
    eng.step()
    assert old.graph is None            # the replaced graph and its pool are freed
    eng.run()
    assert {r.rid: r.tokens_out for r in reqs} == want
    assert eng.decode_stats["captures"] == 2 and eng.decode_stats["installs"] == 1
    assert eng.decode_stats["replays"] == eng.steps - 1


@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_370m"], ids=["paged", "slot"])
def test_prepare_capture_leaves_the_live_pool_unchanged(gen, arch):
    """The capture records against the live pool without running: every
    live leaf, and the lanes, are as they were."""
    from repro_torch.serving import Request, ServingEngine
    model = _card_model(arch)
    eng = ServingEngine(model, n_slots=2, s_max=64)
    for i, p in enumerate(_card_prompts(model.cfg)[:2]):
        eng.submit(Request(i, p, max_new_tokens=8))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    live = {k: v.clone() for k, v in eng.cache.items()}
    pos = eng.slot_pos.copy()
    execs, _ = eng.prepare_executables({"params": eng.device, "cache": eng.device}, (5,))
    torch.cuda.synchronize()
    assert execs["decode"].graph is not None and execs["decode"].bound_to(eng.cache)
    assert all(torch.equal(live[k], eng.cache[k]) for k in live)
    assert (eng.slot_pos == pos).all()


def test_swap_migration_and_handoff_on_graphs_equal_eager(gen):
    """A cluster on the card: a swap that installs PREPARE's graph while two
    requests decode, a two-request migration, and a prefill/decode pair
    handing every request off at its first token; each run's streams equal
    the eager steps' on one engine, and no graph is discarded."""
    from repro_torch.serving import ServingCluster, ServingEngine
    from repro_torch.sharding import ShardingPlan
    model = _card_model("minitron_4b")
    prompts = _card_prompts(model.cfg, sizes=(5, 9, 17, 12, 3, 7))
    kw = {"n_slots": 4, "s_max": 64}
    want = _eager_streams(model, prompts, **kw)
    reqs = _card_requests(prompts)

    cluster = ServingCluster()
    cluster.register("a", ServingEngine(model, **kw))
    cluster.register("b", ServingEngine(model, **kw))
    for r in reqs:
        cluster.engine("a").submit(r)
    cluster.step()
    cluster.step()
    report = cluster.reconfigure("a", ShardingPlan(device_constraints=(("pod", 0),)),
                                 prefill_lengths=(5,))
    a = cluster.engine("a")
    assert a.decode_stats["installs"] == 1 and a.decode_stats["discards"] == 0
    assert report.compiled_in_prepare == 2
    moving = [r.rid for r in a.slot_req if r is not None][:2]
    cluster.migrate_requests("a", "b", moving)
    cluster.run()
    assert {r.rid: r.tokens_out for r in reqs} == want
    for eng in (a, cluster.engine("b")):
        assert eng.decode_stats["replays"] == eng.steps - eng.decode_stats["eager"] > 0

    handoff = ServingCluster()
    handoff.register("pf", ServingEngine(model, **kw), role="prefill")
    handoff.register("dc", ServingEngine(model, **kw), role="decode")
    hreqs = _card_requests(prompts)
    for r in hreqs:
        handoff.submit(r)
    handoff.run()
    assert {r.rid: r.tokens_out for r in hreqs} == want
    dc = handoff.engine("dc")
    assert dc.decode_stats["eager"] == 1 and dc.decode_stats["replays"] == dc.steps - 1


def test_a_failed_capture_raises(gen):
    """A capture that fails raises, from the executable and from the step
    that captures; nothing falls back to the eager step, and the step's
    token is kept."""
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.executable import DecodeExecutable

    def failing(self, *args):
        raise RuntimeError("capture failed")

    model = _card_model("minitron_4b")
    eng = ServingEngine(model, n_slots=2, s_max=64)
    exe = DecodeExecutable(eng)
    exe.forward = lambda: failing(exe)
    with pytest.raises(RuntimeError, match="capture failed"):
        exe.capture(eng._scratch_decode_inputs())
    assert exe.graph is None
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        exe.run()
    req = Request(0, _card_prompts(model.cfg)[0], max_new_tokens=8)
    eng.submit(req)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(DecodeExecutable, "capture", failing)
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.step()
    assert eng.decode_executable is None and len(req.tokens_out) == 2


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_370m", "qwen2_vl_2b"],
                         ids=["moe_paged", "ssd_slot", "mrope_paged"])
def test_prefill_graphs_equal_eager_prefill(gen, arch):
    """PREPARE captures a prefill graph at each length and, where the model
    pads, each bucket, all in one pool; every replay equals an eager
    prefill of the same batch bit for bit (logits, cache, greedy pick) and
    adds to the launch counts what that eager prefill adds."""
    import numpy as np

    from repro_torch.serving import ServingEngine
    model = _card_model(arch)
    eng = ServingEngine(model, n_slots=3, s_max=64)
    execs, n = eng.prepare_executables({"params": eng.device, "cache": eng.device},
                                       prefill_lengths=(5, 9), prefill_buckets=True)
    exes = list(execs["prefill"].values()) + list(execs["prefill_buckets"].values())
    assert n == 1 + len(exes) and len(exes) == (2 if arch == "mamba2_370m" else 2 + 4)
    assert all(e.graph is not None for e in exes)
    assert len({tuple(e.graph.pool()) for e in exes}) == 1 and exes[0].pool_bytes() > 0
    assert eng.prefill_stats["captures"] == len(exes)
    rng = np.random.default_rng(0)
    for e in exes:
        for S in ((3, e.length) if e.padded else (e.length,)):
            e.load(rng.integers(2, model.cfg.vocab_size, size=S).astype(np.int32))
            before = dict(ops.LAUNCHES)
            e.run()
            torch.cuda.synchronize()
            replayed = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
            before = dict(ops.LAUNCHES)
            logits, cache = model.prefill(e.batch())
            torch.cuda.synchronize()
            assert replayed == {k: v - before[k] for k, v in ops.LAUNCHES.items()}
            assert torch.equal(e.logits, logits)
            assert all(torch.equal(e.cache1[k], v) for k, v in cache.items())
            assert int(e.next_tok[0]) == int(torch.argmax(logits[0, :model.cfg.vocab_size]))


def test_admissions_replay_prefill_graphs(gen):
    """After the swap installs PREPARE's prefill graphs, each admission
    replays the exact length's or a bucket's graph, as the reference's
    tables pick; the streams equal an engine's whose every step is eager."""
    from repro_torch.serving import ServingEngine
    model = _card_model("qwen2_moe_a2_7b")
    prompts = _card_prompts(model.cfg, sizes=(5, 9, 17, 12, 3, 7))
    kw = {"n_slots": 3, "s_max": 64}
    want = _eager_streams(model, prompts, **kw)
    eng = ServingEngine(model, **kw)
    place = {"params": eng.device, "cache": eng.device}
    execs, _ = eng.prepare_executables(place, prefill_lengths=(5, 9), prefill_buckets=True)
    eng.pause()
    eng.swap_plan(placement=place, executables=execs)
    eng.resume()
    assert _serve_card(eng, prompts) == want
    s = eng.prefill_stats
    assert (s["exact"], s["bucket"], s["eager"], s["replays"]) == (2, 4, 0, 6)


def test_a_failed_prefill_capture_raises(gen):
    """A prefill capture that fails raises; an executable without a graph
    refuses to run on the card rather than run the eager prefill."""
    from repro_torch.serving.executable import PrefillExecutable
    model = _card_model("minitron_4b")
    exe = PrefillExecutable(model, 8, padded=True, device=torch.device("cuda"))

    def failing():
        raise RuntimeError("capture failed")

    exe.forward = failing
    with pytest.raises(RuntimeError, match="capture failed"):
        exe.capture()
    assert exe.graph is None
    with pytest.raises(RuntimeError, match="no CUDA graph"):
        exe.run()


def test_argmax_on_the_card_breaks_ties_at_the_first_index(gen):
    """The decode pick on the card takes the first maximum, as np.argmax."""
    import numpy as np
    rows = torch.randn(64, 151936, generator=gen, device="cuda")
    rows[::2, 1000] = rows[::2, 70000] = rows[::2, 150000] = 100.0   # ties at the top
    rows[1::4] = 0.25                                              # all equal
    for dtype in (torch.float32, torch.bfloat16):
        picks = torch.argmax(rows.to(dtype), dim=-1).cpu().numpy()
        want = np.argmax(rows.to(dtype).float().cpu().numpy(), axis=-1)
        assert (picks == want).all()
        assert (picks[::2] == 1000).all() and (picks[1::4] == 0).all()


# ---------------------------------------------------------------------------
# the elastic control loop on the card (`planner/`, `serving/autoscaler.py`)
# ---------------------------------------------------------------------------


def test_host_calibration_on_the_card(gen):
    from repro_torch.planner import calibrate_host_profile
    prof = calibrate_host_profile()
    assert prof.name == "host:cuda:0" and prof.peak_flops > 0 and prof.hbm_bw > 0
    assert prof.link_bw == prof.hbm_bw
    assert prof.mem_bytes == torch.cuda.get_device_properties(0).total_memory
    assert calibrate_host_profile(device="cuda:0") is prof
    cpu = calibrate_host_profile(device="cpu", repeats=1)
    assert cpu is not prof and cpu.mem_bytes == 8 << 30


@pytest.mark.parametrize("arch,kw", [("minitron_4b", {"n_slots": 4, "s_max": 64}),
                                     ("minitron_4b", {"n_slots": 8, "s_max": 128,
                                                      "page_size": 8}),
                                     ("mamba2_370m", {"n_slots": 2, "s_max": 32})],
                         ids=["paged", "paged_p8", "slot"])
def test_features_on_the_card_equal_the_cpu_count(gen, arch, kw):
    """The count runs on meta tensors of the engine's shapes: a card engine
    and a CPU engine of the same shapes give the same features, and the
    card's live pool is untouched."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.planner import features_from_engine
    from repro_torch.serving import ServingEngine
    card = _card_model(arch)
    cpu = Model(card.cfg, {k: v for k, v in _to_cpu(card.params).items()}, device="cpu")
    eng = ServingEngine(card, **kw)
    before = {k: v.clone() for k, v in eng.cache.items()}
    got = features_from_engine(eng)
    want = features_from_engine(ServingEngine(cpu, device="cpu", **kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flops > 0 and got.bytes > 0
    assert all(torch.equal(eng.cache[k], v) for k, v in before.items())


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def _held_bytes():
    """`torch.cuda.memory_allocated` with cuBLAS's workspaces left out, read
    where nothing runs: cuBLAS keeps one per (thread's handle, stream) for
    the process (made anew at next use), and a spawn's PREPARE is the first
    cuBLAS work of its worker thread. torch's own leak check does the same."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def test_spawn_retire_cycle_returns_the_memory(gen):
    """A spawn (PREPARE captures the decode graph) that serves and then
    retires leaves the memory the tensors hold (`_held_bytes`) within one
    KV page of where it stood before the spawn, also through the planner,
    whose log keeps the spawn's ticket; a second cycle holds it too."""
    from repro_torch.planner import A100, EngineSpec, WorkloadPlanner
    from repro_torch.serving import (
        Autoscaler,
        LoadTracker,
        PrepareWorker,
        Request,
        ServingCluster,
        ServingEngine,
    )
    from repro_torch.sharding import default_plan
    model = _card_model("minitron_4b")
    kw = {"n_slots": 4, "s_max": 64, "page_size": 16}
    page = sum(v[:1].numel() * v.element_size() for v in
               ServingEngine(model, **kw).cache.values())       # one page, every layer
    prompts = _card_prompts(model.cfg)
    worker = PrepareWorker(max_workers=1)
    try:
        cluster = ServingCluster(prepare_worker=worker)
        cluster.register("base", ServingEngine(model, labels={"data-type": "general"}, **kw))
        planner = WorkloadPlanner(
            cluster, lambda spec, label: ServingEngine(model, **kw),
            specs=[EngineSpec(plan=default_plan(), n_slots=4, s_max=64)], profiles=[A100],
            dwell=0)
        scaler = Autoscaler(cluster, lambda label: ServingEngine(model, **kw),
                            planner=planner, async_spawn=True, tracker=LoadTracker(alpha=1.0))
        planner.features_for(planner.specs[0])        # the probe engine, before the mark
        start = _held_bytes()
        scaler.set_bounds("general", 1, 1)            # "base" stays
        for cycle in range(2):
            scaler.set_bounds("phi", 1, 1)
            for _ in range(3):
                scaler.tick()
                cluster.run(wait_pending=True)
            (name,) = cluster.engines_for_label("phi")
            reqs = [Request(i, p, max_new_tokens=6, labels={"data-type": "phi"})
                    for i, p in enumerate(prompts)]
            for r in reqs:
                cluster.submit(r)
            cluster.run()
            assert cluster.engine(name).decode_stats["replays"] > 0
            assert all(len(r.tokens_out) == 6 for r in reqs)
            scaler.set_bounds("phi", 0, 0)
            for _ in range(3):
                scaler.tick()
                cluster.run()
            assert [d.kind for d, _ in scaler.events] == ["spawn", "retire"] * (cycle + 1)
            assert name not in cluster.engines()
            assert abs(_held_bytes() - start) <= page, cycle
    finally:
        worker.shutdown()


# ---------------------------------------------------------------------------
# the discrete-event replay on the card (`traffic/replay.py`)
# ---------------------------------------------------------------------------


def test_recorded_replay_on_the_card_equals_the_cpu(gen, monkeypatch):
    """`recorded_replay` at the reduced config gives the same counts,
    attainment, decisions and window records on the card as on the CPU
    when both planners score one pinned profile, under which the phi flash
    crowd spawns an engine and the tail retires it (token values do not enter
    a replay's counts: a request stops at its budget). The decode steps
    after an engine's first replay its graph."""
    import dataclasses

    import repro_torch.planner as planner_pkg
    import repro_torch.planner.planner as planner_mod
    from repro_torch.planner import DeviceProfile
    from repro_torch.traffic.replay import recorded_replay
    pinned = DeviceProfile("pinned", peak_flops=1e11, hbm_bw=5e8, mem_bytes=8 << 30,
                           link_bw=5e8)
    for mod in (planner_pkg, planner_mod):
        monkeypatch.setattr(mod, "calibrate_host_profile", lambda **kw: pinned)
    out = {}
    for device in ("cuda", "cpu"):
        stats, rec, planner = recorded_replay(2000, device=device)
        decisions = [(e.data["action"], e.label, e.engine) for e in rec.events("scale.decision")]
        out[device] = (dataclasses.asdict(stats), decisions, planner)
    (card, card_decisions, card_planner), (cpu, cpu_decisions, _) = out["cuda"], out["cpu"]
    for key in ("n_requests", "submitted", "completed", "dropped", "steps", "duration_s",
                "engine_seconds", "peak_engines", "final_engines", "attainment",
                "attainment_overall", "reports", "reports_finalized", "windows"):
        assert card[key] == cpu[key], key
    assert card_decisions == cpu_decisions
    assert [d[0] for d in card_decisions] == ["spawn", "retire"]     # the crowd scales
    assert card["dropped"] == 0 and card["completed"] == card["n_requests"]
    for name in card_planner.cluster.engines():
        stats = card_planner.cluster.engine(name).decode_stats
        assert stats["eager"] <= 1 and stats["discards"] == 0


# ---------------------------------------------------------------------------
# the training side on the card
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_autograd(gen):
    """The Hopper kernels are forward-only: a CUDA input that requires grad
    under grad mode raises (autograd would see the ctypes-filled output as a
    constant, a silent zero gradient); under `no_grad` the kernel launches."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 17, 4, 64, generator=gen, device="cuda").requires_grad_(True)
    k = torch.randn(1, 17, 2, 64, generator=gen, device="cuda")
    logits = torch.randn(9, 8, generator=gen, device="cuda").requires_grad_(True)
    x, dt, A, Bm, Cm = (torch.randn(*s, generator=gen, device="cuda")
                        for s in ((1, 17, 4, 16), (1, 17, 4), (4,), (1, 17, 1, 16), (1, 17, 1, 16)))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.moe_topk(logits, 2)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssd_scan(x, dt.abs(), -A.abs(), Bm, Cm, chunk=16)
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        ops.flash_attention(q, k, k)
        ops.moe_topk(logits, 2)
        ops.ssd_scan(x, dt.abs(), -A.abs(), Bm, Cm, chunk=16)
    torch.cuda.synchronize()
    assert all(ops.LAUNCHES[n] == before[n] + 1 for n in before)


@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m",
                                  "whisper_large_v3"])
def test_train_step_on_the_card_equals_the_cpu(gen, arch):
    """One `make_train_step` step of a reduced fp32 model on the card and on
    the CPU from the same weights and batch: the losses agree within 1e-5
    relative, the parameters after the step within 1e-4 (Adam's first step
    is ~lr sign(g), so a coordinate whose gradient is ~0 may move the other
    way: at most 0.1 % of them), and training launches no kernel."""
    import dataclasses

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                              activ_dtype="float32")
    card = Model(cfg, device="cuda", seed=0)
    batch = make_batch(cfg, ShapeCell("t", "train", 16, 2), device="cuda")
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
    out = {}
    for device in ("cuda", "cpu"):
        params = tree_util.map_tree(lambda _, t: t.to(device, copy=True), card.params)
        model = Model(cfg, params, device=device)
        opt = AdamW(lr=1e-3)
        step = make_train_step(model, opt)
        before = dict(ops.LAUNCHES)
        params, _, loss, _ = step(params, opt.init(params),
                                  {k: v.to(device) for k, v in batch.items()})
        assert ops.LAUNCHES == before
        out[device] = (float(loss), [t.cpu() for t in tree_util.leaves(params)])
    (l_card, p_card), (l_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    moved = sum(int((~torch.isclose(a, b, atol=1e-4, rtol=1e-4)).sum())
                for a, b in zip(p_card, p_cpu))
    assert moved <= 1e-3 * sum(t.numel() for t in p_cpu)


def test_train_data_and_checkpoint_default_to_the_card(gen, tmp_path):
    """`SyntheticLM` and `load_checkpoint` place their tensors on the card
    unless the caller names the CPU; a checkpoint of card tensors restores
    bit for bit."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLM
    ds = SyntheticLM(256, 16, 4, seed=3)
    b1, b2 = ds.batch_at(7), ds.batch_at(7)
    assert b1["tokens"].device.type == "cuda" and torch.equal(b1["tokens"], b2["tokens"])
    tree = {"w": torch.randn(3, 5, generator=gen, device="cuda").to(torch.bfloat16),
            "count": torch.tensor(4, dtype=torch.int32, device="cuda")}
    save_checkpoint(tmp_path, 2, tree)
    step, back = load_checkpoint(tmp_path, tree)
    assert step == 2 and back["w"].device.type == "cuda"
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["count"], tree["count"])


def test_whisper_prefill_on_the_card_equals_the_cpu(gen):
    """A reduced fp32 Whisper's prefill and two decode steps on the card
    (flash in the decoder's prefill, once a layer) against the CPU's plain
    path: logits within 1e-4, the same greedy tokens."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    card = _card_model("whisper_large_v3")
    cfg = card.cfg
    cpu = Model(cfg, tree_util.map_tree(lambda _, t: t.cpu(), card.params), device="cpu")
    frames = torch.randn(1, cfg.encdec.encoder_seq_len, cfg.d_model, generator=gen,
                         device="cuda")
    tokens = torch.randint(2, cfg.vocab_size, (1, 9), generator=gen, device="cuda",
                           dtype=torch.int32)
    out = {}
    for model in (card, cpu):
        dev = model.device
        before = ops.LAUNCHES["flash_attention"]
        with torch.no_grad():
            logits, pre = model.prefill({"frames": frames.to(dev), "tokens": tokens.to(dev)})
            launched = ops.LAUNCHES["flash_attention"] - before
            cache = model.init_cache(1, 12, dtype=torch.float32)
            for key, t in pre.items():
                cache[key][:, :, :t.shape[2]] = t
            steps, picks = [logits], []
            for i in range(2):
                nxt = steps[-1].argmax(-1, keepdim=True).to(torch.int32)
                picks.append(int(nxt))
                lg, cache = model.decode_step(nxt, cache, torch.tensor(9 + i, device=dev))
                steps.append(lg)
        out[dev.type] = (torch.stack(steps).cpu(), picks, launched)
    assert out["cuda"][2] == cfg.num_layers and out["cpu"][2] == 0
    assert out["cuda"][1] == out["cpu"][1]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=1e-4)


def test_train_lm_launcher_on_the_card(gen, capsys):
    """`python -m repro_torch.launch.train_lm` trains on the card by
    default, recovers from its injected failure and finishes."""
    from repro_torch.launch import train_lm
    train_lm.main(["--steps", "12", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "device=cuda" in out and "recovering" in out and "restarts=1" in out
