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
                                   (2, 200, 6, 2, 64), (1, 257, 4, 4, 128), (1, 1, 4, 2, 64)],
                         ids=["qwen_ragged", "gqa_d64", "gqa_s17_d16", "gqa_s257_d32",
                              "gqa_s200_d64", "s257_d128", "s1"])
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
                                   (1, 1, 4, 1, 16, 16, 16)],
                         ids=["mamba2_ragged257", "grouped", "mamba2_reduced", "mamba2_s17",
                              "mamba2_s255", "p16_s77_chunk32", "grouped_p16_s257",
                              "chunk80_partial_tile", "n48_padded", "chunk1024", "s1"])
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
                                        ("mamba2_370m", False)],
                         ids=["paged", "attn_slot", "ssm_slot"])
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
    assert n == 3 and execs["prefill"] == (5, 33)
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
