"""The kernels as PyTorch custom ops (`repro_torch.kernels.ops`), on the CPU.

Each of ``repro_torch::flash_attention``, ``moe_topk`` and ``ssd_scan``
passes `torch.library.opcheck`'s schema and fake-tensor checks on CPU
inputs (the CPU implementation is the plain version). Its autograd checks
are left out: the kernels define no backward, as the reference's Pallas
kernels define no VJP, and the wrappers refuse a CUDA input that requires
grad. The fake implementations give the plain versions' output shapes and
dtypes, refuse what the CUDA wrappers refuse, and raise no launch count;
the FLOP formulas equal a count by hand. The kernels on the card are in
`tests/test_torch_cuda.py` (``cuda`` marker).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops, ref


def _rand(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed + len(shape))
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _flash_args(B=1, S=17, Hq=4, Hkv=2, D=16, dtype=torch.float32):
    return (_rand(B, S, Hq, D, dtype=dtype, seed=1), _rand(B, S, Hkv, D, dtype=dtype, seed=2),
            _rand(B, S, Hkv, D, dtype=dtype, seed=3))


def _moe_args(T=33, E=60):
    return (_rand(T, E, seed=4),)


def _ssd_args(B=1, S=40, H=4, G=2, P=16, N=16):
    rng = np.random.default_rng(5)
    x = _rand(B, S, H, P, seed=6)
    dt = torch.as_tensor(np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32))
    A = torch.as_tensor(-np.exp(0.5 * rng.standard_normal(H)).astype(np.float32))
    return x, dt, A, _rand(B, S, G, N, seed=7), _rand(B, S, G, N, seed=8)


# (op, its positional arguments, the plain version as the wrapper calls it)
CASES = {
    "flash_attention": (torch.ops.repro_torch.flash_attention,
                        lambda: (*_flash_args(), True, None),
                        lambda q, k, v, causal, scale: ref.flash_attention_ref(
                            q, k, v, causal=causal, scale=scale)),
    "moe_topk": (torch.ops.repro_torch.moe_topk, lambda: (*_moe_args(), 4, True),
                 lambda x, k, norm: ref.moe_topk_ref(x, k, norm_topk=norm)),
    "ssd_scan": (torch.ops.repro_torch.ssd_scan, lambda: (*_ssd_args(), 16),
                 lambda x, dt, A, B, C, chunk: ref.ssd_scan_ref(x, dt, A, B, C, chunk=chunk)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_schema_and_fake(name):
    op, args, _ = CASES[name]
    torch.library.opcheck(op, args(), test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_op_is_the_plain_version(name):
    op, args, plain = CASES[name]
    a = args()
    out, gold = op(*a), plain(*a)
    for o, g in zip(out if isinstance(out, tuple) else (out,),
                    gold if isinstance(gold, tuple) else (gold,)):
        assert torch.equal(o, g)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_shapes_and_dtypes_equal_the_plain_version(name):
    op, args, plain = CASES[name]
    a = args()
    gold = plain(*a)
    gold = gold if isinstance(gold, tuple) else (gold,)
    before = dict(ops.LAUNCHES)
    with FakeTensorMode() as mode:
        fa = tuple(mode.from_tensor(t) if isinstance(t, torch.Tensor) else t for t in a)
        out = op(*fa)
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in out] == [(tuple(g.shape), g.dtype) for g in gold]
    assert ops.LAUNCHES == before


def test_fake_flash_refuses_what_the_card_refuses():
    with FakeTensorMode():
        q, k, v = (torch.empty(1, 17, 4, 48), torch.empty(1, 17, 2, 48),
                   torch.empty(1, 17, 2, 48))
        with pytest.raises(ValueError, match="head dim 48"):
            ops.flash_attention(q, k, v)
        q, k = torch.empty(1, 17, 4, 64), torch.empty(1, 17, 2, 64)
        with pytest.raises(TypeError, match="dtype"):
            ops.flash_attention(q, k.bfloat16(), k)
        with pytest.raises(ValueError, match="multiple of Hkv"):
            ops.flash_attention(torch.empty(1, 17, 5, 64), k, k)
        with pytest.raises(ValueError, match="contiguous"):
            ops.flash_attention(q.transpose(1, 2), k, k)
        out = ops.flash_attention(torch.empty(1, 17, 96, 192, dtype=torch.bfloat16),
                                  torch.empty(1, 17, 8, 192, dtype=torch.bfloat16),
                                  torch.empty(1, 17, 8, 192, dtype=torch.bfloat16))
        assert out.shape == (1, 17, 96, 192) and out.dtype == torch.bfloat16


def test_fake_moe_topk_and_ssd_scan_refuse_what_the_card_refuses():
    with FakeTensorMode():
        with pytest.raises(ValueError, match="E <= 64"):
            ops.moe_topk(torch.empty(8, 65), 4)
        with pytest.raises(TypeError, match="dtype"):
            ops.moe_topk(torch.empty(8, 16, dtype=torch.float16), 2)
        x, dt, A, B, C = (torch.empty(1, 32, 4, 16), torch.empty(1, 32, 4), torch.empty(4),
                          torch.empty(1, 32, 2, 16), torch.empty(1, 32, 2, 16))
        with pytest.raises(TypeError, match="x, B and C"):
            ops.ssd_scan(x, dt, A, B.bfloat16(), C.bfloat16(), chunk=16)
        with pytest.raises(ValueError, match="chunk=24"):
            ops.ssd_scan(x, dt, A, B, C, chunk=24)
        with pytest.raises(ValueError, match="multiple of G"):
            ops.ssd_scan(torch.empty(1, 32, 3, 16), torch.empty(1, 32, 3), torch.empty(3),
                         B, C, chunk=16)


def test_flop_formulas_equal_a_count_by_hand():
    # flash: 4 B Hq D per kept (q, k) pair; causal S=5 keeps 1+2+3+4+5 = 15
    q, k, v = _flash_args(B=2, S=5, Hq=4, Hkv=2, D=16)
    with FlopCounterMode(display=False) as fc:
        ops.flash_attention(q, k, v, causal=True)
        causal = fc.get_total_flops()
        ops.flash_attention(q, k, v, causal=False)
    assert causal == 4 * 2 * 4 * 16 * 15
    assert fc.get_total_flops() - causal == 4 * 2 * 4 * 16 * 25
    # MoE top-k: T E (5 + k)
    with FlopCounterMode(display=False) as fc:
        ops.moe_topk(_rand(10, 8), 2)
    assert fc.get_total_flops() == 10 * 8 * 7
    # SSD scan, chunks of 16 over S=40 (16, 16, 8 rows), P=16, N=16, B=1, H=4:
    # per chunk Lc (Lc + 1) (N + P) + 4 Lc P N
    per_head = sum(Lc * (Lc + 1) * 32 + 4 * Lc * 16 * 16 for Lc in (16, 16, 8))
    with FlopCounterMode(display=False) as fc:
        ops.ssd_scan(*_ssd_args(), chunk=16)
    assert fc.get_total_flops() == 4 * per_head


def test_step_count_takes_the_kernels_flop_formulas():
    """The planner's and the dry run's counter (`_StepCount`) counts a
    kernel's op by its formula, not by its output's elements."""
    from repro_torch.planner.estimator import _StepCount
    q, k, v = _flash_args(B=2, S=5, Hq=4, Hkv=2, D=16)
    with _StepCount() as count:
        ops.flash_attention(q, k, v, causal=True)
    assert count.flops == 4 * 2 * 4 * 16 * 15
    assert count.bytes == sum(t.numel() * 4 for t in (q, k, v, q))
