"""The yardstick's FLOP and byte counts against a count by hand at a small
size."""
from bench import yardstick

DENSE = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab_size": 10, "mlp_act": "relu2", "activ_dtype": "bfloat16"}
MOE = dict(DENSE, mlp_act="silu",
           moe={"num_experts": 6, "top_k": 2, "d_expert": 4, "num_shared_experts": 1,
                "d_shared": 8})


def test_dense_token_and_prefill_by_hand():
    # a layer: q 8x8, k 8x4, v 8x4, o 8x8 = 192; mlp 2 x 8x16 = 256 -> 448 a layer
    assert yardstick.token_weights(DENSE) == 2 * 448
    # prefill of 3: 2*3*896 matmul, attention 2 layers x 4*2*4 x (1+2+3), head 2*8*10
    assert yardstick.prefill_ops(DENSE, 3) == 2 * 3 * 896 + 2 * 32 * 6 + 160
    # a decoded token over 5 keys
    assert yardstick.decode_ops(DENSE, 5) == 2 * 896 + 2 * 32 * 5 + 160


def test_moe_counts_the_picked_experts_and_the_shared_one():
    # attention 192; router 8x6 = 48; 2 picked experts of 3 x 8x4 = 192; shared 3 x 8x8 = 192
    assert yardstick.token_weights(MOE) == 2 * (192 + 48 + 192 + 192)


def test_kernel_calls_by_hand():
    ops, nbytes = yardstick.flash_call(DENSE, 4)
    assert ops == 4 * 2 * 4 * 10                       # 10 causal pairs
    assert nbytes == 2 * 4 * 4 * (2 * 2 + 2 * 1)      # q, out at 2 heads; k, v at 1
    ops, nbytes = yardstick.moe_topk_call(MOE, 5)
    assert ops == 5 * 6 * 7 and nbytes == 4 * 5 * 6 + 8 * 5 * 2


def test_bound_takes_the_larger():
    t, by = yardstick.bound_s(989e12, 1.0, "bfloat16")
    assert by == "operations" and abs(t - 1.0) < 1e-12
    t, by = yardstick.bound_s(1.0, 3.35e12, "bfloat16")
    assert by == "bytes" and abs(t - 1.0) < 1e-12


def test_mfu_is_the_profiled_steps_work_over_device_busy_time():
    import types
    from bench.metrics.common import profiled_prefills  # noqa: F401  (the readers' package)
    from bench import spec
    read = spec.load_reader("model.mfu_pct")
    steps = [(0.0, 1.0, 1), (1.0, 2.0, 1), (2.0, 3.0, 1)]
    r = types.SimpleNamespace(prompt=[0] * 3, admit_step=1, stamps=[1.5, 2.0, 3.0])
    trace = types.SimpleNamespace(steps=[1, 2], busy_s=1e-9)
    run = types.SimpleNamespace(trace=trace, steps=steps, requests=[r], model=DENSE)
    # the prefill in step 1 and the two tokens decoded in steps 1 and 2
    ops = (yardstick.prefill_ops(DENSE, 3) + yardstick.decode_ops(DENSE, 4)
           + yardstick.decode_ops(DENSE, 5))
    assert read(run) == 100.0 * ops / (1e-9 * 989e12)
    trace.busy_s = 2e-9                         # the same work in twice the busy time
    assert read(run) == 100.0 * ops / (2e-9 * 989e12)
    trace.steps = [2]                           # the prefill's step not profiled
    assert read(run) == 100.0 * yardstick.decode_ops(DENSE, 5) / (2e-9 * 989e12)
    run.trace = None
    assert read(run) is None
