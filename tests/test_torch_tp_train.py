"""The train step on its shards: `jit_train_step` a layer at a time over the
FSDP axes, tensor-parallel on the model axis (the groups of `lm.tp_groups`
on their shards, a vocab-parallel loss), the residual stream
sequence-parallel where the plan says so, on a 4-rank gloo mesh on the CPU,
against the one-device port and the reference's `jit_train_step` on four
placeholder JAX devices.

The module fixture starts at once (~60 s of wall time alone, several times
that beside the rest of the suite on a loaded machine; the rank job ~45 s,
the reference's children ~50 s each):

  * ONE job of 4 gloo ranks (`_torch_tp_train_jobs.tp_train_job`, one thread
    each, killed when no part finishes for `STALL_S` or after `LIMIT_S` in
    all): reduced fp32 Minitron-4B, Qwen1.5-MoE, Mamba2-370m, Jamba, MiniCPM3
    (MLA), Qwen2-VL (M-RoPE) and Whisper on ``(1, 2, 2)`` under
    `default_plan()` (a model axis of 2; ``sequence_parallel`` as the dry
    run's `plan_for_cell` sets it for a train cell: on for the dense, MoE,
    VLM and enc-dec configs), Minitron with it forced off, and three
    configs on ``(2, 2, 1)`` under `default_plan(multi_pod=True)`; one and
    two accumulation steps; one step whose gradients are reduced in bf16;
    Minitron and Whisper cut to 3 heads (``odd_<arch>``), their attention
    on each rank's padded head slots;
    Whisper's step with 33 encoder frames, which the model axis cannot cut
    (its encoder's residual stream whole, the decoder's cut); beside each,
    the one-device port's step on the same weights and batch; and the
    autograd collectives of `sharding.ctx` one by one;
  * the reference's `jit_train_step` on the same cases, in four child
    processes of their own (`_torch_tp_train_ref.py`, ``XLA_FLAGS`` for 4
    host devices and one intra-op thread).

The loss and the metrics are held within `REL` of the other sides', the
AdamW moments within `_torch_dist_jobs._train_check`'s tolerance (atol 1e-7,
rtol 1e-4), the params within its sign-flip rule. A step whose gradients
are reduced in bf16 rounds each rank's partial sum to bf16 before the sum
(the wire carries bf16), where one device rounds the whole gradient once:
its moments are held within a share of each leaf's largest value instead
(`_torch_tp_train_jobs.BF16_SHARE`: 2^-6 for ``m``, 2^-4 for ``v``, a
square; the largest seen on the CPU: 0.6 % and 2.0 %).
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
from _torch_dist_jobs import LR, WD, _fp32, run_job
from _torch_tp_jobs import arch_config
from _torch_tp_train_jobs import (BF16_SHARE, CASES, ODD_FRAMES, ODD_TRAIN, S, TRAIN_ARCHS,
                                  bf16_excess, case_name)

from repro_torch import tree as tree_util
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
#: the rank job is killed when no part finishes for STALL_S seconds, every
#: process after LIMIT_S in all (as `tests/test_torch_tp_serving.py`)
STALL_S = 300
LIMIT_S = 1200
NAMES = [case_name(c) for c in CASES]
#: the reference's cases split over this many child processes, balanced by
#: the seconds a case took alone (XLA compiles Jamba's hybrid step longest)
N_REF = 4
REF_COST = {"jamba_v0_1_52b": 30, "qwen2_moe_a2_7b": 10, "mamba2_370m": 10}


def _ref_split(names, n):
    """``names`` over ``n`` children, each case to the least loaded."""
    load, out = [0] * n, [[] for _ in range(n)]
    for name in sorted(names, key=lambda c: -REF_COST.get(c.split(":")[0], 5)):
        i = load.index(min(load))
        out[i].append(name)
        load[i] += REF_COST.get(name.split(":")[0], 5)
    return out


@pytest.fixture(scope="module")
def jobs():
    tmp = tempfile.mkdtemp()
    for arch in TRAIN_ARCHS + tuple(f"odd_{a}" for a in ODD_TRAIN):
        tree = tree_util.map_tree(lambda _, x: x.numpy(),
                                  Model(arch_config(arch), device="cpu").params)
        with open(os.path.join(tmp, f"{arch}.pkl"), "wb") as f:
            pickle.dump(tree, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_tp_train_ref.py"), tmp,
         os.path.join(tmp, f"ref_{i}.npz"), ",".join(part)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        for i, part in enumerate(_ref_split(NAMES, N_REF))]
    deadline = time.monotonic() + LIMIT_S
    old = os.environ.get("TP_TRAIN_WEIGHTS")
    os.environ["TP_TRAIN_WEIGHTS"] = tmp
    try:
        ranks = run_job("tp_train_job", world=4, timeout=LIMIT_S, stall=STALL_S,
                        module="_torch_tp_train_jobs")
    finally:
        if old is None:
            os.environ.pop("TP_TRAIN_WEIGHTS", None)
        else:
            os.environ["TP_TRAIN_WEIGHTS"] = old
    ref, status = {}, {}
    for i, p in enumerate(refs):
        try:
            stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            p.kill()
        assert p.returncode == 0, f"reference failed:\n{stderr[-3000:]}"
        status.update(json.loads(stdout.strip().splitlines()[-1]))
        with np.load(os.path.join(tmp, f"ref_{i}.npz")) as z:
            ref.update({k: z[k] for k in z.files})
    return {"ranks": ranks, "ref": ref, "status": status}


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), result.get("error")
    return result


def _rel(got, want, floor=0.0):
    return abs(got - want) <= REL * max(abs(want), floor)


@pytest.mark.parametrize("case", NAMES)
def test_tp_train_step_matches_one_device_port(jobs, case):
    """Every rank's loss and metrics within REL of the one-device step's,
    its params and moments (put together) within the train tolerance."""
    bf16 = case.endswith("bfloat16")
    for out in jobs["ranks"]:
        r = _ok(out[case])
        assert _rel(r["loss"], r["one_loss"])
        for k, v in r["one_metrics"].items():
            assert _rel(r["metrics"][k], v, 1e-6), k
        p = r["params_check"]
        assert p["bad"] == 0 and p["flips"] <= 1e-3 * p["total"], p
        if bf16:
            assert r["m_bf16_excess"] <= 0.0
        else:
            assert r["m_check"]["bad"] == 0 and r["v_check"]["bad"] == 0, (r["m_check"],
                                                                            r["v_check"])


@pytest.mark.parametrize("case", NAMES)
def test_tp_train_step_matches_reference(jobs, case):
    """Rank 0's step against the reference's `jit_train_step` on four
    devices of that mesh under the same plan: loss and metrics within REL,
    moments within the train tolerance (the bf16 case's within its bf16
    one), params within the sign-flip rule."""
    st = jobs["status"][case]
    assert st["status"] == "ok", st.get("trace")
    ref = {k.split("|", 1)[1]: v for k, v in jobs["ref"].items() if k.startswith(case + "|")}
    r = _ok(jobs["ranks"][0][case])
    assert _rel(r["loss"], float(ref["loss"]))
    for k, v in r["metrics"].items():
        assert _rel(v, float(ref[f"metric/{k}"]), 1e-6), k
    bf16 = case.endswith("bfloat16")
    flips = total = 0
    for name, got in r["trees"]["params"].items():
        want = ref[f"params/{name}"].astype(np.float64)
        got = got.astype(np.float64)
        flips += int((~np.isclose(got, want, atol=1e-6, rtol=1e-5)).sum())
        total += got.size
        assert (np.abs(got - want) <= 2 * LR * (1 + WD) + 1e-6).all(), name
    assert flips <= 1e-3 * total, (flips, total)
    for key in ("m", "v"):
        for name, got in r["trees"][key].items():
            want = ref[f"{key}/{name}"]
            if bf16:
                assert bf16_excess(got, want, BF16_SHARE[key]) <= 0.0, f"{key}/{name}"
            else:
                assert np.allclose(got, want, atol=1e-7, rtol=1e-4), f"{key}/{name}"


@pytest.mark.parametrize("case", [c for c in NAMES if ":1x2x2:" in c])
def test_replicated_leaves_equal_on_the_model_axis(jobs, case):
    """The leaves the model axis replicates (norms, the router, MLA's
    down-projections, the SSM's B and C) hold the same first moment, bit
    for bit, on both ranks of each model-axis group: each took the whole
    gradient, neither a partial sum nor twice it."""
    ranks = [_ok(out[case])["replicated_m"] for out in jobs["ranks"]]
    assert ranks[0]
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a].keys() == ranks[b].keys()
        for name in ranks[a]:
            assert np.array_equal(ranks[a][name], ranks[b][name]), (a, b, name)


#: the tensor-parallel groups of each reduced config, all dividing 2
GROUPS = {
    "minitron_4b": ("attn", "attn_kv", "mlp"),
    "qwen2_moe_a2_7b": ("attn", "attn_kv", "experts", "shared"),
    "mamba2_370m": ("ssm",),
    "jamba_v0_1_52b": ("attn", "attn_kv", "ssm", "mlp", "experts"),
    "minicpm3_4b": ("mla", "mlp"),
    "qwen2_vl_2b": ("attn", "attn_kv", "mlp"),
    "whisper_large_v3": ("enc_attn", "enc_attn_kv", "enc_mlp", "self_attn", "self_attn_kv",
                         "cross_attn", "cross_attn_kv", "dec_mlp"),
}


def _want_counts(arch, forwards):
    cfg = _fp32(arch)
    if cfg.encdec is not None:
        want = {"vocab:local": forwards}
        for g in GROUPS[arch]:
            n = cfg.encdec.num_encoder_layers if g.startswith("enc_") else cfg.num_layers
            want[f"{g}:local"] = forwards * n
        want["tp_local"] = sum(want.values())
        return want
    from repro_torch.models.lm import layer_kinds, n_scan_steps
    per_layer = {"ssm": 0, "attn": 0, "mla": 0, "mlp": 0, "moe": 0}
    for mixer, f in layer_kinds(cfg):
        per_layer[mixer] += n_scan_steps(cfg)
        if f != "none":
            per_layer[f] += n_scan_steps(cfg)
    want = {"vocab:local": forwards}
    for g in GROUPS[arch]:
        n = {"attn_kv": per_layer["attn"], "experts": per_layer["moe"],
             "shared": per_layer["moe"]}.get(g, per_layer.get(g))
        want[f"{g}:local"] = forwards * n
    want["tp_local"] = sum(want.values())
    return want


@pytest.mark.parametrize("case", [c for c in NAMES
                                  if ":1x2x2:" in c and not c.startswith("odd_")])
def test_every_dividing_dim_ran_local(jobs, case):
    """On ``(1, 2, 2)`` every group of the config and the vocab ran on its
    model-axis shard, once per forward (a recomputed layer is not counted
    again), none gathered (Whisper: each sub-layer of its encoder and
    decoder). On ``(2, 2, 1)``, a model axis of one rank, no
    tensor-parallel code runs and nothing is counted."""
    arch, _, _, accum, _ = case.split(":")
    for out in jobs["ranks"]:
        assert _ok(out[case])["counts"] == _want_counts(arch, int(accum))
    for other in NAMES:
        if ":2x2x1:" in other:
            assert _ok(jobs["ranks"][0][other])["counts"] == {}


@pytest.mark.parametrize("arch", ODD_TRAIN)
def test_heads_that_do_not_divide_run_padded(jobs, arch):
    """Minitron cut to 3 q heads over 1 K/V head and Whisper to 3 heads of
    16, on the model axis of 2: every attention ran on the rank's padded
    head slots (K/V whole, read by index), once per forward, every other
    group and the vocab on its shard, none gathered."""
    cfg = arch_config(f"odd_{arch}")
    if cfg.encdec is not None:
        L, L_enc = cfg.num_layers, cfg.encdec.num_encoder_layers
        want = {"vocab:local": 1, "enc_mlp:local": L_enc, "dec_mlp:local": L,
                "enc_attn:padded": L_enc, "enc_attn_kv:padded": L_enc}
        for a in ("self_attn", "self_attn_kv", "cross_attn", "cross_attn_kv"):
            want[f"{a}:padded"] = L
    else:
        L = cfg.num_layers
        want = {"vocab:local": 1, "mlp:local": L, "attn:padded": L, "attn_kv:padded": L}
    for state in ("local", "padded"):
        want[f"tp_{state}"] = sum(n for k, n in want.items() if k.endswith(f":{state}"))
    for out in jobs["ranks"]:
        assert _ok(out[f"odd_{arch}:1x2x2:sp:1:fp32"])["counts"] == want


def test_sequence_parallel_where_the_plan_sets_it(jobs):
    """`plan_for_cell` turns sequence parallelism on for the dense, MoE, VLM
    and enc-dec train cells and off for the SSM and hybrid ones; the forced
    case runs without it."""
    want = {"minitron_4b": True, "qwen2_moe_a2_7b": True, "mamba2_370m": False,
            "jamba_v0_1_52b": False, "minicpm3_4b": True, "qwen2_vl_2b": True,
            "whisper_large_v3": True}
    r = jobs["ranks"][0]
    for arch, on in want.items():
        assert _ok(r[f"{arch}:1x2x2:sp:1:fp32"])["sequence_parallel"] is on, arch
    assert _ok(r["minitron_4b:1x2x2:nosp:1:fp32"])["sequence_parallel"] is False


def test_sp_keeps_frames_that_do_not_divide_whole(jobs):
    """Whisper's SP step with `ODD_FRAMES` encoder frames on the model axis
    of 2: the encoder's residual stream stays whole (its frames do not
    divide), the decoder's is cut; every group still runs on its shard, and
    the loss, metrics, params and moments are the one-device step's."""
    for out in jobs["ranks"]:
        r = _ok(out["frames"])
        assert [tuple(v) for v in r["sp_on"]] == [(ODD_FRAMES, False), (S, True)], r["sp_on"]
        assert r["counts"] == _want_counts("whisper_large_v3", 1)
        assert _rel(r["loss"], r["one_loss"])
        for k, v in r["one_metrics"].items():
            assert _rel(r["metrics"][k], v, 1e-6), k
        p = r["params_check"]
        assert p["bad"] == 0 and p["flips"] <= 1e-3 * p["total"], p
        assert r["m_check"]["bad"] == 0 and r["v_check"]["bad"] == 0, (r["m_check"],
                                                                        r["v_check"])


TOL = 1e-12


@pytest.mark.parametrize("op", ["enter_reduce", "sum_shard", "sp", "sp_enter", "once", "max"])
def test_autograd_collective_matches_one_device(jobs, op):
    """Each autograd collective in float64 on the model axis of 2 against
    the same function on one device: the forward and every input's gradient
    (put together over the axis where a rank holds a shard).
    ``enter_reduce``: `ctx.tp_enter` into a column-split product, a
    row-split product out through `ctx.tp_reduce`; ``sum_shard``: a gated
    norm's variance over split channels through `ctx.tp_sum_shard`; ``sp``:
    a residual stream on sequence pieces (`ctx.sp_cut`, `ctx.sp_gather`,
    `ctx.sp_scatter`); ``sp_enter``: the same stream as the reference lays
    it out, the norm on the piece (its gain entering it, `ctx.tp_enter`)
    and the normed piece gathered into the shards by `ctx.sp_enter`;
    ``once``: that layout with a branch every rank computes whole from the
    normed input, read through `ctx.tp_once`; ``max``: `ctx.tp_max`."""
    for out in jobs["ranks"]:
        got = _ok(out["ops"])[op]
        assert max(got if isinstance(got, list) else [got]) <= TOL, got


def test_each_all_reduce_needs_its_own_backward(jobs):
    """The trap of two backwards for one all-reduce: the residual sum with
    an all-reduce backward doubles the input's gradient, and the variance
    with an identity backward drops the other rank's part; both are far
    off where the right rules agree to rounding."""
    for out in jobs["ranks"]:
        r = _ok(out["ops"])
        assert r["reduce_wrong"] > 1.0 and r["sum_shard_wrong"] > 0.1


def test_replicated_branch_counts_once(jobs):
    """The trap of a replicated branch behind `ctx.sp_enter`: every rank
    computes the branch whole from the normed input, and its reduce-scatter
    backward sums every rank's whole gradient of it. Read as it is, the
    branch's part of the input's gradient comes out ``n`` times (its excess
    over the right gradient is ``n - 1`` times that part, to rounding), far
    off; read through `ctx.tp_once` it agrees to rounding (the ``once`` op
    case)."""
    for out in jobs["ranks"]:
        r = _ok(out["ops"])
        assert r["once_wrong"] > 0.1 and r["once_excess"] <= TOL, r
        assert max(r["once"]) <= TOL, r["once"]


def _norm_rows_wanted(case):
    """The sequence lengths a case's norms see on the model axis of 2:
    each stack's piece where it runs sequence-parallel, else its whole
    sequence."""
    arch, _, sp, _, _ = case.split(":")
    cfg = arch_config(arch)
    seqs = [S] + ([cfg.encdec.encoder_seq_len] if cfg.encdec is not None else [])
    on = sp == "sp" and cfg.family in ("dense", "moe", "vlm", "encdec")
    return sorted({n // 2 if on and n % 2 == 0 else n for n in seqs})


@pytest.mark.parametrize("case", [c for c in NAMES if ":1x2x2:" in c])
def test_norms_run_on_the_rank_piece(jobs, case):
    """Under sequence parallelism every sub-layer norm and every final
    norm (Whisper's encoder and decoder too) runs on the rank's ``S / 2``
    rows of its stack's sequence, as the reference norms it, in the forward
    and its recompute alike; a step without it (SSM, hybrid, the forced
    ``nosp`` case) norms the whole sequence. Whisper fed `ODD_FRAMES`
    frames norms its encoder's whole stream and its decoder's piece."""
    want = _norm_rows_wanted(case)
    for out in jobs["ranks"]:
        assert _ok(out[case])["norm_rows"] == want
        assert _ok(out["frames"])["norm_rows"] == [S // 2, ODD_FRAMES]


def test_padded_leaf_gradient_sums_over_the_axis(jobs):
    """A padded head group's leaves (3 heads, stored 1.5 heads a rank),
    gathered whole and cut to each rank's 2 head slots: the forward is the
    one-device product, and each leaf's gradient, summed over the model axis
    into the rank's shard (``summed``: a reduce-scatter), is the
    one-device gradient's shard; cut as a replicated leaf's backward is,
    each rank would keep its own slots' part alone, far off."""
    for out in jobs["ranks"]:
        r = _ok(out["ops"])["padded"]
        assert r["slots"] == [5, 4]
        assert max(r["summed"]) <= TOL, r["summed"]
        assert r["cut"][0] <= TOL and min(r["cut"][1:]) > 0.1, r["cut"]


def test_layer_gather_returns_the_summed_shard(jobs):
    """`ctx.gather_shard` of a leaf sharded over data and model, rows split
    over data: the forward is the leaf whole over data and this rank's
    model shard; the backward is the gradient over every rank's rows, cut
    to the rank's shard, by a reduce-scatter (``shard_grads``) or an
    all-reduce then a cut."""
    for out in jobs["ranks"]:
        for shard_grads, (shape, fwd, bwd) in _ok(out["ops"])["gather_shard"].items():
            assert shape == [6, 5] and fwd == 0.0 and bwd <= TOL, shard_grads
