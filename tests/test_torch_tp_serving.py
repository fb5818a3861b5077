"""Tensor-parallel serving: `jit_prefill` and `jit_decode_step` computing on
each rank's model-axis shards (heads, ``d_ff`` columns, experts, SSM heads,
vocab), on a 4-rank gloo mesh on the CPU, against the one-device port and
the reference's builders on four placeholder JAX devices.

The module fixture starts at once (~45 s of wall time alone, several times
that beside the rest of the suite on a loaded machine):

  * ONE job of 4 gloo ranks (`_torch_tp_jobs.tp_job`, one thread each,
    killed when no part finishes for `STALL_S` or after `LIMIT_S` in all):
    reduced fp32 Minitron-4B, Qwen1.5-MoE, Mamba2-370m, Jamba, MiniCPM3
    (MLA), Qwen2-VL (M-RoPE) and Whisper (enc-dec), each on ``(1, 2, 2)``
    under `default_plan()` (a model axis of 2: tensor-parallel) and
    ``(2, 2, 1)`` under `default_plan(multi_pod=True)` (a model axis of 1);
    Minitron, MiniCPM3 and Whisper cut to 3 heads, which do not divide the
    axis (attention padded, as the reference pads it); the gated norm and
    the vocab argmax on shards;
  * the reference's `jit_prefill` / `jit_decode_step` on the same weights
    and prompts, in one child process per mesh (`_torch_tp_ref.py`,
    ``XLA_FLAGS`` for 4 host devices and one intra-op thread), and one for
    the configs cut to 3 heads;
  * in the same job and children, the decode step over a sequence-sharded
    cache (`ctx.seq_axes`) on ``(1, 2, 2)`` for reduced fp32 Minitron
    (attention gathered), Qwen1.5-MoE (heads local), MiniCPM3 (MLA), Jamba
    (hybrid) and Whisper (the self-cache sharded, the cross-cache whole):
    ``seq2`` shards the sequence over the model axis, which also holds the
    heads, with 2 rows; ``seq1`` over the data and model axes with 1 row
    at per-row positions. The decode steps cross from one rank's positions
    into the next.

Every step's logits are held to the other sides' within ``REL`` of the
largest logit of the step (fp32 sums over the shards reassociate), and the
greedy picks are equal.
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
from _torch_dist_jobs import _fp32, run_job
from _torch_tp_jobs import N_NEW, ODD_ARCHS, SEQ_ARCHS, TP_ARCHS, arch_config

from repro_torch import tree as tree_util
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("1x2x2", "2x2x1")
SEQ_LAYOUTS = ("seq2", "seq1")
#: the reference's child of the configs cut to 3 heads (`_torch_tp_ref.py`)
ODD = "odd"
REL = 1e-5
#: the rank job is killed when no part finishes for STALL_S seconds, every
#: process after LIMIT_S in all: the fixture takes ~45 s alone and took
#: 202 s beside the other five workers of the whole suite's `-n 6` run
STALL_S = 300
LIMIT_S = 1200


@pytest.fixture(scope="module")
def jobs():
    tmp = tempfile.mkdtemp()
    for arch in list(dict.fromkeys(TP_ARCHS + SEQ_ARCHS)) + [f"odd_{a}" for a in ODD_ARCHS]:
        tree = tree_util.map_tree(lambda _, x: x.numpy(),
                                  Model(arch_config(arch), device="cpu").params)
        with open(os.path.join(tmp, f"{arch}.pkl"), "wb") as f:
            pickle.dump(tree, f)
    archs = {ODD: ODD_ARCHS, **{m: SEQ_ARCHS for m in SEQ_LAYOUTS}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_tp_ref.py"), tmp,
         os.path.join(tmp, f"ref_{m}.npz"),
         ",".join(f"{a}:{m}" for a in archs.get(m, TP_ARCHS))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        for m in MESHES + SEQ_LAYOUTS + (ODD,)}
    deadline = time.monotonic() + LIMIT_S
    old = os.environ.get("TP_WEIGHTS")
    os.environ["TP_WEIGHTS"] = tmp
    try:
        ranks = run_job("tp_job", world=4, timeout=LIMIT_S, stall=STALL_S,
                        module="_torch_tp_jobs")
    finally:
        if old is None:
            os.environ.pop("TP_WEIGHTS", None)
        else:
            os.environ["TP_WEIGHTS"] = old
    ref, status = {}, {}
    for m, p in refs.items():
        try:
            stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            p.kill()
        assert p.returncode == 0, f"reference failed:\n{stderr[-3000:]}"
        status.update(json.loads(stdout.strip().splitlines()[-1]))
        with np.load(os.path.join(tmp, f"ref_{m}.npz")) as z:
            ref.update({k: z[k] for k in z.files})
    return {"ranks": ranks, "ref": ref, "status": status}


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), result.get("error")
    return result


def _close(got, want):
    """Each step's logits within `REL` of the step's largest logit."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        assert float(np.abs(g - w).max()) <= REL * float(np.abs(w).max()), i


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_steps_match_one_device_port(jobs, arch, mesh):
    """Prefill and four greedy decode steps: every rank's logits (put
    together) within REL of the one-device port's, the greedy picks equal;
    on ``(1, 2, 2)`` the logits leave as each rank's rows and vocab
    columns."""
    for out in jobs["ranks"]:
        r = _ok(out[f"serve:{arch}:{mesh}"])
        assert len(r["logits"]) == N_NEW + 1
        _close(r["logits"], r["one_logits"])
        assert np.array_equal(r["picks"], r["one_picks"])
    placements = {"1x2x2": "(Replicate(), Shard(dim=0), Shard(dim=1))",
                  "2x2x1": "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"}[mesh]
    assert r["logits_placements"] == placements


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_steps_match_reference_builders(jobs, arch, mesh):
    """The same steps against the reference's `jit_prefill` and
    `jit_decode_step` on four devices of that mesh, fed their own greedy
    picks: logits within REL, picks equal."""
    st = jobs["status"][f"{arch}:{mesh}"]
    assert st["status"] == "ok", st.get("trace")
    want = [jobs["ref"][f"{arch}:{mesh}:{i}"] for i in range(N_NEW + 1)]
    r = _ok(jobs["ranks"][0][f"serve:{arch}:{mesh}"])
    _close(r["logits"], want)
    V = _fp32(arch).vocab_size
    assert np.array_equal(r["picks"], np.stack([w[:, :V].argmax(-1) for w in want], 1))


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


def _group_layers(cfg, step: str) -> dict:
    """How many sub-layers of each group name a ``step`` ("prefill" or
    "decode") runs: an enc-dec model's encoder runs in the prefill alone."""
    if cfg.encdec is not None:
        enc = cfg.encdec.num_encoder_layers if step == "prefill" else 0
        return {g: enc if g.startswith("enc_") else cfg.num_layers
                for g in GROUPS["whisper_large_v3"]}
    per_layer = {"ssm": 0, "attn": 0, "mla": 0, "mlp": 0, "moe": 0}
    from repro_torch.models.lm import layer_kinds, n_scan_steps
    for mixer, f in layer_kinds(cfg):
        per_layer[mixer] += n_scan_steps(cfg)
        if f != "none":
            per_layer[f] += n_scan_steps(cfg)
    return dict(per_layer, attn_kv=per_layer["attn"], experts=per_layer["moe"],
                shared=per_layer["moe"])


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_every_dividing_dim_ran_local(jobs, arch):
    """On ``(1, 2, 2)`` every group of the config (and the vocab) ran on its
    model-axis shard, in the prefill and in every decode step, none
    gathered (Whisper: its encoder's attention and MLP in the prefill, its
    decoder's self-attention, cross-attention and MLP in every step); on
    ``(2, 2, 1)``, a model axis of one rank, nothing is counted."""
    cfg = _fp32(arch)
    want = {}
    for step in ("prefill", "decode"):
        n = _group_layers(cfg, step)
        want[step] = {"vocab:local": 1, **{f"{g}:local": n[g] for g in GROUPS[arch] if n[g]}}
        want[step]["tp_local"] = sum(want[step].values())
    for out in jobs["ranks"]:
        counts = _ok(out[f"serve:{arch}:1x2x2"])["counts"]
        assert counts["prefill"] == want["prefill"]
        assert counts["decode"] == [want["decode"]] * N_NEW
        assert _ok(out[f"serve:{arch}:2x2x1"])["counts"] == {"prefill": {},
                                                             "decode": [{}] * N_NEW}


def _odd_part(arch: str) -> str:
    return "odd" if arch == "minitron_4b" else f"odd:{arch}"


@pytest.mark.parametrize("arch", ["minitron_4b", "minicpm3_4b"])
def test_heads_that_do_not_divide_run_padded(jobs, arch):
    """Minitron cut to 3 q heads over 1 K/V head, MiniCPM3 to 3 MLA heads,
    on the model axis of 2: attention runs on each rank's 2 padded head
    slots (rank 1's second slot padding) and is counted so, K/V computed
    whole and read by each slot's index, the MLP and the vocab on their
    shards; the logits and picks are the one-device port's."""
    L = _fp32(arch).num_layers
    mixer = {"minitron_4b": {"attn:padded": L, "attn_kv:padded": L},
             "minicpm3_4b": {"mla:padded": L}}[arch]
    want = {"vocab:local": 1, "mlp:local": L, "tp_local": 1 + L, **mixer,
            "tp_padded": sum(mixer.values())}
    for out in jobs["ranks"]:
        r = _ok(out[_odd_part(arch)])
        assert r["counts"]["prefill"] == want
        assert r["counts"]["decode"] == [want] * N_NEW
        _close(r["logits"], r["one_logits"])
        assert np.array_equal(r["picks"], r["one_picks"])


def test_whisper_heads_that_do_not_divide_run_padded(jobs):
    """Whisper cut to 3 heads on the model axis of 2: the encoder's
    attention and the decoder's self- and cross-attention run on each
    rank's padded head slots and are counted so (the cross cache whole over
    the heads), the MLPs and the vocab on their shards; the logits and
    picks are the one-device port's."""
    cfg = _fp32("whisper_large_v3")
    L, L_enc = cfg.num_layers, cfg.encdec.num_encoder_layers
    dec = {"vocab:local": 1, "dec_mlp:local": L,
           **{f"{a}:padded": L for a in ("self_attn", "self_attn_kv", "cross_attn",
                                         "cross_attn_kv")}}
    pre = dict(dec, **{"enc_attn:padded": L_enc, "enc_attn_kv:padded": L_enc,
                       "enc_mlp:local": L_enc})
    for want in (dec, pre):
        want["tp_local"] = sum(n for k, n in want.items() if k.endswith(":local"))
        want["tp_padded"] = sum(n for k, n in want.items() if k.endswith(":padded"))
    for out in jobs["ranks"]:
        r = _ok(out["odd:whisper_large_v3"])
        assert r["counts"]["prefill"] == pre
        assert r["counts"]["decode"] == [dec] * N_NEW
        _close(r["logits"], r["one_logits"])
        assert np.array_equal(r["picks"], r["one_picks"])


@pytest.mark.parametrize("arch", ODD_ARCHS)
def test_padded_heads_match_reference_builders(jobs, arch):
    """The configs cut to 3 heads against the reference's `jit_prefill` and
    `jit_decode_step` on ``(1, 2, 2)``, whose partitioner pads the heads
    over the model axis of 2, fed their own greedy picks: logits within
    REL, picks equal."""
    st = jobs["status"][f"{arch}:{ODD}"]
    assert st["status"] == "ok", st.get("trace")
    want = [jobs["ref"][f"{arch}:{ODD}:{i}"] for i in range(N_NEW + 1)]
    r = _ok(jobs["ranks"][0][_odd_part(arch)])
    _close(r["logits"], want)
    V = _fp32(arch).vocab_size
    assert np.array_equal(r["picks"], np.stack([w[:, :V].argmax(-1) for w in want], 1))


def test_gated_norm_takes_the_global_mean(jobs):
    """The SSM block's gated norm on each rank's half of a row: the mean of
    squares is the whole row's (summed over the model axis), equal to the
    one-device norm; the halves normed by their own means would be far
    off."""
    for out in jobs["ranks"]:
        r = _ok(out["norm"])
        assert r["tp"] == 2
        assert r["err"] <= 1e-6 * r["scale"]
        assert r["local_mean_err"] > 0.1 * r["scale"]


def test_vocab_argmax_takes_the_lowest_index(jobs):
    """The greedy pick across vocab shards: on ties (within a shard, across
    shards, at their border, a constant row) the lowest index wins, as
    ``torch.argmax`` of the whole row; equal on every rank."""
    for out in jobs["ranks"]:
        r = _ok(out["tie"])
        assert r["tp"] == 2
        assert r["got"] == r["want"] == [3, 9, 13, 0, 7]


# ---------------------------------------------------------------------------
# decode over a sequence-sharded cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", SEQ_LAYOUTS)
@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_decode_matches_one_device_port(jobs, arch, layout):
    """Prefill, then four greedy decode steps that each rank attends over
    its own positions of the cache (``seq2``: the model axis's two pieces;
    ``seq1``: the data and model axes' four, at per-row positions): every
    step's logits on every rank within REL of the one-device port's, the
    picks equal."""
    for out in jobs["ranks"]:
        r = _ok(out[f"seq:{arch}:{layout}"])
        assert len(r["logits"]) == N_NEW + 1
        _close(r["logits"], r["one_logits"])
        assert np.array_equal(r["picks"], r["one_picks"])


@pytest.mark.parametrize("layout", SEQ_LAYOUTS)
@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_decode_matches_reference_builders(jobs, arch, layout):
    """The same steps against the reference's `jit_prefill` and
    `jit_decode_step` under the same plan on four devices (its partitioner
    inserts the softmax's reductions over the sequence axes), fed their own
    greedy picks: logits within REL, picks equal. Whisper's self/cross
    cache tree goes through the reference's builders too."""
    st = jobs["status"][f"{arch}:{layout}"]
    assert st["status"] == "ok", st.get("trace")
    want = [jobs["ref"][f"{arch}:{layout}:{i}"] for i in range(N_NEW + 1)]
    r = _ok(jobs["ranks"][0][f"seq:{arch}:{layout}"])
    _close(r["logits"], want)
    V = _fp32(arch).vocab_size
    assert np.array_equal(r["picks"], np.stack([w[:, :V].argmax(-1) for w in want], 1))


def _gathers_sequence(shape, leaf) -> bool:
    """Whether a collective that sends ``shape`` moves a piece of cache
    leaf ``leaf``'s sequence: a tensor of the leaf's rank with its layers
    and trailing dims, and a part of its sequence (what DTensor sends to
    gather a sequence shard)."""
    return (shape is not None and len(shape) == len(leaf) and shape[0] == leaf[0]
            and tuple(shape[3:]) == tuple(leaf[3:]) and shape[2] < leaf[2])


@pytest.mark.parametrize("layout", SEQ_LAYOUTS)
@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_seq_decode_keeps_the_sequence_local(jobs, arch, layout):
    """Each decode step counts every attention sub-layer as run over the
    rank's own positions (``attn:seq_local``, MLA's ``mla:seq_local``), the
    prefill none; the traced first decode step issues no all-gather of a
    K/V or latent leaf's sequence (its all-reduces combine the softmax)."""
    from repro_torch.models.lm import layer_kinds, n_scan_steps
    cfg = _fp32(arch)
    if cfg.encdec is not None:
        want = {"attn:seq_local": cfg.num_layers}
    else:
        mixers = [m for m, _ in layer_kinds(cfg)]
        want = {f"{m}:seq_local": mixers.count(m) * n_scan_steps(cfg)
                for m in ("attn", "mla") if m in mixers}
    for out in jobs["ranks"]:
        r = _ok(out[f"seq:{arch}:{layout}"])
        assert not any(k.endswith(":seq_local") for k in r["counts"]["prefill"])
        for step in r["counts"]["decode"]:
            assert {k: v for k, v in step.items() if k.endswith(":seq_local")} == want
        gathers = [shape for op, shape in r["collectives"] if "gather" in op]
        assert any("all_reduce" in op for op, _ in r["collectives"])
        for leaf in r["seq_leaves"].values():
            assert not [g for g in gathers if _gathers_sequence(g, leaf)], (leaf, gathers)


def test_seq_decode_over_an_fp8_cache(jobs):
    """``seq2`` for Qwen1.5-MoE with the cache in ``float8_e4m3fn`` on both
    sides: each rank casts its new entries on write and upcasts its piece
    for the math, and no cache leaf crosses the mesh (gloo carries no fp8
    tensor): logits within REL of the one-device fp8 decode's, picks
    equal."""
    for out in jobs["ranks"]:
        r = _ok(out["seqfp8:qwen2_moe_a2_7b:seq2"])
        _close(r["logits"], r["one_logits"])
        assert np.array_equal(r["picks"], r["one_picks"])
