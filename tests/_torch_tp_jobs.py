"""The job `tests/test_torch_tp_serving.py` runs on a 4-rank gloo mesh on the
CPU (`_torch_dist_jobs.run_job` with ``module="_torch_tp_jobs"``), one
spawned process per rank. Nothing here imports JAX.

  * ``serve``: `jit_prefill` and four `jit_decode_step`s of a reduced fp32
    config on ``(1, 2, 2)`` under `default_plan()` (tensor-parallel over the
    model axis of 2) or ``(2, 2, 1)`` under `default_plan(multi_pod=True)`
    (a model axis of 1), from the weights the test module wrote, beside the
    one-device port's prefill and decode: every step's logits, the greedy
    picks and the tensor-parallel counts (`ctx.tp_counts`);
  * ``odd``: the same on ``(1, 2, 2)`` for Minitron cut to 3 q heads over 1
    K/V head, which do not divide the model axis: attention runs padded (4
    head slots, 2 a rank, the last one padding), the MLP and the vocab on
    their shards; ``odd:minicpm3_4b`` for MiniCPM3 cut to 3 MLA heads;
    ``odd:whisper_large_v3`` for Whisper cut to 3 heads of 16 (the
    encoder's attention, the decoder's self- and cross-attention padded);
    each from the weights the test module wrote for the cut config
    (`odd_config`, ``odd_<arch>.pkl``);
  * ``norm``: the SSM block's gated norm on each rank's half of a row whose
    halves differ a hundredfold, against the whole row's;
  * ``tie``: `ctx.tp_argmax` on vocab shards with ties within and across
    them, against ``torch.argmax`` of the whole rows;
  * ``seq``: the decode step over a sequence-sharded cache (`ctx.seq_axes`)
    on ``(1, 2, 2)``, for `SEQ_ARCHS`: layout ``seq2`` under
    `default_plan().with_(seq_axis="model")` with `SEQ_ROWS` rows (the
    model axis cuts both the heads and the sequence), layout ``seq1`` under
    ``seq_axis=("data", "model")`` with one row at per-row positions (each
    rank a quarter of the sequence); Minitron with ``shard_attn_heads``
    off, so that its attention runs gathered. `SEQ_PROMPT` and `SEQ_S_MAX`
    put the decode steps across a boundary between two ranks' positions.
    Besides the logits, picks and counts, the collectives of the first
    decode step (`serving.engine.trace_collectives`);
  * ``seqfp8``: ``seq2`` for Qwen1.5-MoE with the cache in
    ``float8_e4m3fn`` on both sides (gloo carries no fp8 tensor: the step
    moves no cache leaf).

To debug a part alone: ``DIST_JOB_TRACE=1`` prints each part as a rank
enters it, and ``TP_PARTS=serve:jamba_v0_1_52b:1x2x2,tie`` picks the parts.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from _torch_dist_jobs import _fp32, _full, _meshes, _part

TP_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m", "jamba_v0_1_52b", "minicpm3_4b",
            "qwen2_vl_2b", "whisper_large_v3")
B, S_PROMPT, N_NEW = 4, 8, 4
SEQ_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "minicpm3_4b", "jamba_v0_1_52b",
             "whisper_large_v3")
#: the sequence-sharded decode: a prompt of 4 in a cache of 12 positions,
#: whose 4 decode steps write positions 4-7: across the boundary at 6 of
#: the two pieces of ``seq2``, and of 3 to 6 of the four of ``seq1``, whose
#: last piece no step reaches (all masked). The prompt divides the pieces,
#: as the reference's prefill shards the cache it returns.
SEQ_ROWS, SEQ_PROMPT, SEQ_S_MAX = 2, 4, 12
#: the configs cut to 3 heads, which do not divide a model axis of 2
ODD_ARCHS = ("minitron_4b", "minicpm3_4b", "whisper_large_v3")


def odd_config(cfg, arch: str):
    """``cfg`` (either package's reduced config of ``arch``) cut to 3
    attention heads: Minitron's over 1 K/V head, MiniCPM3's MLA heads, and
    Whisper's 3 heads of 16 (its d_model of 64 over 3 would leave
    projections of 63 columns, which the model axis cannot split)."""
    cut = {"minitron_4b": {"num_kv_heads": 1}, "minicpm3_4b": {"num_kv_heads": 3},
           "whisper_large_v3": {"num_kv_heads": 3, "head_dim": 16}}[arch]
    return dataclasses.replace(cfg, num_heads=3, **cut)


def prompt_batch(cfg, rows: int = B, s_prompt: int = S_PROMPT) -> dict:
    """The prompts both packages serve: ``rows`` rows of ``s_prompt``
    tokens (seeded), an M-RoPE model's text positions on its three streams,
    an enc-dec model's frames (seeded)."""
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, size=(rows, s_prompt)).astype(np.int32)}
    if cfg.pos_type == "mrope":
        batch["positions"] = np.broadcast_to(np.arange(s_prompt, dtype=np.int32),
                                             (3, rows, s_prompt)).copy()
    if cfg.encdec is not None:
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def seq_plan(arch: str, layout: str, default_plan):
    """The plan of a ``seq`` part from ``default_plan`` (either package's):
    ``seq2`` shards the cache's sequence over the model axis, ``seq1`` over
    the data and model axes; Minitron's attention heads unsharded."""
    plan = default_plan().with_(seq_axis="model" if layout == "seq2" else ("data", "model"))
    return plan.with_(shard_attn_heads=False) if arch == "minitron_4b" else plan


def _parts():
    spec = os.environ.get("TP_PARTS")
    if spec:
        return [tuple(p.split(":")) for p in spec.split(",")]
    return ([("serve", a, m) for a in TP_ARCHS for m in ("1x2x2", "2x2x1")]
            + [("odd",), ("odd", "minicpm3_4b"), ("odd", "whisper_large_v3"), ("norm",),
               ("tie",)]
            + [("seq", a, lay) for a in SEQ_ARCHS for lay in ("seq2", "seq1")]
            + [("seqfp8", "qwen2_moe_a2_7b", "seq2")])


def tp_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    for part in _parts():
        if part[0] == "serve":
            _part(out, ":".join(part), _serve_part, part[1], *meshes[part[2]])
        elif part[0] in ("seq", "seqfp8"):
            mesh = meshes["1x2x2"][0]
            rows = SEQ_ROWS if part[2] == "seq2" else 1
            from repro_torch.sharding import default_plan
            _part(out, ":".join(part), _serve_part, part[1], mesh,
                  seq_plan(part[1], part[2], default_plan), rows, SEQ_PROMPT, SEQ_S_MAX,
                  part[2] == "seq1", True,
                  torch.float8_e4m3fn if part[0] == "seqfp8" else torch.float32)
        elif part[0] == "odd":
            arch = part[1] if len(part) > 1 else "minitron_4b"
            _part(out, ":".join(part), _serve_part, f"odd_{arch}", *meshes["1x2x2"])
        else:
            _part(out, part[0], {"norm": _norm_part, "tie": _tie_part}[part[0]],
                  *meshes["1x2x2"])
    return out


def arch_config(arch: str):
    """The reduced fp32 config of ``arch``, or of ``odd_<arch>`` cut to 3
    heads (`odd_config`)."""
    if arch.startswith("odd_"):
        return odd_config(_fp32(arch[4:]), arch[4:])
    return _fp32(arch)


def _model(cfg, arch):
    """The port's model of ``cfg`` over the weights the test module wrote
    for ``arch`` (the seeded init where there are none)."""
    import pickle

    from repro_torch import bridge
    from repro_torch.models import Model
    path = os.path.join(os.environ.get("TP_WEIGHTS", ""), f"{arch}.pkl")
    if not os.path.exists(path):
        return Model(cfg, device="cpu")
    with open(path, "rb") as f:
        return Model(cfg, bridge.params_from_numpy(cfg, pickle.load(f), device="cpu"),
                     device="cpu")


def _serve_part(arch, mesh, plan, rows=B, s_prompt=S_PROMPT, s_max=S_PROMPT + N_NEW + 1,
                per_row=False, trace=False, cache_dtype=torch.float32):
    """Prefill and ``N_NEW`` greedy decode steps, sharded and on one
    device, from the same prompts (``rows`` of ``s_prompt`` tokens, a cache
    of ``s_max`` positions; ``per_row``: each step's position as a ``(B,)``
    tensor). Returns every step's logits (rank 0's view of the whole), the
    picks, and the counts of the sharded steps; ``trace``: also the
    collectives of the first sharded decode step (op and shape sent) and
    the shapes of the cache leaves with a sequence. ``cache_dtype``: the
    decode cache's dtype on both sides."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, jit_prefill, named
    from repro_torch.models.lm import is_positional
    from repro_torch.serving.engine import trace_collectives
    from repro_torch.sharding import ctx, param_specs
    cfg = arch_config(arch)
    model = _model(cfg, arch)
    batch = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg, rows, s_prompt).items()}
    B = rows
    V = cfg.vocab_size

    def into(cache):
        out = model.init_cache(B, s_max, dtype=cache_dtype)
        for k, v in cache.items():
            if is_positional(k):
                out[k][:, :, :v.shape[2]] = v
            else:
                out[k].copy_(v)
        return out

    def greedy(prefill, decode):
        logits, cache = prefill()
        steps, picks = [_full(logits)], []
        for i in range(N_NEW):
            tok = steps[-1][:, :V].argmax(-1).to(torch.int32)
            picks.append(tok)
            pos = torch.tensor(s_prompt + i)
            logits, cache = decode(tok[:, None], cache, pos.expand(B).clone() if per_row else pos)
            steps.append(_full(logits))
        picks.append(steps[-1][:, :V].argmax(-1).to(torch.int32))
        return [s.float().numpy() for s in steps], torch.stack(picks, 1).numpy()

    with torch.no_grad():
        one_logits, one_picks = greedy(
            lambda: (lambda lc: (lc[0], into(lc[1])))(model.prefill(batch)),
            model.decode_step)
    prefill = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", s_prompt, B))
    decode = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, B))
    params = ctx.place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    ctx.reset_tp_counts()
    counts = {}

    def sharded_prefill():
        out = prefill(params, batch)
        counts["prefill"] = ctx.tp_counts()
        ctx.reset_tp_counts()
        return out[0], into({k: _full(v) for k, v in out[1].items()})

    traced = {}

    def sharded_decode(tok, cache, pos):
        if trace and "colls" not in traced:
            snap = {k: v.clone() for k, v in cache.items()}
            traced["colls"] = [(c.op, c.shape) for c in trace_collectives(
                lambda: decode(params, tok, snap, pos), torch.device("cpu"))]
            ctx.reset_tp_counts()
        logits, cache = decode(params, tok, cache, pos)
        counts.setdefault("decode", []).append(ctx.tp_counts())
        ctx.reset_tp_counts()
        return logits, cache

    tp_logits, tp_picks = greedy(sharded_prefill, sharded_decode)
    out = {"logits": tp_logits, "picks": tp_picks, "one_logits": one_logits,
           "one_picks": one_picks, "counts": counts,
           "logits_placements": str(prefill(params, batch)[0].placements)}
    if trace:
        out["collectives"] = traced["colls"]
        out["seq_leaves"] = {k: tuple(v) for k, v in model.cache_shapes(B, s_max).items()
                             if is_positional(k) and not k.startswith("cross/")}
    return out


def _norm_part(mesh, plan):
    """`ssm.gated_rmsnorm_shard` on each rank's half of rows whose halves
    differ a hundredfold, put together, against `gated_rmsnorm` of the
    whole rows; and the same halves normed by their own mean (what a rank
    would get without the sum over the axis)."""
    from repro_torch.models.common import gated_rmsnorm
    from repro_torch.models.ssm import gated_rmsnorm_shard
    from repro_torch.sharding import ctx
    g = torch.Generator().manual_seed(3)
    width = 64
    x = torch.randn((2, 3, width), generator=g)
    x[..., width // 2:] *= 100.0
    z = torch.randn((2, 3, width), generator=g)
    scale = torch.rand(width, generator=g) + 0.5
    whole = gated_rmsnorm(x, z, scale, 1e-5)
    with ctx.activation_sharding(mesh, plan, tensor_parallel=True):
        n, r = ctx.tp()
        cut = slice(r * width // n, (r + 1) * width // n)
        mine = gated_rmsnorm_shard(x[..., cut], z[..., cut], scale[cut], 1e-5, width)
        got = ctx.tp_gather(mine, 2)
    alone = torch.cat([gated_rmsnorm(x[..., c], z[..., c], scale[c], 1e-5)
                       for c in (slice(0, width // 2), slice(width // 2, width))], dim=-1)
    return {"tp": n, "err": float((got - whole).abs().max()),
            "scale": float(whole.abs().max()),
            "local_mean_err": float((alone - whole).abs().max())}


def _tie_part(mesh, plan):
    """`ctx.tp_argmax` over the model axis's two vocab shards of 8 columns:
    a tie across the shards (the lower one on rank 0), a tie within rank
    1's shard, the maximum on rank 1 alone, every column equal, and a tie
    at the shards' border."""
    from repro_torch.sharding import ctx
    rows = torch.zeros((5, 16))
    rows[0, [3, 12]] = 5.0
    rows[1, [9, 14]] = 2.0
    rows[2, 13] = 1.0
    rows[4, [7, 8]] = 4.0
    with ctx.activation_sharding(mesh, plan, tensor_parallel=True):
        n, r = ctx.tp()
        w = 16 // n
        got = ctx.tp_argmax(rows[:, r * w:(r + 1) * w], r * w)
    return {"tp": n, "got": got.tolist(), "want": torch.argmax(rows, dim=-1).tolist()}
