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
    K/V head, which do not divide the model axis: attention runs gathered,
    the MLP and the vocab on their shards;
  * ``norm``: the SSM block's gated norm on each rank's half of a row whose
    halves differ a hundredfold, against the whole row's;
  * ``tie``: `ctx.tp_argmax` on vocab shards with ties within and across
    them, against ``torch.argmax`` of the whole rows.

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
            "qwen2_vl_2b")
B, S_PROMPT, N_NEW = 4, 8, 4


def prompt_batch(cfg) -> dict:
    """The prompts both packages serve: ``B`` rows of ``S_PROMPT`` tokens
    (seeded), and an M-RoPE model's text positions on its three streams."""
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(2, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32)}
    if cfg.pos_type == "mrope":
        batch["positions"] = np.broadcast_to(np.arange(S_PROMPT, dtype=np.int32),
                                             (3, B, S_PROMPT)).copy()
    return batch


def _parts():
    spec = os.environ.get("TP_PARTS")
    if spec:
        return [tuple(p.split(":")) for p in spec.split(",")]
    return ([("serve", a, m) for a in TP_ARCHS for m in ("1x2x2", "2x2x1")]
            + [("odd",), ("norm",), ("tie",)])


def tp_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    for part in _parts():
        if part[0] == "serve":
            _part(out, ":".join(part), _serve_part, part[1], *meshes[part[2]])
        elif part[0] == "odd":
            cfg = dataclasses.replace(_fp32("minitron_4b"), num_heads=3, num_kv_heads=1)
            _part(out, "odd", _serve_part, cfg, *meshes["1x2x2"])
        else:
            _part(out, part[0], {"norm": _norm_part, "tie": _tie_part}[part[0]],
                  *meshes["1x2x2"])
    return out


def _model(cfg, arch):
    """The port's model of ``cfg`` over the weights the test module wrote
    for ``arch`` (the seeded init where there are none)."""
    import pickle

    from repro_torch import bridge
    from repro_torch.models import Model
    path = os.path.join(os.environ.get("TP_WEIGHTS", ""), f"{arch}.pkl")
    if arch is None or not os.path.exists(path):
        return Model(cfg, device="cpu")
    with open(path, "rb") as f:
        return Model(cfg, bridge.params_from_numpy(cfg, pickle.load(f), device="cpu"),
                     device="cpu")


def _serve_part(arch, mesh, plan):
    """Prefill and ``N_NEW`` greedy decode steps, sharded and on one
    device, from the same prompts. Returns every step's logits (rank 0's
    view of the whole), the picks, and the counts of the sharded steps."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, jit_prefill, named
    from repro_torch.models.lm import is_positional
    from repro_torch.sharding import ctx, param_specs
    cfg = _fp32(arch) if isinstance(arch, str) else arch
    model = _model(cfg, arch if isinstance(arch, str) else None)
    batch = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg).items()}
    s_max = S_PROMPT + N_NEW + 1
    V = cfg.vocab_size

    def into(cache):
        out = model.init_cache(B, s_max, dtype=torch.float32)
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
            logits, cache = decode(tok[:, None], cache, torch.tensor(S_PROMPT + i))
            steps.append(_full(logits))
        picks.append(steps[-1][:, :V].argmax(-1).to(torch.int32))
        return [s.float().numpy() for s in steps], torch.stack(picks, 1).numpy()

    with torch.no_grad():
        one_logits, one_picks = greedy(
            lambda: (lambda lc: (lc[0], into(lc[1])))(model.prefill(batch)),
            model.decode_step)
    prefill = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", S_PROMPT, B))
    decode = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, B))
    params = ctx.place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    ctx.reset_tp_counts()
    counts = {}

    def sharded_prefill():
        out = prefill(params, batch)
        counts["prefill"] = ctx.tp_counts()
        ctx.reset_tp_counts()
        return out[0], into({k: _full(v) for k, v in out[1].items()})

    def sharded_decode(tok, cache, pos):
        logits, cache = decode(params, tok, cache, pos)
        counts.setdefault("decode", []).append(ctx.tp_counts())
        ctx.reset_tp_counts()
        return logits, cache

    tp_logits, tp_picks = greedy(sharded_prefill, sharded_decode)
    return {"logits": tp_logits, "picks": tp_picks, "one_logits": one_logits,
            "one_picks": one_picks, "counts": counts,
            "logits_placements": str(prefill(params, batch)[0].placements)}


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
