#!/usr/bin/env python3
"""The serving engine laid out across four H100s: params and pool span the
ranks a plan resolves to.

    torchrun --nproc-per-node 4 tools/engine_ranks.py [--parts builders,seq,whisper,qwen,pod,jamba]
    torchrun --nproc-per-node 4 tools/engine_ranks.py --device cpu --reduced

One process per card (``torchrun`` gives each its rank; the group is made
over ``env://``, a localhost rendezvous). Six parts, each freeing its
models before the next:

  builders  the tensor-parallel `jit_prefill` and three greedy
         `jit_decode_step`s on the (1, 2, 2) mesh at full width in fp32, cut
         to a few layers (Qwen1.5-MoE 4, Minitron-4B 2, Mamba2-370m 4,
         MiniCPM3-4B 2; seeded weights made sharded), each held to the same
         config on rank 0's card: every step's logits within `BUILDER_REL`
         of the step's largest logit, picks equal, every group local.

  seq    decode over a sequence-sharded cache, under the plan
         `launch.dryrun.plan_for_cell` gives a decode cell (the cache's
         sequence over the model axis, which also holds the heads): first
         the builders' cases that hold K/V or a latent (`SEQ_CASES`, fp32,
         a few layers) on the (1, 2, 2) mesh, a prefill of `SEQ_S` tokens
         into `SEQ_S_MAX` positions and `SEQ_NEW` greedy steps across the
         two halves, held to rank 0's card as the builders are, each step
         counted ``seq_local``; then Qwen1.5-MoE-A2.7B whole (bf16),
         `QWEN_SEQ_B` rows in `QWEN_SEQ_S_MAX` positions, its K/V drawn from
         a seeded normal up to `QWEN_SEQ_FILL` (past the halves' boundary),
         `QWEN_SEQ_NEW` decode steps at once under the decode plan and
         under `default_plan()` (the sequence whole on each rank), fed the
         same tokens: first in fp32 over `QWEN_SEQ_B_FP32` rows, every
         step's logits within `BUILDER_REL` of the whole sequence's, picks
         equal; then in bf16, recorded: the router logits beside the whole
         sequence's up to each row's first routing split (`_held_rows`),
         each rank's peak against the dry run's prediction for the same
         step and layout (a child process), and the TPOT of each.

  whisper  Whisper-large-v3 tensor-parallel on the (1, 2, 2) mesh under
         `default_plan()` (its 20 heads, ``d_ff`` and vocab divide the model
         axis of 2: every group on its shard): `jit_prefill` of `WHISPER_B`
         prompts of `WHISPER_S` tokens over the 1500 frames, then
         `WHISPER_NEW` greedy `jit_decode_step`s, against the same steps on
         rank 0's card: first in fp32 at full width and `WHISPER_LAYERS`
         encoder and decoder layers, each side fed its own picks (every
         step's logits within `WHISPER_REL` of its largest, picks equal),
         then whole in bf16, fed one card's tokens (every step within
         `chip_smoke.py`'s bf16 `PATH_LOGITS_TOL`, a pick that differs only
         at a near-tie within the step's difference: random weights leave
         near-ties among 51,866 logits closer than a bf16 path lies to
         fp32), with both bf16 sides' distance from the same weights run in
         fp32 on rank 0; the
         prefill's flash launches on each rank (one per decoder layer, on
         the rank's 10 heads), each rank's peak in prefill and in decode
         against the dry run's prediction for the same step (a child
         process), and the TPOT of both sides.
  qwen   Qwen1.5-MoE-A2.7B at full width (bf16, random weights from seed 0)
         on the (1, 2, 2) mesh under `default_plan()`: the serve cell of
         `chip_smoke.py` (8 slots, s_max 512, pages of 16, its 8 prompts x 16
         new tokens) on an engine whose DTensor params and page pool span the
         four ranks, held to rank 0's unsharded one-card engine: every
         prefill's and decode step's logits within `chip_smoke.py`'s bf16
         `PATH_LOGITS_TOL`, a pick that differs only at a near-tie within it,
         the one-card token fed back so later steps stay comparable (the
         sharded decode runs other GEMM row counts, so bf16 may round
         otherwise); TTFT, TPOT and each rank's peak memory.
  pod    the paper's step on the (2, 2, 1) mesh under
         `default_plan(multi_pod=True)`: the same requests on a
         `ServingCluster`; after step 2 the intent "PHI traffic must stay
         inside pod 0." goes through `core.Orchestrator.submit(apply_to=
         cluster)`, which swaps the engine from the 4 ranks to pod 0's 2
         (sharded PREPARE on its own process groups, then the blocking swap)
         with requests resident, and after step 6 it swaps back to all four;
         prepare_s, downtime_s (beside the paper's 50 ms, as measured),
         migrated bytes, executables and pauses of each swap; the validator
         passes the pinned plan; the streams held to the one-card engine as
         above.
  jamba  Jamba-v0.1 on the (1, 2, 2) mesh, slot pool (4 slots, s_max 1024),
         `chip_smoke.py`'s SSM prompts (17 .. 1000) x 16 new: at 16 of its
         32 layers held to the same config served on rank 0's card as
         above; then whole, 32 layers (~26 GB of params a rank, made
         sharded: no card holds the model): flash 4, MoE top-k 16 and the
         SSD scan 28 launches per prefill on each rank, each rank's peak
         under 80 GB, TTFT and TPOT.

On (1, 2, 2) the plan's model axis of 2 runs prefill and decode
tensor-parallel (`models/lm.py::tp_groups`): each rank computes on its
half of the heads, ``d_ff`` columns, experts, SSM heads and vocab, the
partial outputs summed over the axis; the engine's ``decode_stats`` count
the sub-layers that ran on their shard (``tp_local``) and those gathered
whole (``tp_gathered``, none for these models: every such dim divides 2),
and the run fails if a step on that mesh ran none local. On (2, 2, 1) the
model axis has one rank and nothing is counted.

Decode across ranks runs eagerly by design (`serving/engine.py`). Any
failed check, collective or launch ends the run non-zero (``torchrun`` then
stops every rank). Rank 0 prints the results and writes
``engine_ranks.json`` beside `chip_smoke.py`'s output. ``--device cpu --reduced`` runs the same
parts over gloo at the reduced fp32 configs (no launch counts, no memory
peaks on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

QWEN_KW = dict(n_slots=8, s_max=512, page_size=16, watermark=3)   # 260 pages: 4 | 260
JAMBA_KW = dict(n_slots=4, s_max=1024)
INTENT = "PHI traffic must stay inside pod 0."
POD_SWAPS = (2, 6)      # steps after which the intent swaps to pod 0, and back
PAPER_DOWNTIME_S = 0.05
# Jamba-v0.1 whole, counted by hand as `chip_smoke.PREFILL_LAUNCHES` counts
# its 16 layers: per period of 8, 1 attention, 4 MoE and 7 Mamba layers
cs.PREFILL_LAUNCHES[("jamba-v0.1-52b", 32)] = (4, 16, 28)
CARD_BYTES = 80e9
#: the builders part: (arch, layers) at full width in fp32, and how far a
#: step's logits may be from one card's, relative to its largest logit
#: (fp32 sums over the shards reassociate; no tf32)
BUILDER_CASES = (("qwen2_moe_a2_7b", 4), ("minitron_4b", 2), ("mamba2_370m", 4),
                 ("minicpm3_4b", 2))
BUILDER_REL = 1e-4
#: the seq part's builders cases (Mamba2's cache has no sequence), and the
#: prompt, cache and steps: positions 62-65, across the halves at 64
SEQ_CASES = (("qwen2_moe_a2_7b", 4), ("minitron_4b", 2), ("minicpm3_4b", 2))
SEQ_B, SEQ_S, SEQ_S_MAX, SEQ_NEW = 4, 62, 128, 4
#: Qwen1.5-MoE-A2.7B whole over a drawn cache: rows, positions, the drawn
#: prefix (past the halves' boundary at 8,192) and the decode steps
QWEN_SEQ_B, QWEN_SEQ_S_MAX, QWEN_SEQ_FILL, QWEN_SEQ_NEW = 8, 16384, 8200, 8
#: the same in fp32 first, over fewer rows (its cache drawn whole on a card)
QWEN_SEQ_B_FP32 = 4
#: the whisper part: prompts, their tokens, the greedy decode steps, the
#: fp32 case's encoder and decoder layers and how far its logits may be from
#: one card's, relative to the step's largest logit
WHISPER_B, WHISPER_S, WHISPER_NEW, WHISPER_LAYERS = 2, 128, 8, 2
WHISPER_REL = 5e-6


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def say(msg: str) -> None:
    if rank() == 0:
        print(msg, flush=True)


def fail(cond: bool, msg: str) -> None:
    """End the run on every rank when ``cond`` is false (every rank checks
    the same verdict)."""
    if not cond:
        print(f"engine_ranks: FAIL (rank {rank()}): {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def gather(obj):
    """Every rank's ``obj``, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def bcast(obj):
    """Rank 0's ``obj`` on every rank."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Env:
    """The run's device, configs and tolerances."""

    def __init__(self, args):
        import torch
        self.cuda = args.device == "cuda"
        self.device = (torch.device("cuda", torch.cuda.current_device()) if self.cuda
                       else torch.device("cpu"))
        self.reduced = args.reduced
        self.dtype = "float32" if args.reduced else "bfloat16"
        self.tol = cs.PATH_LOGITS_TOL[self.dtype]
        self.card = args.card

    def cfg(self, arch, layers=None):
        from repro_torch.configs import get_config, get_reduced_config
        if self.reduced:
            cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                                      activ_dtype="float32")
        else:
            cfg = get_config(arch)
        return dataclasses.replace(cfg, num_layers=layers) if layers else cfg

    def sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def peak(self) -> float:
        import torch
        return torch.cuda.max_memory_allocated() / 1e9 if self.cuda else 0.0

    def reset_peak(self):
        import torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def free(self):
        import gc

        import torch
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def prompts_of(cfg, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32) for n in lens]


def oracle_run(env, cfg, lens, **kw):
    """Rank 0's unsharded one-card engine over ``lens``' prompts: each
    request's tokens and every prefill's and decode step's logits of it, by
    (rid, index), on the host."""
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine, compute_metrics
    if rank() != 0:
        return None
    model = Model(cfg, device=env.device, seed=0)
    eng = ServingEngine(model, device=env.device, **kw)
    eng.record_logits = True
    # eager decode, so each step's router is read (a replayed graph runs no
    # Python); a replay equals the eager step bit for bit (chip_smoke.py's
    # graph-vs-eager check)
    eng._capture = _eager
    reqs = [Request(i, p, max_new_tokens=cs.SERVE_NEW_TOKENS)
            for i, p in enumerate(prompts_of(cfg, lens))]
    rows, routing = {}, []
    router = Routing()
    env.sync()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    seen = set()
    while eng.queue or any(r is not None for r in eng.slot_req):
        router.take()
        eng.step()
        prefill, decode = router.take()
        admitted = [rid for rid in eng.prefill_logits if rid not in seen]
        seen.update(admitted)
        routing.append({"prefill": prefill, "decode": decode, "admitted": admitted})
        for lane, rid in eng.last_lanes:
            rows[(rid, len(reqs[rid].tokens_out) - 1)] = \
                eng.last_logits[lane, : eng.vocab].float().cpu()
    env.sync()
    router.close()
    wall = time.perf_counter() - t0
    for rid, lg in eng.prefill_logits.items():
        rows[(rid, 0)] = lg[: eng.vocab].float().cpu()
    out = {"tokens": {r.rid: list(r.tokens_out) for r in reqs}, "rows": rows,
           "routing": routing, "metrics": compute_metrics(reqs), "wall_s": wall}
    del eng, model
    env.free()
    return out


def _eager(exe):
    """A decode executable that runs its step eagerly instead of a graph."""
    exe.run = exe.forward
    return exe


class Routing:
    """Records, on this rank, each MoE layer's router logits and expert
    picks: a prefill's through the MoE top-k kernel (`kernels.ops.moe_topk`),
    a decode step's through `models.mlp.router_topk`; `take` returns and
    clears both lists."""

    def __init__(self):
        import threading

        from repro_torch.kernels import ops
        from repro_torch.models import mlp
        self._mlp, self._ops = mlp, ops
        self._orig, self._orig_kernel = mlp.router_topk, ops.moe_topk
        self.calls, self.prefill_calls = [], []
        serving = threading.current_thread()

        def recorded(m, logits, *, want_aux=True):
            out = self._orig(m, logits, want_aux=want_aux)
            if threading.current_thread() is serving:    # not PREPARE's scratch step
                self.calls.append((logits.float().cpu(), out[1].long().cpu()))
            return out

        def recorded_kernel(logits, k, **kw):
            out = self._orig_kernel(logits, k, **kw)
            if threading.current_thread() is serving:
                self.prefill_calls.append((logits.float().cpu(), out[1].long().cpu()))
            return out

        mlp.router_topk = recorded
        ops.moe_topk = recorded_kernel

    def take(self):
        out = (self.prefill_calls, self.calls)
        self.prefill_calls, self.calls = [], []
        return out

    def close(self):
        self._mlp.router_topk = self._orig
        self._ops.moe_topk = self._orig_kernel


def _whole_rows(parts):
    """Each MoE call's router logits and picks of every lane, from each
    rank's ``(lo, calls)`` over its rows (ranks that share rows give the
    same ones)."""
    parts = sorted({lo: calls for lo, calls in parts if calls}.items())
    if not parts:
        return []
    return [(__import__("torch").cat([c[i][0] for _, c in parts]),
             __import__("torch").cat([c[i][1] for _, c in parts]))
            for i in range(len(parts[0][1]))]


class Forced:
    """Holds a sharded engine to the oracle's as it serves (the checks of
    `chip_smoke.py`'s bf16 paths). After each step rank 0 compares, for
    each request admitted in it, each MoE layer's router logits of its
    prefill with the oracle's, and for every decoded lane each MoE layer's
    router logits at the same step, within `ROUTER_TOL`, up to the first
    layer whose expert picks differ for a token: there the request's
    routing splits (bf16 rounds other GEMM row counts, and a
    tensor-parallel layer's partial sums, otherwise, and a near-tie picks
    another expert), and from there on its state is another's and it is no
    longer held. Up to its split, a request's prefill and decode logits
    must be within `PATH_LOGITS_TOL` of the oracle's, and a pick that
    differs a near-tie within it. The oracle's token replaces a differing
    pick on every rank, so the next step's input is the oracle's."""

    def __init__(self, env, engine, reqs, oracle):
        self.env, self.engine, self.reqs, self.oracle = env, engine, reqs, oracle
        self.worst = self.router_worst = 0.0
        self.flips, self.splits = [], {}
        self.rows = 0
        self.k = 0
        self.seen_prefill = set()
        self.router = Routing()
        engine.record_logits = True

    def after_step(self):
        from repro_torch.sharding import ctx
        eng = self.engine
        prefill_calls, calls = self.router.take()
        lo = -1
        if eng.layout is not None and eng._is_member():
            dm = next(iter(eng.cache.values())).device_mesh
            lo = ctx.my_rows(dm, eng._row_axes(), eng.n_slots)[0]
        elif eng.layout is None:
            lo = 0
        parts = gather((lo, calls))
        fixes = []
        if rank() == 0:
            routed = _whole_rows(parts)
            want_step = self.oracle["routing"][self.k]
            want_routed = want_step["decode"]
            got = [(rid, 0, eng.prefill_logits[rid]) for rid in eng.prefill_logits
                   if rid not in self.seen_prefill]
            self.seen_prefill.update(rid for rid, _, _ in got)
            admitted = [rid for rid, _, _ in got]
            fail(admitted == want_step["admitted"],
                 f"admitted {admitted} where the one-card engine admitted "
                 f"{want_step['admitted']}")
            self._prefill_routing(admitted, prefill_calls, want_step["prefill"])
            for lane, rid in eng.last_lanes:
                idx = len(self.reqs[rid].tokens_out) - 1
                for layer, ((g_lg, g_id), (w_lg, w_id)) in enumerate(zip(routed, want_routed)):
                    if rid in self.splits:
                        break
                    self.router_worst = max(self.router_worst,
                                            float((g_lg[lane] - w_lg[lane]).abs().max()))
                    if sorted(g_id[lane].tolist()) != sorted(w_id[lane].tolist()):
                        self.splits[rid] = {"index": idx, "moe_layer": layer}
                got.append((rid, idx, eng.last_logits[lane]))
            eng.last_lanes = []
            for rid, idx, row in got:
                mine, theirs = self.reqs[rid].tokens_out[idx], self.oracle["tokens"][rid][idx]
                if mine != theirs:
                    fixes.append((rid, idx, theirs))
                if rid in self.splits and idx >= self.splits[rid]["index"]:
                    continue        # from its split on (a prefill row before it counts)
                row = row[: eng.vocab].float().cpu()
                want = self.oracle["rows"][(rid, idx)]
                self.worst = max(self.worst, float((row - want).abs().max()))
                self.rows += 1
                if mine != theirs:
                    self.flips.append({"rid": rid, "index": idx,
                                       "gap": float(want[theirs] - want[mine])})
        self.k += 1
        for rid, idx, tok in bcast(fixes):
            self.reqs[rid].tokens_out[idx] = tok

    def _prefill_routing(self, admitted, got, want):
        """Each admitted request's prefill routing, layer by layer, against
        the oracle's (one block of MoE calls per request, in admission
        order): router logits within the limit up to the first layer where
        a token's expert picks differ, the request's split (at index 0)."""
        if not admitted:
            return
        per = len(want) // len(admitted)
        fail(len(got) == len(want) and per * len(admitted) == len(want),
             f"prefill MoE calls {len(got)} where the one-card engine made {len(want)}")
        for j, rid in enumerate(admitted):
            for layer in range(per):
                (g_lg, g_id), (w_lg, w_id) = got[j * per + layer], want[j * per + layer]
                self.router_worst = max(self.router_worst, float((g_lg - w_lg).abs().max()))
                if not torch_equal_sets(g_id, w_id):
                    row = int((g_id.sort(dim=-1).values != w_id.sort(dim=-1).values)
                              .any(dim=-1).nonzero()[0])
                    top = w_lg[row].sort(descending=True).values
                    k = w_id.shape[1]
                    self.splits[rid] = {"index": 0, "moe_layer": layer, "in": "prefill",
                                        "token": row, "gap": float(top[k - 1] - top[k])}
                    break

    def verdict(self, tag):
        self.router.close()
        rtol = cs.ROUTER_TOL[self.env.dtype]
        ok = (self.worst <= self.env.tol and self.router_worst <= rtol
              and all(f["gap"] <= self.env.tol for f in self.flips))
        ok = bcast(ok)
        say(f"{tag} against the one-card engine: router logits max |diff| "
            f"{self.router_worst:.4g} (limit {rtol}) up to the routing splits "
            f"{self.splits} ({len(self.splits)} of {len(self.reqs)} requests part at a "
            f"near-tie, held no further); logits of {self.rows} prefill and decode rows "
            f"up to them max |diff| {self.worst:.4g} (limit {self.env.tol}); picks at "
            f"near-ties {self.flips}  {'ok' if ok else 'FAIL'}  [{self.env.card}]")
        fail(ok, f"{tag}: the sharded engine leaves the one-card engine")
        return {"max_abs_diff": self.worst, "router_max_abs_diff": self.router_worst,
                "rows": self.rows, "flips": self.flips, "splits": self.splits}


def torch_equal_sets(a, b) -> bool:
    """Whether every row of two ``(T, k)`` expert-id tensors picks the same
    set of experts."""
    return bool((a.sort(dim=-1).values == b.sort(dim=-1).values).all())


def serve(env, engine, submit, step, cfg, lens, oracle, hold, tag, events=None):
    """Serve ``lens``' prompts through ``submit``/``step``, ``events`` (step
    index -> callable) fired before the step; the run's metrics, held to
    rank 0's ``oracle`` when ``hold``."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, compute_metrics
    reqs = [Request(i, p, max_new_tokens=cs.SERVE_NEW_TOKENS)
            for i, p in enumerate(prompts_of(cfg, lens))]
    forced = Forced(env, engine, reqs, oracle) if hold else None
    env.sync()
    env.reset_peak()
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        submit(r)
    k = 0
    while engine.queue or any(r is not None for r in engine.slot_req):
        if events and k in events:
            events[k]()
        step()
        k += 1
        if forced is not None:
            forced.after_step()
    env.sync()
    wall = time.perf_counter() - t0
    m = compute_metrics(reqs)
    out = {"metrics": m, "wall_s": wall, "steps": k, "launches": dict(ops.LAUNCHES),
           "stats": dict(engine.decode_stats)}
    tp_axis = engine.layout["mesh"].shape.get("model", 1) if engine.layout is not None else 1
    fail(tp_axis == 1 or (engine.decode_stats["tp_local"] > 0
                          and engine.decode_stats["tp_gathered"] == 0),
         f"{tag} a tensor-parallel mesh ran its sub-layers gathered: {engine.decode_stats}")
    if forced is not None:
        out["vs_one_card"] = forced.verdict(tag)
    peaks = gather(env.peak())
    out["peak_gb_by_rank"] = peaks
    say(f"{tag} {len(reqs)} requests x {cs.SERVE_NEW_TOKENS} tokens in {wall:.2f} s, "
        f"{k} steps: TTFT mean {m['ttft_mean_s'] * 1e3:.1f} ms p99 "
        f"{m['ttft_p99_s'] * 1e3:.1f} ms, TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms p99 "
        f"{m['tpot_p99_s'] * 1e3:.2f} ms; peak memory by rank (GB) "
        f"{[round(p, 2) for p in peaks]}; decode {engine.decode_stats}  [{env.card}]")
    return out


def sharded_model(env, cfg, mesh, plan):
    """``cfg``'s seeded weights made straight into their shards under
    ``plan`` on ``mesh``."""
    from repro_torch.models import Model
    from repro_torch.sharding import plan_to_shardings
    t0 = time.perf_counter()
    shardings = plan_to_shardings(cfg, plan, mesh, n_slots=1)["params"]
    model = Model(cfg, device=env.device, seed=0, shardings=shardings)
    env.sync()
    local = sum(x.to_local().numel() * x.to_local().element_size()
                for x in cs._leaves(model.params))
    say(f"[engine ranks] {cfg.name} {cfg.num_layers} layers made sharded in "
        f"{time.perf_counter() - t0:.1f} s: {local / 1e9:.2f} GB of params on rank 0  "
        f"[{env.card}]")
    return model


def part_qwen(env, mesh_shape):
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import default_plan, rank_mesh
    tag = "[engine ranks qwen]"
    cfg = env.cfg(cs.SERVE_ARCH)
    oracle = oracle_run(env, cfg, cs.SERVE_PROMPT_LENS, **QWEN_KW)
    if rank() == 0:
        m = oracle["metrics"]
        say(f"{tag} one card (rank 0): TTFT mean {m['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{m['tpot_mean_s'] * 1e3:.2f} ms in {oracle['wall_s']:.2f} s  [{env.card}]")
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    model = sharded_model(env, cfg, mesh, default_plan())
    eng = ServingEngine(model, device=env.device, mesh=mesh, **QWEN_KW)
    out = serve(env, eng, eng.submit, eng.step, cfg, cs.SERVE_PROMPT_LENS, oracle, True,
                f"{tag} {mesh_shape}")
    out["mesh"] = mesh_shape
    del eng, model
    env.free()
    return out, oracle


def part_pod(env, mesh_shape, oracle):
    from repro_torch.core import Orchestrator
    from repro_torch.serving import ServingCluster, ServingEngine
    from repro_torch.sharding import default_plan, rank_mesh
    tag = "[engine ranks pod]"
    cfg = env.cfg(cs.SERVE_ARCH)
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    plan = default_plan(multi_pod=True)
    model = sharded_model(env, cfg, mesh, plan)
    cluster = ServingCluster(mesh, device=env.device)
    eng = ServingEngine(model, device=env.device, mesh=mesh, plan=plan, **QWEN_KW)
    cluster.register("e0", eng)
    swaps = []

    def to_pod0():
        t0 = time.perf_counter()
        res = Orchestrator().submit(INTENT, apply_to=cluster)
        fail(res.success, f"{tag} the intent did not validate: {res.report.summary()}")
        rep = res.reports["e0"]
        swaps.append(("to pod 0", rep, time.perf_counter() - t0, list(eng.ranks)))
        verdict = cluster.verify_engine_collectives("e0")
        say(f"{tag} intent {INTENT!r} -> plan pins {eng.plan.device_constraints}, forbids "
            f"{eng.plan.forbidden_collective_axes}; engine on ranks {list(eng.ranks)}; "
            f"validator: {verdict}  [{env.card}]")
        fail(verdict is not None and not cluster._entries["e0"].quarantined,
             f"{tag} the pinned plan's decode did not pass the validator")

    def back():
        t0 = time.perf_counter()
        rep = cluster.reconfigure("e0", plan)
        swaps.append(("back to all", rep, time.perf_counter() - t0, list(eng.ranks)))

    out = serve(env, eng, cluster.submit, cluster.step, cfg, cs.SERVE_PROMPT_LENS, oracle,
                True, f"{tag} {mesh_shape}",
                events={POD_SWAPS[0]: to_pod0, POD_SWAPS[1]: back})
    out["swaps"] = []
    for name, rep, call_s, members in swaps:
        downs = gather(rep.downtime_s)
        say(f"{tag} swap {name}: ranks {members}, {rep.summary()}; downtime by rank (ms) "
            f"{[round(d * 1e3, 1) for d in downs]}, max {max(downs) * 1e3:.1f} ms "
            f"({'within' if max(downs) <= PAPER_DOWNTIME_S else 'over'} the paper's 50 ms); "
            f"call {call_s:.2f} s  [{env.card}]")
        out["swaps"].append({"name": name, "ranks": members, "prepare_s": rep.prepare_s,
                             "downtime_s": rep.downtime_s, "downtime_s_by_rank": downs,
                             "migrate_bytes": rep.migrate_bytes,
                             "compiled": rep.compiled_in_prepare, "call_s": call_s})
    out["pauses"] = len(swaps)
    fail([s["ranks"] for s in out["swaps"]] == [[0, 1], list(range(int(np.prod(mesh_shape))))]
         or int(np.prod(mesh_shape)) == 1, f"{tag} the swaps did not land on pod 0 and back")
    del cluster, eng, model
    env.free()
    return out


def _held_to_one_card(env, mesh, cfg, plan, B, S, new, s_max, tag, seq_local=False):
    """``cfg``'s sharded `jit_prefill` of ``B`` seeded prompts of ``S``
    tokens and ``new`` greedy `jit_decode_step`s under ``plan`` into a cache
    of ``s_max`` positions, against the same steps of the whole model on
    rank 0's card: every step's logits within `BUILDER_REL` of the step's
    largest, picks equal, every group local (``seq_local``: and each decode
    step's attention over the rank's piece of the sequence). Ends the run
    on a failure; returns rank 0's row."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, jit_prefill
    from repro_torch.models import Model
    from repro_torch.models.lm import is_positional
    from repro_torch.sharding import ctx
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32),
                             device=env.device)
    V = cfg.vocab_size
    counts = []

    def run(model, prefill, decode):
        logits, cache = prefill({"tokens": tokens})
        full = model.init_cache(B, s_max, dtype=torch.float32)
        for k, v in cache.items():
            v = ctx.full(v)
            if is_positional(k):
                full[k][:, :, :v.shape[2]] = v
            else:
                full[k].copy_(v)
        steps = [ctx.full(logits).float().cpu()]
        for i in range(new):
            t = steps[-1][:, :V].argmax(-1).to(torch.int32).to(env.device)
            ctx.reset_tp_counts()
            logits, full = decode(t[:, None], full, torch.tensor(S + i, device=env.device))
            counts.append(ctx.tp_counts())
            steps.append(ctx.full(logits).float().cpu())
        return steps

    one = None
    if rank() == 0:
        model = Model(cfg, device=env.device, seed=0)
        with torch.no_grad():
            one = run(model, model.prefill, model.decode_step)
        del model
        env.free()
    counts.clear()
    model = sharded_model(env, cfg, mesh, plan)
    pre = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", S, B))
    dec = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, B))
    env.sync()
    t0 = time.perf_counter()
    got = run(model, lambda b: pre(model.params, b),
              lambda t, c, p: dec(model.params, t, c, p))
    env.sync()
    secs = time.perf_counter() - t0
    row, ok = None, True
    if rank() == 0:
        rel = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got, one))
        picks = all(torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1))
                    for a, b in zip(got, one))
        last = counts[-1]
        seq = sum(n for k, n in last.items() if k.endswith(":seq_local"))
        ok = rel <= BUILDER_REL and picks and not last.get("tp_gathered") and (
            mesh.shape["model"] == 1 or last.get("tp_local", 0) > 0) and (
            not seq_local or mesh.shape["model"] == 1 or seq > 0)
        row = {"layers": cfg.num_layers, "rel": rel, "picks_equal": picks,
               "counts": last, "seconds": secs}
        say(f"{tag} {cfg.name} {cfg.num_layers} layers fp32 {tuple(mesh.shape.values())}: "
            f"prefill of {S} and {new} decode steps (cache of {s_max}), logits within "
            f"{rel:.3e} of one card's (limit {BUILDER_REL}), picks equal {picks}; a decode "
            f"step's counts {last}; {secs:.2f} s  {'ok' if ok else 'FAIL'}  [{env.card}]")
    fail(bcast(ok), f"{tag} {cfg.name}: the sharded steps leave one card's")
    del model, pre, dec
    env.free()
    return row


def part_builders(env, mesh_shape):
    """The tensor-parallel builders against rank 0's card (module doc)."""
    from repro_torch.sharding import default_plan, rank_mesh
    B, S, new = 4, 64, 3
    out = {}
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    for arch, layers in BUILDER_CASES:
        cfg = dataclasses.replace(env.cfg(arch, layers), param_dtype="float32",
                                  activ_dtype="float32")
        row = _held_to_one_card(env, mesh, cfg, default_plan(), B, S, new, S + new + 1,
                                "[engine ranks builders]")
        if row is not None:
            out[arch] = row
    return out


def predict_decode(spec: str) -> dict:
    """``--predict arch:B:s_max:plan:device[:kind]``: the dry run of that
    bf16 decode step (or, with ``kind`` "prefill", the prefill of B prompts
    of ``s_max`` tokens) on a fake (1, 2, 2) world under the decode plan
    (``plan`` "seq") or `default_plan()` ("whole"): argument and peak GB a
    rank, wire GB per axis, the tensor-parallel counts."""
    import torch

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    from repro_torch.sharding import default_plan
    arch, B, s_max, which, device, *kind = spec.split(":")
    cfg = get_config(arch)
    kind = kind[0] if kind else "decode"
    cell = ShapeCell(kind[0], kind, int(s_max), int(B))
    mesh = mesh_lib.fake_mesh((1, 2, 2), ("pod", "data", "model"), device=device)
    plan = dryrun.plan_for_cell(cfg, cell, False) if which == "seq" else default_plan()
    inputs = dryrun.build_step(Model(cfg, device="meta"), cell, mesh, plan)
    rec = dryrun.record_of(dryrun.dry_run_step(inputs, mesh, torch.device(device)), cfg, cell,
                           mesh)
    return {"argument_gb": rec["memory"]["argument_bytes"] / 1e9,
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
            "wire_gb": {k: v / 1e9 for k, v in rec["collectives"]["wire_bytes_by_axis"].items()},
            "tp": rec["tp"]}


def _predicted(arch, B, s_max, which, kind="decode") -> dict:
    import subprocess
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--predict",
                           f"{arch}:{B}:{s_max}:{which}:cpu:{kind}"], capture_output=True,
                          text=True, timeout=900)
    fail(proc.returncode == 0, f"the dry run's prediction failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _drawn_cache(env, cfg, B, s_max, fill, shardings):
    """A cache of ``B`` rows and ``s_max`` positions whose K/V hold a seeded
    normal draw below position ``fill`` (zero after), placed under
    ``shardings`` one leaf at a time (each leaf drawn whole on every rank,
    the same on each, then cut to the rank's shard)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import dtype_of
    from repro_torch.sharding import ctx
    out = {}
    for i, (k, shape) in enumerate(sorted(lm.cache_shape(cfg, B, s_max).items())):
        g = torch.Generator(device=env.device).manual_seed(100 + i)
        x = torch.randn(shape, generator=g, device=env.device, dtype=dtype_of(cfg))
        x[:, :, fill:] = 0
        mine = ctx.place(x, shardings[k]).to_local().clone()   # not a view of x
        del x
        out[k] = ctx.to_dtensor(mine, shardings[k], shape)
        env.free()
    return out


def _held_rows(seq, whole, V):
    """The decode plan's steps beside the whole sequence's, row by row, as
    `Forced` holds an engine: each MoE layer's router logits up to the
    first layer where a row's expert picks differ (from there the row's
    cache, and so its state, is another's, and it is no longer compared),
    and the logits of a step whose routing did not split. Returns the worst
    router |diff| at each MoE layer over the rows held there, the worst
    logits |diff| held, the (step, row, layer, gap) of each split, and how
    many row-steps were held."""
    per_layer = [0.0] * len(whole[0]["routing"])
    worst_logits = 0.0
    splits, held, gone = [], 0, set()
    for i, (a, b) in enumerate(zip(seq, whole)):
        for row in range(b["logits"].shape[0]):
            if row in gone:
                continue
            for layer, ((ga, ia), (gb, ib)) in enumerate(zip(a["routing"], b["routing"])):
                per_layer[layer] = max(per_layer[layer],
                                       float((ga[row] - gb[row]).abs().max()))
                if not torch_equal_sets(ia[row:row + 1], ib[row:row + 1]):
                    top = gb[row].sort(descending=True).values
                    k = ib.shape[1]
                    splits.append((i, row, layer, float(top[k - 1] - top[k])))
                    gone.add(row)
                    break
            if row in gone:
                continue
            held += 1
            worst_logits = max(worst_logits, float((a["logits"][row, :V]
                                                    - b["logits"][row, :V]).abs().max()))
    return per_layer, worst_logits, splits, held


def _qwen_seq(env, mesh, dtype, B):
    """Qwen1.5-MoE-A2.7B whole in ``dtype`` over ``B`` rows of a drawn cache,
    under the decode plan and `default_plan()`, fed the same tokens (module
    doc). fp32 is held: every step's logits within `BUILDER_REL` of the
    whole sequence's largest, picks equal. bf16 is recorded, not held: its
    router logits and logits beside the whole sequence's up to each row's
    first routing split (`_held_rows`), each rank's peak beside the dry
    run's prediction, and the TPOT of each plan."""
    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import jit_decode_step, named
    from repro_torch.sharding import cache_specs, ctx, default_plan
    tag = f"[engine ranks seq qwen {dtype}]"
    cfg = env.cfg("qwen2_moe_a2_7b")
    cfg = dataclasses.replace(cfg, param_dtype=dtype, activ_dtype=dtype)
    s_max, fill, new = ((QWEN_SEQ_S_MAX, QWEN_SEQ_FILL, QWEN_SEQ_NEW)
                        if not env.reduced else (16, 9, 4))
    cell = ShapeCell("d", "decode", s_max, B)
    plans = {"whole": default_plan(), "seq": dryrun.plan_for_cell(cfg, cell, False)}
    model = sharded_model(env, cfg, mesh, plans["whole"])
    V = cfg.vocab_size
    rng = np.random.default_rng(4)
    first = rng.integers(2, V, size=(B,)).astype(np.int32)
    lo = ctx.my_rows(mesh.device_mesh(), plans["whole"].batch_axes, B)[0]
    router = Routing()
    out, feed = {}, None
    for which in ("whole", "seq"):
        plan = plans[which]
        cache = _drawn_cache(env, cfg, B, s_max, fill,
                             named(mesh, cache_specs(cfg, plan, batch=B)))
        decode = jit_decode_step(model, mesh, plan, cell)
        tok = torch.as_tensor(first, device=env.device)
        steps, secs, counts = [], [], None
        env.sync()
        env.reset_peak()
        for i in range(new):
            ctx.reset_tp_counts()
            router.take()
            env.sync()
            t0 = time.perf_counter()
            logits, cache = decode(model.params, tok[:, None], cache,
                                   torch.tensor(fill + i, device=env.device))
            env.sync()
            secs.append(time.perf_counter() - t0)
            counts = ctx.tp_counts()
            lg = ctx.full(logits).float().cpu()
            steps.append({"logits": lg, "routing": _whole_rows(gather((lo, router.take()[1])))})
            # the whole sequence's greedy picks feed both plans
            pick = feed[i] if feed is not None else lg[:, :V].argmax(-1)
            tok = pick.to(torch.int32).to(env.device)
        peaks = gather(env.peak())
        if feed is None:
            feed = [s["logits"][:, :V].argmax(-1) for s in steps]
        local = sum(v.to_local().numel() * v.to_local().element_size() for v in cache.values())
        out[which] = {"steps": steps, "tpot_ms": sorted(secs)[len(secs) // 2] * 1e3,
                      "step_ms": [t * 1e3 for t in secs], "peak_gb_by_rank": peaks,
                      "cache_gb_a_rank": local / 1e9, "counts": counts}
        say(f"{tag} {cfg.name} {cfg.num_layers} layers, B={B}, cache of {s_max} drawn to "
            f"{fill}, {new} steps under the {which} plan (seq_axis {plan.seq_axis}): TPOT "
            f"{out[which]['tpot_ms']:.2f} ms (steps "
            f"{', '.join(f'{t:.2f}' for t in out[which]['step_ms'])} ms), cache "
            f"{out[which]['cache_gb_a_rank']:.2f} GB a rank, peak by rank "
            f"{', '.join(f'{p:.2f}' for p in peaks)} GB; counts {counts}  [{env.card}]")
        del cache, decode
        env.free()
    router.close()
    ok = True
    if rank() == 0:
        seq, whole = out["seq"]["steps"], out["whole"]["steps"]
        rel = max(float((a["logits"][:, :V] - b["logits"][:, :V]).abs().max())
                  / float(b["logits"][:, :V].abs().max()) for a, b in zip(seq, whole))
        picks = all(torch.equal(a["logits"][:, :V].argmax(-1), b["logits"][:, :V].argmax(-1))
                    for a, b in zip(seq, whole))
        per_layer, wl, splits, held = _held_rows(seq, whole, V)
        n_seq = sum(n for k, n in out["seq"]["counts"].items() if k.endswith(":seq_local"))
        ok = mesh.shape["model"] == 1 or n_seq > 0
        if dtype == "float32":
            ok = ok and rel <= BUILDER_REL and picks
        out.update(rel=rel, picks_equal=picks, router_max_diff_by_layer=per_layer,
                   logits_max_diff_held=wl, splits=splits, held_row_steps=held)
        say(f"{tag} the decode plan against the whole sequence, fed the same tokens: logits "
            f"within {rel:.3e} of the step's largest, picks equal {picks}"
            + (f" (limit {BUILDER_REL})" if dtype == "float32" else " (recorded, not held)")
            + f"; {held} of {B * new} row-steps before a routing split, their logits max|diff| "
            f"{wl:.4g}; router logits max|diff| by MoE layer up to each row's split "
            f"{[round(x, 4) for x in per_layer]}; splits (step, row, layer, gap) {splits}  "
            f"{'ok' if ok else 'FAIL'}  [{env.card}]")
    fail(bcast(ok), f"{tag}: the sequence-sharded decode leaves the whole sequence's")
    if env.cuda and rank() == 0 and dtype == "bfloat16":
        for which in ("seq", "whole"):
            pred = _predicted("qwen2_moe_a2_7b", B, s_max, which)
            out[which]["predicted"] = pred
            say(f"{tag} the dry run's prediction for the {which} plan: {pred}; measured peak "
                f"{max(out[which]['peak_gb_by_rank']):.2f} GB  [{env.card}]")
    for which in ("seq", "whole"):
        out[which]["steps"] = None
    del model
    env.free()
    return out


def part_seq(env, mesh_shape):
    """Decode over a sequence-sharded cache (module doc)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.sharding import rank_mesh
    out = {}
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    for arch, layers in SEQ_CASES:
        cfg = dataclasses.replace(env.cfg(arch, layers), param_dtype="float32",
                                  activ_dtype="float32")
        S, s_max = (SEQ_S, SEQ_S_MAX) if not env.reduced else (6, 16)
        plan = dryrun.plan_for_cell(cfg, ShapeCell("d", "decode", s_max, SEQ_B), False)
        row = _held_to_one_card(env, mesh, cfg, plan, SEQ_B, S, SEQ_NEW, s_max,
                                "[engine ranks seq builders]", seq_local=True)
        if row is not None:
            out[arch] = row
    for dtype, B in (("float32", QWEN_SEQ_B_FP32), ("bfloat16", QWEN_SEQ_B)):
        out[f"qwen {dtype}"] = _qwen_seq(env, mesh, dtype, B if not env.reduced else 4)
    return out


def _whisper_batch(env, cfg, S):
    """`WHISPER_B` seeded prompts of ``S`` tokens and their frames."""
    import torch

    from repro_torch.models.common import dtype_of
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, cfg.vocab_size, size=(WHISPER_B, S)).astype(np.int32)
    frames = rng.standard_normal((WHISPER_B, cfg.encdec.encoder_seq_len, cfg.d_model))
    return {"tokens": torch.as_tensor(tokens, device=env.device),
            "frames": torch.as_tensor(frames, dtype=dtype_of(cfg), device=env.device)}


def _whisper_run(env, cfg, model, prefill, decode, batch, forced=None):
    """The prefill and `WHISPER_NEW` greedy decode steps (host clock around
    each, synced), each step fed its own pick or, with ``forced``, the
    given token of each step: every step's logits on the host, the tokens
    fed, the counts and the kernel launches of the prefill, the counts of a
    decode step, the prefill's seconds, each decode step's ms, and this
    rank's peak GB in the prefill and in the decode steps."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.common import dtype_of
    from repro_torch.sharding import ctx
    V, S = cfg.vocab_size, batch["tokens"].shape[1]
    s_max = S + WHISPER_NEW + 1
    env.free()
    env.reset_peak()
    ops.reset_launches()
    ctx.reset_tp_counts()
    env.sync()
    t0 = time.perf_counter()
    logits, pre = prefill(batch)
    env.sync()
    out = {"prefill_s": time.perf_counter() - t0, "launches": dict(ops.LAUNCHES),
           "prefill_counts": ctx.tp_counts(), "prefill_peak_gb": env.peak()}
    full = model.init_cache(WHISPER_B, s_max, dtype=dtype_of(cfg))
    for k, v in pre.items():
        full[k][:, :, :v.shape[2]] = ctx.full(v)
    del pre
    steps, ms, fed = [ctx.full(logits).float().cpu()], [], []
    env.reset_peak()
    for i in range(WHISPER_NEW):
        fed.append(steps[-1][:, :V].argmax(-1) if forced is None else forced[i])
        t = fed[-1].to(torch.int32).to(env.device)
        ctx.reset_tp_counts()
        env.sync()
        t0 = time.perf_counter()
        logits, full = decode(t[:, None], full, torch.tensor(S + i, device=env.device))
        env.sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(ctx.full(logits).float().cpu())
    out.update(steps=steps, fed=fed, decode_ms=ms, decode_counts=ctx.tp_counts(),
               decode_peak_gb=env.peak())
    return out


def _near_ties(got, want, V):
    """Where ``got``'s greedy pick differs from ``want``'s: ``(step, row,
    want's top-2 gap, the step's max |diff|)``, and whether each is a
    near-tie (the gap within the step's difference)."""
    import torch
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        diff = float((a - b).abs().max())
        for r in (a[:, :V].argmax(-1) != b[:, :V].argmax(-1)).nonzero().flatten().tolist():
            top = torch.topk(b[r, :V], 2).values
            out.append((i, r, float(top[0] - top[1]), diff))
    return out, all(gap <= diff for _, _, gap, diff in out)


def part_whisper(env, mesh_shape):
    """Whisper-large-v3 tensor-parallel against rank 0's card (module
    doc)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, jit_prefill
    from repro_torch.models import Model
    from repro_torch.sharding import default_plan, rank_mesh
    tag = "[engine ranks whisper]"
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    plan = default_plan()
    out = {}
    S = 8 if env.reduced else WHISPER_S       # the reduced config's positions: 128
    s_max = S + WHISPER_NEW + 1
    for dtype, layers in (("float32", WHISPER_LAYERS), (env.dtype, None)):
        cfg = env.cfg("whisper_large_v3", layers)
        cfg = dataclasses.replace(cfg, param_dtype=dtype, activ_dtype=dtype)
        if layers:
            cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                cfg.encdec, num_encoder_layers=layers))
        name = f"{cfg.encdec.num_encoder_layers}+{cfg.num_layers} layers {dtype}"
        pred = None
        if rank() == 0 and not env.reduced and dtype == "bfloat16":
            pred = {kind: _predicted("whisper_large_v3", WHISPER_B,
                                     S if kind == "prefill" else s_max, "whole", kind)
                    for kind in ("prefill", "decode")}
            say(f"{tag} the dry run's prediction for the same steps: {pred}  [{env.card}]")
        batch = _whisper_batch(env, cfg, S)
        one = true = None
        whole = layers is None
        if rank() == 0:
            model = Model(cfg, device=env.device, seed=0)
            with torch.no_grad():
                one = _whisper_run(env, cfg, model, model.prefill, model.decode_step, batch)
                if whole:       # the same weights in fp32, fed the same tokens
                    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                                activ_dtype="float32")
                    m32 = Model(cfg32, tree_util.map_tree(lambda _, x: x.float(), model.params),
                                device=env.device)
                    true = _whisper_run(env, cfg32, m32, m32.prefill, m32.decode_step,
                                        _whisper_batch(env, cfg32, S), one["fed"])
                    del m32
            del model
            env.free()
        # whole: fed one card's tokens, so that a pick that parts at a
        # near-tie leaves the later steps comparable
        forced = bcast(one["fed"] if rank() == 0 else None) if whole else None
        model = sharded_model(env, cfg, mesh, plan)
        pre = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", S, WHISPER_B))
        dec = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, WHISPER_B))
        got = _whisper_run(env, cfg, model, lambda b: pre(model.params, b),
                           lambda t, c, p: dec(model.params, t, c, p), batch, forced)
        peaks = gather((got["prefill_peak_gb"], got["decode_peak_gb"]))
        launches = gather(got["launches"])
        row, ok = None, True
        if rank() == 0:
            V = cfg.vocab_size
            diffs = [float((a - b).abs().max()) for a, b in zip(got["steps"], one["steps"])]
            rel = max(d / float(b.abs().max()) for d, b in zip(diffs, one["steps"]))
            ties, only_ties = _near_ties(got["steps"], one["steps"], V)
            picks = not ties
            if whole:       # bf16 on the card: the path tolerance, picks up to near-ties
                held = only_ties and all(cs.within(a, b, cs.PATH_LOGITS_TOL[dtype])[0]
                                         for a, b in zip(got["steps"], one["steps"]))
            else:           # fp32 at a few layers, each side fed its own picks
                held = picks and rel <= WHISPER_REL
            to_true = true and {
                "one_card": max(float((a - b).abs().max())
                                for a, b in zip(one["steps"], true["steps"])),
                "sharded": max(float((a - b).abs().max())
                               for a, b in zip(got["steps"], true["steps"]))}
            counts = (got["prefill_counts"], got["decode_counts"])
            local = all(c.get("tp_local", 0) > 0 and not c.get("tp_gathered") for c in counts)
            want = {"flash_attention": cfg.num_layers, "moe_topk": 0, "ssd_scan": 0}
            launched = not env.cuda or all(n == want for n in launches)
            ok = held and (local or mesh.shape["model"] == 1) and launched
            tpot = sorted(got["decode_ms"])[WHISPER_NEW // 2]
            one_tpot = sorted(one["decode_ms"])[WHISPER_NEW // 2]
            row = {"max_diff": max(diffs), "rel": rel, "picks_equal": picks,
                   "picks_parted": ties, "max_diff_to_fp32": to_true,
                   "prefill_counts": counts[0], "decode_counts": counts[1],
                   "launches_by_rank": launches, "prefill_s": got["prefill_s"],
                   "one_prefill_s": one["prefill_s"], "decode_ms": got["decode_ms"],
                   "one_decode_ms": one["decode_ms"], "tpot_ms_median": tpot,
                   "one_tpot_ms_median": one_tpot,
                   "peak_gb_by_rank": {"prefill": [p[0] for p in peaks],
                                       "decode": [p[1] for p in peaks]},
                   "one_peak_gb": {"prefill": one["prefill_peak_gb"],
                                   "decode": one["decode_peak_gb"]},
                   "predicted": pred}
            say(f"{tag} {cfg.name} {name} {tuple(mesh.shape.values())}: prefill of "
                f"{WHISPER_B} x {S} over {cfg.encdec.encoder_seq_len} frames and "
                f"{WHISPER_NEW} decode steps, logits max|diff| {max(diffs):.4g} ({rel:.3e} of "
                f"the largest; limit {'PATH_LOGITS_TOL' if whole else WHISPER_REL}), "
                f"{'fed one card tokens, ' if whole else ''}picks equal {picks} (parted "
                f"(step, row, one card's top-2 gap, the step's max|diff|): {ties}); against the "
                f"same weights in fp32: {to_true}; prefill counts {counts[0]}; a decode step's "
                f"{counts[1]}; launches a prefill by rank {launches} (want {want}); prefill "
                f"{got['prefill_s']:.3f} s (one card {one['prefill_s']:.3f} s), TPOT median "
                f"{tpot:.2f} ms (one card {one_tpot:.2f} ms); peak GB by rank prefill "
                f"{[round(p[0], 2) for p in peaks]} decode {[round(p[1], 2) for p in peaks]} "
                f"(one card {one['prefill_peak_gb']:.2f} / {one['decode_peak_gb']:.2f}); the dry "
                f"run's {pred and {k: round(v['peak_gb'], 2) for k, v in pred.items()}}  "
                f"{'ok' if ok else 'FAIL'}  [{env.card}]")
        fail(bcast(ok), f"{tag} {name}: the sharded steps leave one card's")
        out["fp32 cut" if layers else "whole"] = row
        del model, pre, dec, got
        env.free()
    return out


def part_jamba(env, mesh_shape, whole: bool):
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import default_plan, rank_mesh
    out = {}
    mesh = rank_mesh(mesh_shape, device=env.device.type)
    # reduced: one period held to the card, two periods for "whole"
    half = env.cfg(cs.HYBRID_ARCH, None if env.reduced else cs.HYBRID_SERVE_LAYERS)
    whole_cfg = env.cfg(cs.HYBRID_ARCH, 16 if env.reduced else None)
    lens = (17, 100, 255, 256) if env.reduced else cs.SSM_PROMPT_LENS
    for tag, cfg, hold in (("[engine ranks jamba half]", half, True),
                           ("[engine ranks jamba whole]", whole_cfg, False)):
        if not hold and not whole:
            say(f"{tag} skipped: {cfg.num_layers} layers need the four cards")
            continue
        oracle = oracle_run(env, cfg, lens, **JAMBA_KW) if hold else None
        model = sharded_model(env, cfg, mesh, default_plan())
        eng = ServingEngine(model, device=env.device, mesh=mesh, **JAMBA_KW)
        res = serve(env, eng, eng.submit, eng.step, cfg, lens, oracle, hold,
                    f"{tag} {cfg.num_layers} layers {mesh_shape}")
        if env.cuda:
            want = cs.launches_per_prefill(cfg, len(lens))
            say(f"{tag} launches on rank 0 {res['launches']} (want {want}: "
                f"{ {k: v // len(lens) for k, v in want.items()} } a prefill)  [{env.card}]")
            fail(res["launches"] == want, f"{tag} launches {res['launches']} != {want}")
            fail(max(res["peak_gb_by_rank"]) * 1e9 < CARD_BYTES,
                 f"{tag} a rank's peak is over 80 GB")
        out["half" if hold else "whole"] = res
        del eng, model
        env.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true", help="the reduced fp32 configs")
    ap.add_argument("--parts", default="builders,seq,whisper,qwen,pod,jamba")
    ap.add_argument("--predict", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.predict:
        print(json.dumps(predict_decode(args.predict)), flush=True)
        return 0
    import torch
    import torch.distributed as dist
    if args.device == "cuda":
        fail(torch.cuda.is_available(), "no CUDA device")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl", timeout=timedelta(seconds=600),
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        torch.set_num_threads(2)
        dist.init_process_group("gloo", timeout=timedelta(seconds=600))
    world = dist.get_world_size()
    fail(world in (1, 4), f"{world} ranks: run on 4 (or 1 to try the code on one card)")
    t_start = time.perf_counter()
    args.card = "cpu"
    if args.device == "cuda":
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
                             capture_output=True, text=True, check=True).stdout.strip()
        args.card = smi
        say(f"[engine ranks] {world} ranks; rank 0's card: {smi}; torch {torch.__version__} "
            f"CUDA {torch.version.cuda}")
        if rank() == 0:         # one build of the kernels, then every rank loads it
            cs.phase_build()
        dist.barrier()
    env = Env(args)
    one = world == 1
    qwen_mesh = (1, 1, 1) if one else (1, 2, 2)
    pod_mesh = (1, 1, 1) if one else (2, 2, 1)
    parts = args.parts.split(",")
    out, oracle = {"world": world, "card": args.card}, None
    if "builders" in parts:
        out["builders"] = part_builders(env, qwen_mesh)
    if "seq" in parts:
        out["seq"] = part_seq(env, qwen_mesh)
    if "whisper" in parts:
        out["whisper"] = part_whisper(env, qwen_mesh)
    if "qwen" in parts or "pod" in parts:
        out["qwen"], oracle = part_qwen(env, qwen_mesh)
    if "pod" in parts:
        out["pod"] = part_pod(env, pod_mesh, oracle)
    del oracle
    env.free()
    if "jamba" in parts:
        out["jamba"] = part_jamba(env, qwen_mesh, whole=not one)
    out["seconds"] = time.perf_counter() - t_start
    say(f"[engine ranks] done in {out['seconds']:.1f} s  [{args.card}]")
    if rank() == 0:
        cs.OUT.mkdir(exist_ok=True)
        (cs.OUT / "engine_ranks.json").write_text(json.dumps(out, indent=1, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
