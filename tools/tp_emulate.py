#!/usr/bin/env python3
"""Tensor parallelism emulated on ONE card: ``N`` threads (2 by default),
each one rank of a model axis of ``N``, against the same config run whole.

    python3 tools/tp_emulate.py [--device cpu] [--tp N]
                                [--train | --decode | --whisper | --padded]

Each thread holds its rank's cut of the seeded weights as plain tensors
(the model-axis dim of every group `lm.tp_groups` runs local, and the
vocab; the leaves of padded attention heads stay whole, and the model cuts
each layer's to the rank's head slots, `sharding.ctx.slot_cut`), and runs
the model's own code; the collectives of a tensor-parallel step
(`sharding.ctx.tp`, `tp_sum`, `tp_gather`, `tp_reduce_scatter`, `tp_max`,
which the autograd rules of a train step call too) are exchanged between
the threads at a barrier, in rank order, as an all-reduce, an all-gather
and a reduce-scatter over ``N`` ranks compute them. What runs on the card
is every line of the tensor-parallel model code; what does not is NCCL and
the FSDP gathers (`tools/engine_ranks.py` and `tools/train_ranks.py` run
those on four cards).

Serving (the default) runs the prefill and three greedy decode steps with
the card's kernels, and prints, per case, each step's logits against the
whole model's (max |diff| and the step's largest logit), whether the greedy
picks are equal, and the first MoE call (prefill through the MoE top-k
kernel, then decode) where a token's expert picks differ, with the one-card
router logits' gap between the k-th and the next expert there and the router
logits' max |diff| up to it: in bf16 a tensor-parallel layer's partial
sums round otherwise, and a near-tie then picks another expert. The cases:
Qwen1.5-MoE whole in bf16 and at 12 layers in fp32, Jamba-v0.1 at 8
layers in bf16 (full width; the reduced configs with ``--device cpu``).

``--whisper`` serves Whisper-large-v3 instead (`whisper_case`): fp32 at
full width, 2 encoder and 2 decoder layers, the prefill (the decoder's
causal self-attention through the flash kernel on each thread's 10 heads)
and 8 greedy decode steps against the whole model: each step's logits
within `DEC_REL` of its largest, picks equal, every group on its shard.
``chip_smoke.py`` runs the same check.

``--train`` runs one train step's loss and gradients instead (`train_case`,
sequence-parallel as the dry run's plan sets it for a train cell), fp32
Minitron-4B, Qwen1.5-MoE and Whisper-large-v3 (2 encoder layers too, over
its 1500 frames) at full width and 2 layers, against the whole
model's `make_train_step`: the loss, each first AdamW moment (the clipped
gradient times 1 - beta1, the clip scale from the global norm over both
threads' shards), and the replicated leaves' gradients equal on both
threads; and the model-axis collectives rank 0's step issued, by kind, with
their ring-model wire bytes a rank. ``chip_smoke.py`` runs the same check.

``--decode`` runs the decode step over a sequence-sharded cache instead
(`decode_case`): the model axis of 2 cuts both the heads (q heads and the
groups `lm.tp_groups` runs local) and the cache's sequence, as the dry
run's serving plans set it (``seq_axis="model"``); each thread holds its
half of the positions and the step combines the softmax over the two
(`sharding.ctx.seq_axes`, `seq_piece`, `seq_max`, `seq_sum`, exchanged at
the barrier). Full-width Qwen1.5-MoE-A2.7B (4 layers, heads local) and
Minitron-4B (2 layers, ``shard_attn_heads`` off: attention gathered) in
fp32: one whole prefill of `DEC_B` prompts of `DEC_S` tokens fills a cache
of `DEC_S_MAX` positions, then `DEC_NEW` greedy decode steps cross from the
first thread's positions into the second's, against the whole model's
decode from the same cache: each step's logits within `DEC_REL` of its
largest, picks equal. Then again with the cache in ``float8_e4m3fn``
(both sides start from the same fp8 bytes), against the whole model's fp8
decode on the CPU. ``chip_smoke.py`` runs the same check.

``--padded`` runs attention heads that do not divide the model axis
(`padded_case`), on ``--tp`` threads (16 by default, the one extent on
which the shipped configs pad): fp32 Minitron-4B (24 q heads over 8 K/V
heads: 2 slots a rank, ranks 12-15 padding alone) and MiniCPM3-4B (40 MLA
heads: 3 slots a rank, the last rank's last 8 padding) at full width and
2 layers, a prefill (flash on each thread's slots, each slot reading its
K/V head by index) and `DEC_NEW` greedy decode steps against the whole
model, each step's logits within `DEC_REL` of its largest, picks equal,
every attention counted padded; then Minitron's train step (`train_case`,
sequence-parallel, B=2 x S=1024), a padded leaf's gradient the sum of the
threads' (each thread's is its own slots' part).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import operator
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CASES = (("qwen2_moe_a2_7b", None, "bfloat16"), ("qwen2_moe_a2_7b", 12, "float32"),
         ("jamba_v0_1_52b", 8, "bfloat16"))
#: the train cases: fp32 at full width, 2 layers, B x S tokens (a whole MoE
#: dispatch group of 1024 a row), the loss in chunks of 256, the card's LR
TRAIN_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "whisper_large_v3")
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_LOSS_CHUNK, TRAIN_LR = 2, 2, 1024, 256, 1e-4
N = 2                   # ranks of the emulated model axis (`ranks`)
B, S, NEW = 4, 64, 3
#: the sequence-sharded decode: (arch, layers, heads on their shards), fp32
#: at full width; a prompt of DEC_S in a cache of DEC_S_MAX positions, so
#: that the DEC_NEW steps write positions 60-67, across the two threads'
#: halves at 64 (the reduced configs on the CPU: 6 in 16, positions 6-13)
DEC_CASES = (("qwen2_moe_a2_7b", 4, True), ("minitron_4b", 2, False))
DEC_B, DEC_S, DEC_S_MAX, DEC_NEW = 4, 60, 128, 8
DEC_REL = 1e-5
#: Whisper-large-v3 served tensor-parallel (`whisper_case`): fp32 at full
#: width, WHISPER_LAYERS encoder and as many decoder layers, WHISPER_B
#: prompts of WHISPER_S tokens over the config's 1500 frames, WHISPER_NEW
#: greedy decode steps (the reduced config on the CPU: prompts of 8)
WHISPER_LAYERS, WHISPER_B, WHISPER_S, WHISPER_NEW = 2, 2, 128, 8
#: the padded heads (`padded_case`): fp32 at full width and PADDED_LAYERS
#: layers on PADDED_TP threads, PADDED_B prompts of PADDED_S tokens, then
#: DEC_NEW greedy decode steps (the reduced configs on the CPU: 4 heads on
#: 16 threads, 1 slot a rank)
PADDED_ARCHS = ("minitron_4b", "minicpm3_4b")
PADDED_TP, PADDED_LAYERS, PADDED_B, PADDED_S = 16, 2, 2, 128

_TL = threading.local()
_BAR = threading.Barrier(N)
_SLOTS: list = [None] * N


@contextlib.contextmanager
def ranks(n: int):
    """The emulated model axis at ``n`` ranks (threads) for the block, the
    previous extent restored after."""
    global N, _BAR, _SLOTS
    saved = N, _BAR, _SLOTS
    N, _BAR, _SLOTS = n, threading.Barrier(n), [None] * n
    try:
        yield
    finally:
        N, _BAR, _SLOTS = saved


def _exchange(x):
    """Every emulated rank's ``x``, in rank order."""
    _SLOTS[_TL.r] = x
    _BAR.wait()
    out = list(_SLOTS)
    _BAR.wait()
    return out


def _on() -> bool:
    return getattr(_TL, "on", False)


#: the primitives of `sharding.ctx` that `_install` replaces
PRIMITIVES = ("tp", "tp_axis", "tp_sum", "tp_gather", "tp_reduce_scatter", "tp_max",
              "seq_axes", "seq_piece", "seq_max", "seq_sum")


def _seq_on() -> bool:
    """Whether this thread's step holds its piece of the cache's sequence
    (`decode_case` sets it)."""
    return _on() and getattr(_TL, "seq", False)


def _tallied(kind, fn):
    """``fn``, a model-axis collective of the emulated ranks, each call
    noted in this thread's tally (`train_case`) as ``(kind, operand bytes,
    result bytes)``."""

    def call(x, *args):
        out = fn(x, *args)
        tally = getattr(_TL, "tally", None)
        if tally is not None and _on():
            tally.append((kind, x.numel() * x.element_size(), out.numel() * out.element_size()))
        return out

    return call


def _install(ctx) -> None:
    """The model axis's collectives over the `N` threads (outside an
    emulated rank's thread, a step of one rank); in a thread of
    `decode_case`, the model axis cuts the cache's sequence too."""
    import torch
    ctx.tp = lambda: (N, _TL.r) if _on() else (1, 0)
    ctx.tp_axis = lambda: "model" if _on() else None
    ctx.tp_sum = _tallied("all-reduce", lambda x: functools.reduce(
        operator.add, _exchange(x)) if _on() else x)
    ctx.tp_gather = _tallied("all-gather", lambda x, dim: torch.cat(_exchange(x), dim)
                             if _on() else x)
    ctx.tp_reduce_scatter = _tallied("reduce-scatter", lambda x, dim: (
        functools.reduce(operator.add, _exchange(x)).chunk(N, dim)[_TL.r] if _on() else x))
    ctx.tp_max = _tallied("all-reduce", lambda x: functools.reduce(
        torch.maximum, _exchange(x.detach())) if _on() else x)
    ctx.seq_axes = lambda: ("model",) if _seq_on() else ()
    ctx.seq_piece = lambda: (N, _TL.r) if _seq_on() else (1, 0)
    ctx.seq_max = lambda x: functools.reduce(torch.maximum, _exchange(x)) if _seq_on() else x
    ctx.seq_sum = lambda x: functools.reduce(operator.add, _exchange(x)) if _seq_on() else x


@contextlib.contextmanager
def installed(ctx):
    """`_install` for the duration of the block, the originals restored
    after."""
    saved = {name: getattr(ctx, name) for name in PRIMITIVES}
    _install(ctx)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ctx, name, fn)


def _run_ranks(fn) -> list:
    """``fn(r)`` on one thread per emulated rank; their results in rank
    order. A rank that raises aborts the barrier, so the other cannot wait
    on it.

    Raises:
        SystemExit: a rank raised (its traceback in the message).
    """
    res: list = [None] * N

    def one(r):
        _TL.r, _TL.on = r, True
        try:
            res[r] = fn(r)
        except Exception:
            import traceback
            res[r] = traceback.format_exc()
            _BAR.abort()
        finally:
            _TL.on = _TL.seq = False

    threads = [threading.Thread(target=one, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(N):
        if isinstance(res[r], str):
            raise SystemExit(f"tp_emulate: rank {r} failed:\n{res[r]}")
    return res


def _tp_leaves(cfg):
    """``(local, padded)``: the leaf paths of the parameter tree
    (``layers/mixer/wq``, ``dec_layers/cross_attn/wk``, ``embed`` ...) that
    the step keeps as this rank's shard (the local groups' leaves of each
    layer stack, and the embedding and LM head where the vocab runs local),
    and those of padded head groups, which the model cuts to the rank's
    head slots itself. Inside the step's context."""
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    groups = lm.tp_groups(cfg)
    if cfg.encdec is not None:
        stacks = {s: lm.encdec_cut(cfg, s, groups) for s in lm.ENCDEC_SUBLAYERS}
    else:
        stacks = {"layers": lm.tp_cut(cfg, groups)}
    local = {f"{s}/{p}" for s, cut in stacks.items() for p in cut.local}
    if groups["vocab"] == ctx.LOCAL:
        local |= {"embed", "lm_head"}
    padded = {f"{s}/{p}" for s, cut in stacks.items() for p in cut.padded}
    return frozenset(local), frozenset(padded)


def cut_params(cfg, params, plan, r):
    """Emulated rank ``r``'s tree: the leaves of the groups that run local
    (and the vocab) cut to its shard of their model-axis dim, as plain
    tensors (`_tp_leaves`); every other leaf as it is (a padded leaf too:
    the model cuts each layer's to the rank's head slots). Returns the tree,
    the cut leaves' ``(name, dim)`` and the padded leaves' names. Inside
    the step's context."""
    from repro_torch import tree as tree_util
    from repro_torch.sharding.plan import param_specs
    local, padded = _tp_leaves(cfg)
    specs = dict(tree_util.items(param_specs(cfg, plan)))
    leaves, cut = [], set()
    for name, x in tree_util.items(params):
        if name in local:
            spec = specs[name]
            d = next(i for i in range(len(spec)) if "model" in spec.axes(i))
            w = x.shape[d] // N
            x = x.narrow(d, r * w, w).contiguous()
            cut.add((name, d))
        leaves.append(x)
    return tree_util.like(params, leaves), cut, padded


def _fp32_layers(arch, reduced: bool, layers: int):
    """``arch`` (the reduced config on the CPU) in fp32 at ``layers``
    layers, an enc-dec model's encoder too."""
    from repro_torch.configs import get_config, get_reduced_config
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers, param_dtype="float32",
                              activ_dtype="float32")
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, num_encoder_layers=layers))
    return cfg


def _frames(cfg, rng, rows, dev):
    """Seeded stub frame embeddings of an enc-dec model, fp32."""
    import torch
    return torch.as_tensor(rng.standard_normal(
        (rows, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32), device=dev)


def train_config(arch, dev, reduced: bool):
    """``arch`` in fp32 at `TRAIN_LAYERS` (the reduced config on the CPU)
    and a seeded batch of `TRAIN_B` rows of `TRAIN_S` + 1 tokens (16 on
    the CPU) made on ``dev``, an enc-dec model's frames with it."""
    import torch
    cfg = _fp32_layers(arch, reduced, TRAIN_LAYERS)
    S = 16 if reduced else TRAIN_S
    rng = np.random.default_rng(5)
    tokens = rng.integers(2, cfg.vocab_size, size=(TRAIN_B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    if cfg.encdec is not None:
        batch["frames"] = _frames(cfg, rng, TRAIN_B, dev)
    return cfg, batch


def train_case(dev, cfg, batch, lr, card, tag, *, loss_chunk=None) -> dict:
    """One train step of ``cfg`` on two emulated ranks against the whole
    model's `make_train_step` (module notes). Returns the loss on both
    sides, the first moments' coordinates outside atol 1e-7 + rtol 1e-4 of
    the whole step's (and their count), the largest |diff| over a leaf's
    largest |m|, whether the replicated leaves' gradients are equal on both
    threads, and the threads' tensor-parallel counts."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import plan_for_cell
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import Mesh
    B, S = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    plan = plan_for_cell(cfg, ShapeCell("t", "train", S, B), False)
    devs = np.empty((1, 1, N), dtype=object)
    devs[...] = dev
    mesh = Mesh(devs)
    model = Model(cfg, device=dev, seed=0, loss_chunk=loss_chunk)
    opt = AdamW(lr=lr)
    t0 = time.perf_counter()

    def rank(r):
        with ctx.activation_sharding(mesh, plan, tensor_parallel=True):
            params, cut, padded = cut_params(cfg, model.params, plan, r)
            ctx.reset_tp_counts()
            _TL.tally = []
            try:
                loss, _, grads = steps._loss_and_grads(model, params, batch)
            finally:
                tally, _TL.tally = _TL.tally, None
            return float(loss), grads, cut, ctx.tp_counts(), padded, tally

    with installed(ctx):
        res = _run_ranks(rank)
    tp_s = time.perf_counter() - t0
    names = [name for name, _ in tree_util.items(model.params)]
    cut, padded = dict(res[0][2]), res[0][4]

    def whole_grad(i, name):
        """Leaf ``i``'s gradient as the whole step holds it: a cut leaf's
        shards put together, a padded leaf's parts (each rank's own head
        slots) summed, a replicated leaf's as rank 0 holds it."""
        if name in cut:
            return torch.cat([res[r][1][i] for r in range(N)], cut[name])
        if name in padded:
            return functools.reduce(operator.add, [res[r][1][i] for r in range(N)])
        return res[0][1][i]

    grads = [whole_grad(i, name).double() for i, name in enumerate(names)]
    sq = sum(float(g.square().sum()) for g in grads)
    scale = min(1.0, opt.clip_norm / (sq ** 0.5 + 1e-9))
    same = all(torch.equal(res[0][1][i], res[r][1][i]) for r in range(1, N)
               for i, name in enumerate(names) if name not in cut and name not in padded)
    state = opt.init(model.params)
    t0 = time.perf_counter()
    _, state, whole_loss, _ = steps.make_train_step(model, opt)(model.params, state, batch)
    whole_s = time.perf_counter() - t0
    bad = total = 0
    worst = 0.0
    for i, (name, m) in enumerate(tree_util.items(state["m"])):
        got = grads[i] * scale * (1 - opt.b1)
        want = m.double()
        bad += int((~torch.isclose(got, want, atol=1e-7, rtol=1e-4)).sum())
        total += want.numel()
        worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    out = {"loss": res[0][0], "loss_rank1": res[1][0], "whole_loss": float(whole_loss),
           "m_outside": bad, "m_total": total, "m_worst_share": worst,
           "replicated_grads_equal": same, "counts": res[0][3], "tp_s": tp_s,
           "whole_s": whole_s, "collectives": collectives_by_kind(res[0][5], N)}
    print(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.param_dtype} B={B} x S={S} "
          f"on {N} threads, "
          f"{'sequence-parallel' if plan.sequence_parallel else 'whole sequence'}: loss "
          f"{out['loss']:.6f} (rank 1 {out['loss_rank1']:.6f}), whole {out['whole_loss']:.6f}; "
          f"m outside atol 1e-7 + rtol 1e-4 at {bad} of {total}, largest |diff| "
          f"{worst:.3e} of a leaf's largest |m|; replicated leaves' gradients equal on every "
          f"rank {same}; {out['counts']}; {tp_s:.2f} s {N} ranks, {whole_s:.2f} s whole  "
          f"[{card}]", flush=True)
    print(f"{tag} {cfg.name} {collectives_text(out['collectives'])}", flush=True)
    del model, state, res
    return out


def collectives_by_kind(tally, n: int) -> dict:
    """A thread's tally of model-axis collectives (`_tallied`) by kind:
    how many, their operand bytes, and the bytes each rank of a ring of
    ``n`` moves for them (`launch.cost.wire_bytes`, the reference's ring
    model)."""
    from repro_torch.launch.cost import wire_bytes
    out: dict = {}
    for kind, operand, result in tally:
        k = out.setdefault(kind, {"n": 0, "operand_bytes": 0, "wire_bytes": 0.0})
        k["n"] += 1
        k["operand_bytes"] += operand
        k["wire_bytes"] += wire_bytes(kind, operand, result, n)
    return out


def collectives_text(by_kind: dict) -> str:
    """`collectives_by_kind` as one line: each kind's count and wire bytes
    a rank, and their total."""
    total = sum(k["wire_bytes"] for k in by_kind.values())
    parts = ", ".join(f"{kind} {k['n']} x, {k['wire_bytes'] / 1e6:.3f} MB"
                      for kind, k in sorted(by_kind.items()))
    return (f"model-axis collectives of one step, rank 0: {parts or 'none'}; "
            f"wire {total / 1e6:.3f} MB a rank")


class _Routing:
    """Each MoE call's router logits and expert ids, per thread."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import mlp
        self.local = threading.local()
        kernel, plain = ops.moe_topk, mlp.router_topk

        def moe_topk(logits, k, **kw):
            w, i = kernel(logits, k, **kw)
            self._note(logits, i)
            return w, i

        def router_topk(m, logits, **kw):
            out = plain(m, logits, **kw)
            self._note(logits, out[1])
            return out

        ops.moe_topk, mlp.router_topk = moe_topk, router_topk

    def _note(self, logits, ids):
        calls = getattr(self.local, "calls", None)
        if calls is not None:
            calls.append((logits.float().cpu(), ids.long().cpu()))

    def start(self):
        self.local.calls = []

    def take(self):
        calls, self.local.calls = self.local.calls, None
        return calls


def first_split(got, want):
    """``(call, token, gap, router max |diff| up to it)`` of the first MoE
    call where a token's expert set differs (``call`` None if none)."""
    worst = 0.0
    for c, ((g_lg, g_id), (w_lg, w_id)) in enumerate(zip(got, want)):
        worst = max(worst, float((g_lg - w_lg).abs().max()))
        differ = (g_id.sort(-1).values != w_id.sort(-1).values).any(-1).nonzero()
        if len(differ):
            row = int(differ[0])
            top = w_lg[row].sort(descending=True).values
            k = w_id.shape[1]
            return c, row, float(top[k - 1] - top[k]), worst
    return None, None, None, worst


def run_case(dev, reduced, routing, arch, layers, dtype, card):
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import Model, lm
    from repro_torch.models.lm import is_positional
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import Mesh, default_plan
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers, param_dtype=dtype,
                              activ_dtype=dtype)
    model = Model(cfg, device=dev, seed=0)
    plan = default_plan()
    devs = np.empty((1, 1, N), dtype=object)
    devs[...] = dev
    mesh = Mesh(devs)
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(B, S)), device=dev)
    V, s_max = cfg.vocab_size, S + NEW + 1

    def serve(params, keep=frozenset(), r=0):
        """Prefill and NEW greedy steps; the cache's ``keep`` leaves are
        this rank's shard (their last dim, or heads on dim 2)."""
        logits, cache = model.prefill({"tokens": tokens}, params=params)
        full = model.init_cache(B, s_max, dtype=torch.float32)
        for k in keep:
            d = -1 if k.endswith("conv_x") else 2
            w = full[k].shape[d] // N
            full[k] = full[k].narrow(d, r * w, w).clone()
        for k, v in cache.items():
            if is_positional(k):
                full[k][:, :, :v.shape[2]] = v
            else:
                full[k].copy_(v)
        steps = [ctx.tp_gather(logits, 1).float().cpu()]
        for i in range(NEW):
            t = steps[-1][:, :V].argmax(-1).to(dev)
            logits, full = model.decode_step(t[:, None], full,
                                             torch.tensor(S + i, device=dev), params=params)
            steps.append(ctx.tp_gather(logits, 1).float().cpu())
        return steps

    routing.start()
    with torch.no_grad():
        one = serve(model.params)
    one_calls = routing.take()

    def rank(r):
        routing.start()
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, tensor_parallel=True):
            params, _, _ = cut_params(cfg, model.params, plan, r)
            groups = lm.tp_groups(cfg)
            ctx.reset_tp_counts()
            steps = serve(params, lm.tp_cache_local(cfg, groups), r)
            return steps, ctx.tp_counts(), routing.take()

    t0 = time.perf_counter()
    res = _run_ranks(rank)
    got, counts, calls = res[0]
    tag = f"[tp emulate] {cfg.name} {cfg.num_layers} layers {dtype}"
    for i, (a, b) in enumerate(zip(got, one)):
        print(f"{tag} step {i}: max|diff| {float((a - b).abs().max()):.4g} of "
              f"{float(b.abs().max()):.4g}, picks equal "
              f"{bool(torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1)))}, ranks agree "
              f"{bool(torch.equal(a, res[1][0][i]))}  [{card}]", flush=True)
    call, token, gap, worst = first_split(calls, one_calls)
    print(f"{tag}: {len(calls)} MoE calls; first expert split at call {call} token {token} "
          f"(gap {gap}), router logits max|diff| {worst:.4g} up to it; {counts}; "
          f"{time.perf_counter() - t0:.2f} s  [{card}]", flush=True)
    del model


def whisper_case(dev, reduced, card, tag="[tp emulate whisper]") -> dict:
    """Whisper-large-v3 served on two emulated ranks of a model axis of 2
    under `default_plan()` (every group on its shard: 20 heads, ``d_ff``
    and the vocab divide 2) against the whole model: a prefill of
    `WHISPER_B` prompts over the frames, then `WHISPER_NEW` greedy decode
    steps, each side fed its own picks. Returns per step the max |diff|,
    the step's largest logit and whether the picks are equal; whether both
    threads' logits agree; the threads' counts; the kernel launches of the
    two threads, counted from 0 (each thread's prefill launches flash once
    per decoder layer)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import Mesh, default_plan
    cfg = _fp32_layers("whisper_large_v3", reduced, WHISPER_LAYERS)
    model = Model(cfg, device=dev, seed=0)
    plan = default_plan()
    devs = np.empty((1, 1, N), dtype=object)
    devs[...] = dev
    mesh = Mesh(devs)
    rng = np.random.default_rng(3)
    S = 8 if reduced else WHISPER_S
    batch = {"tokens": torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(WHISPER_B, S)),
                                       device=dev),
             "frames": _frames(cfg, rng, WHISPER_B, dev)}
    V, s_max = cfg.vocab_size, S + WHISPER_NEW + 1

    def serve(params):
        logits, pre = model.prefill(batch, params=params)
        cache = model.init_cache(WHISPER_B, s_max, dtype=torch.float32)
        for k, v in pre.items():
            cache[k][:, :, :v.shape[2]] = v
        steps = [ctx.tp_gather(logits, 1).float().cpu()]
        for i in range(WHISPER_NEW):
            t = steps[-1][:, :V].argmax(-1).to(torch.int32).to(dev)
            logits, cache = model.decode_step(t[:, None], cache, torch.tensor(S + i, device=dev),
                                              params=params)
            steps.append(ctx.tp_gather(logits, 1).float().cpu())
        return steps

    with torch.no_grad():
        whole = serve(model.params)

    def rank(r):
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, tensor_parallel=True):
            params, _, _ = cut_params(cfg, model.params, plan, r)
            ctx.reset_tp_counts()
            return serve(params), ctx.tp_counts()

    t0 = time.perf_counter()
    ops.reset_launches()
    with installed(ctx):
        res = _run_ranks(rank)
    secs = time.perf_counter() - t0
    got, counts = res[0]
    out = {"steps": [], "counts": counts, "seconds": secs, "launches": dict(ops.LAUNCHES),
           "ranks_agree": all(torch.equal(a, b) for a, b in zip(got, res[1][0]))}
    name = (f"{tag} {cfg.name} {cfg.encdec.num_encoder_layers}+{cfg.num_layers} layers fp32, "
            f"B={WHISPER_B} prompts of {S} over {cfg.encdec.encoder_seq_len} frames")
    for i, (a, b) in enumerate(zip(got, whole)):
        row = {"max_diff": float((a - b).abs().max()), "largest": float(b.abs().max()),
               "picks_equal": bool(torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1)))}
        out["steps"].append(row)
        print(f"{name} {'prefill' if i == 0 else f'decode {i}'}: max|diff| "
              f"{row['max_diff']:.4g} of {row['largest']:.4g} against the whole model, picks "
              f"equal {row['picks_equal']}  [{card}]", flush=True)
    print(f"{name}: threads agree {out['ranks_agree']}; launches on the two threads "
          f"{out['launches']}; {counts}; {secs:.2f} s two threads  [{card}]", flush=True)
    del model
    return out


def padded_case(dev, arch, reduced, card, tag="[tp emulate padded]") -> dict:
    """``arch`` (fp32, `PADDED_LAYERS` layers) served on `N` emulated ranks
    under `default_plan()`, its attention heads padded over the axis
    (module notes), against the whole model: a prefill of `PADDED_B`
    prompts of `PADDED_S` tokens (8 on the CPU), then `DEC_NEW` greedy
    decode steps, each side fed its own picks. Returns per step the max
    |diff|, the step's largest logit and whether the picks are equal;
    whether every thread's logits equal rank 0's; rank 0's counts; the
    kernel launches of all the threads, counted from 0."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.models.lm import is_positional
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import Mesh, default_plan
    cfg = _fp32_layers(arch, reduced, PADDED_LAYERS)
    model = Model(cfg, device=dev, seed=0)
    plan = default_plan()
    devs = np.empty((1, 1, N), dtype=object)
    devs[...] = dev
    mesh = Mesh(devs)
    rng = np.random.default_rng(13)
    S = 8 if reduced else PADDED_S
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(PADDED_B, S)), device=dev)
    V, s_max = cfg.vocab_size, S + DEC_NEW + 1

    def serve(params):
        logits, pre = model.prefill({"tokens": tokens}, params=params)
        cache = model.init_cache(PADDED_B, s_max, dtype=torch.float32)
        for k, v in pre.items():
            if is_positional(k):
                cache[k][:, :, :v.shape[2]] = v
            else:
                cache[k].copy_(v)
        del pre
        steps = [ctx.tp_gather(logits, 1).float().cpu()]
        for i in range(DEC_NEW):
            t = steps[-1][:, :V].argmax(-1).to(torch.int32).to(dev)
            logits, cache = model.decode_step(t[:, None], cache, torch.tensor(S + i, device=dev),
                                              params=params)
            steps.append(ctx.tp_gather(logits, 1).float().cpu())
        return steps

    with torch.no_grad():
        whole = serve(model.params)

    def rank(r):
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, tensor_parallel=True):
            params, _, _ = cut_params(cfg, model.params, plan, r)
            ctx.reset_tp_counts()
            return serve(params), ctx.tp_counts()

    t0 = time.perf_counter()
    ops.reset_launches()
    with installed(ctx):
        res = _run_ranks(rank)
    secs = time.perf_counter() - t0
    got, counts = res[0]
    out = {"steps": [], "counts": counts, "seconds": secs, "launches": dict(ops.LAUNCHES),
           "ranks_agree": all(torch.equal(a, b) for r in range(1, N)
                              for a, b in zip(got, res[r][0]))}
    name = f"{tag} {cfg.name} {cfg.num_layers} layers fp32, {cfg.num_heads} heads on {N} ranks"
    for i, (a, b) in enumerate(zip(got, whole)):
        row = {"max_diff": float((a - b).abs().max()), "largest": float(b.abs().max()),
               "picks_equal": bool(torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1)))}
        out["steps"].append(row)
        print(f"{name} {'prefill' if i == 0 else f'decode {i}'}: max|diff| "
              f"{row['max_diff']:.4g} of {row['largest']:.4g} against the whole model, picks "
              f"equal {row['picks_equal']}  [{card}]", flush=True)
    print(f"{name}, B={PADDED_B} prompts of {S}: threads agree {out['ranks_agree']}; launches "
          f"on the {N} threads {out['launches']}; {counts}; {secs:.2f} s {N} threads  [{card}]",
          flush=True)
    del model
    return out


def decode_case(dev, arch, layers, heads_local, reduced, card, *,
                cache_dtype=None, tag="[tp emulate decode]") -> dict:
    """The decode step over a sequence-sharded cache on two emulated ranks
    (module notes) against the whole model's decode from the same cache.
    ``cache_dtype``: the cache's dtype (fp32 by default); with fp8 the whole
    model's decode also runs on the CPU from the same bytes, and the
    two-thread logits are held to those. Returns per step the max |diff|
    against the whole model's logits (and the CPU's), the step's largest
    logit, whether the picks are equal, and the threads' counts."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.models import Model
    from repro_torch.models.lm import is_positional
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import Mesh, default_plan
    cache_dtype = cache_dtype or torch.float32
    cfg = get_reduced_config(arch) if reduced else get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers, param_dtype="float32",
                              activ_dtype="float32")
    Bq, Sq, s_max = (2, 6, 16) if reduced else (DEC_B, DEC_S, DEC_S_MAX)
    model = Model(cfg, device=dev, seed=0)
    plan = default_plan().with_(seq_axis="model")
    if not heads_local:
        plan = plan.with_(shard_attn_heads=False)
    devs = np.empty((1, 1, N), dtype=object)
    devs[...] = dev
    mesh = Mesh(devs)
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(Bq, Sq)), device=dev)
    V, piece = cfg.vocab_size, s_max // N
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, pre = model.prefill({"tokens": tokens})
        full = model.init_cache(Bq, s_max, dtype=cache_dtype)
        for k, v in pre.items():
            if is_positional(k):
                full[k][:, :, :v.shape[2]] = v
            else:
                full[k].copy_(v)
        del pre
    first = logits[:, :V].argmax(-1)

    def greedy(m, cache, params=None, gather=lambda x: x):
        steps, tok = [], first.to(cache[next(iter(cache))].device)
        for i in range(DEC_NEW):
            pos = torch.tensor(Sq + i, device=tok.device)
            lg, cache = m.decode_step(tok[:, None].to(torch.int32), cache, pos, params=params)
            lg = gather(lg).float().cpu()
            steps.append(lg)
            tok = lg[:, :V].argmax(-1).to(pos.device)
        return steps

    def rank(r):
        _TL.seq = True
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, tensor_parallel=True,
                                                      seq_local=True):
            params, _, _ = cut_params(cfg, model.params, plan, r)
            cache = {k: v.narrow(2, r * piece, piece).clone() if is_positional(k) else v.clone()
                     for k, v in full.items()}
            ctx.reset_tp_counts()
            steps = greedy(model, cache, params, lambda x: ctx.tp_gather(x, 1))
            return steps, ctx.tp_counts()

    with installed(ctx):
        res = _run_ranks(rank)
    two_s = time.perf_counter() - t0
    with torch.no_grad():
        whole = greedy(model, {k: v.clone() for k, v in full.items()})
    got, counts = res[0]
    out = {"steps": [], "counts": counts, "two_ranks_s": two_s,
           "ranks_agree": all(torch.equal(a, b) for a, b in zip(got, res[1][0]))}
    cpu = None
    if cache_dtype != torch.float32:
        cpu_model = Model(cfg, tree_util.map_tree(lambda _, x: x.cpu(), model.params),
                          device="cpu")
        with torch.no_grad():
            cpu = greedy(cpu_model, {k: v.cpu() for k, v in full.items()})
        del cpu_model
    name = f"{tag} {cfg.name} {cfg.num_layers} layers fp32, cache {str(cache_dtype)[6:]}"
    for i, (a, b) in enumerate(zip(got, whole)):
        row = {"max_diff": float((a - b).abs().max()), "largest": float(b.abs().max()),
               "picks_equal": bool(torch.equal(a[:, :V].argmax(-1), b[:, :V].argmax(-1)))}
        text = ""
        if cpu is not None:
            row["cpu_max_diff"] = float((a - cpu[i]).abs().max())
            row["cpu_picks_equal"] = bool(torch.equal(a[:, :V].argmax(-1),
                                                      cpu[i][:, :V].argmax(-1)))
            text = (f"; against the CPU's fp8 decode max|diff| {row['cpu_max_diff']:.4g}, picks "
                    f"equal {row['cpu_picks_equal']}")
        out["steps"].append(row)
        print(f"{name} step {i} (position {Sq + i}, thread {(Sq + i) // piece}'s half): "
              f"max|diff| {row['max_diff']:.4g} of {row['largest']:.4g} against the whole "
              f"decode, picks equal {row['picks_equal']}{text}  [{card}]", flush=True)
    print(f"{name}: B={Bq}, prompt {Sq}, cache {s_max} (halves of {piece}); threads agree "
          f"{out['ranks_agree']}; {counts}; {two_s:.2f} s prefill and two threads  [{card}]",
          flush=True)
    del model, full
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train", action="store_true", help="a train step instead of serving")
    ap.add_argument("--decode", action="store_true",
                    help="decode over a sequence-sharded cache instead of serving")
    ap.add_argument("--whisper", action="store_true",
                    help="Whisper-large-v3's prefill and decode instead of serving")
    ap.add_argument("--padded", action="store_true",
                    help="attention heads that do not divide the model axis, served and "
                         "trained")
    ap.add_argument("--tp", type=int, default=None,
                    help=f"ranks of the emulated model axis (2; {PADDED_TP} with --padded)")
    args = ap.parse_args(argv)
    with ranks(args.tp or (PADDED_TP if args.padded else 2)):
        _main(args)


def _main(args) -> None:
    import torch

    from repro_torch.sharding import ctx
    reduced = args.device == "cpu"
    card = "cpu"
    if not reduced:
        if not torch.cuda.is_available():
            raise SystemExit("tp_emulate: no CUDA device (pass --device cpu)")
        import subprocess
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"], capture_output=True,
                              text=True, check=True).stdout.strip()
    dev = torch.device(args.device)
    if args.padded:
        for arch in PADDED_ARCHS:
            padded_case(dev, arch, reduced, card)
            if not reduced:
                torch.cuda.empty_cache()
        cfg, batch = train_config("minitron_4b", dev, reduced)
        train_case(dev, cfg, batch, TRAIN_LR, card, "[tp emulate padded train]",
                   loss_chunk=None if reduced else TRAIN_LOSS_CHUNK)
        return
    if args.whisper:
        whisper_case(dev, reduced, card)
        return
    if args.decode:
        for cache_dtype in (torch.float32, torch.float8_e4m3fn):
            for arch, layers, heads_local in DEC_CASES:
                decode_case(dev, arch, layers, heads_local, reduced, card,
                            cache_dtype=cache_dtype)
                if not reduced:
                    torch.cuda.empty_cache()
        return
    if args.train:
        for arch in TRAIN_ARCHS:
            cfg, batch = train_config(arch, dev, reduced)
            train_case(dev, cfg, batch, TRAIN_LR, card, "[tp emulate train]",
                       loss_chunk=None if reduced else TRAIN_LOSS_CHUNK)
            if not reduced:
                torch.cuda.empty_cache()
        return
    _install(ctx)
    routing = _Routing()
    for arch, layers, dtype in CASES:
        run_case(dev, reduced, routing, arch, layers, dtype, card)
        if not reduced:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
