#!/usr/bin/env python3
"""The train step on its shards across four H100s: each layer gathered over
the FSDP axis as the step reaches it, tensor-parallel on the model axis,
the residual stream sequence-parallel where the plan says so.

    torchrun --nproc-per-node 4 tools/train_ranks.py [--parts builders,qwen,minitron,whisper]
    torchrun --nproc-per-node 4 tools/train_ranks.py --device cpu --reduced

One process per card (``torchrun`` gives each its rank; the group is made
over ``env://``, a localhost rendezvous), on the (1, 2, 2) mesh under
`default_plan()` with ``sequence_parallel`` as the dry run's `plan_for_cell`
sets it for a train cell (on for the dense, MoE and enc-dec configs, off
for the SSM one). Seeded weights are made straight into their shards. Four
parts, each freeing its models before the next:

  builders  one `jit_train_step` at full width in fp32, cut to a few layers
         (Minitron-4B 2, Qwen1.5-MoE 4, Mamba2-370m 4, MiniCPM3-4B 2; B=2 x
         S=1024), held to `make_train_step` of the same config on rank 0's
         card: the loss within `BUILDER_LOSS_REL`, each first AdamW moment
         (the clipped gradient times 1 - beta1) within atol 1e-7 + rtol 1e-4
         at all but `BUILDER_M_SHARE` of its coordinates (the CPU tests'
         tolerance; fp32 sums over the shards reassociate, no tf32); every
         group on its shard.
  qwen   Qwen1.5-MoE-A2.7B whole (24 layers, bf16 params, fp32 moments, LR
         1e-4), `QWEN_STEPS` steps of B=4 x S=1024 (2 rows a data rank:
         each MoE microbatch fills whole 1024-token groups a rank): every
         loss (finite), ms a step, each rank's peak memory (under 80 GB),
         and the dry run's predicted peak for the same layout (a child
         process on a fake world of 4 ranks: the fake world and NCCL must
         not meet in one process).
  minitron  Minitron-4B whole (32 layers, bf16 params, fp32 moments, LR
         1e-4, loss chunk 256), the train phase's B=2 x S=1024 of
         `chip_smoke.py`, `MINITRON_STEPS` steps: ms a step and each rank's
         peak, against one card's (PERF.md).
  whisper  first the builders' check of Whisper-large-v3 at 2 encoder and 2
         decoder layers (B=2 x 448 tokens over 1500 frames); then Whisper
         whole (32 + 32 layers, bf16 params, fp32 moments), the train
         phase's B=2 x 448 tokens over 1500 frames of `chip_smoke.py`,
         `WHISPER_STEPS` steps, every group on its shard
         (20 heads, ``d_ff`` and the vocab divide the model axis of 2): every
         loss (finite), ms a step, each rank's peak against the dry run's
         predicted peak for the same layout (a child process).

Any failed check ends the run non-zero (``torchrun`` then stops every
rank). Rank 0 prints the results and writes ``train_ranks.json`` beside
`chip_smoke.py`'s output. ``--device cpu --reduced`` runs the same parts
over gloo at the reduced fp32 configs (no memory peaks on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MESH = (1, 2, 2)
CARD_BYTES = 80e9
LR = 1e-4
BUILDER_CASES = (("minitron_4b", 2), ("qwen2_moe_a2_7b", 4), ("mamba2_370m", 4),
                 ("minicpm3_4b", 2))
#: the whisper part's builders case: 2 encoder and 2 decoder layers
WHISPER_BUILDER = (("whisper_large_v3", 2),)
BUILDER_LOSS_REL = 1e-5
BUILDER_M_SHARE = 1e-3
QWEN_STEPS, QWEN_B = 5, 4
MINITRON_STEPS, MINITRON_B, MINITRON_CHUNK = 5, 2, 256
WHISPER_STEPS = 5
SEQ = 1024


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
        print(f"train_ranks: FAIL (rank {rank()}): {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def gather(obj):
    """Every rank's ``obj``, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def bcast(obj):
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Env:
    """The run's device and configs."""

    def __init__(self, args):
        import torch
        self.cuda = args.device == "cuda"
        self.device = (torch.device("cuda", torch.cuda.current_device()) if self.cuda
                       else torch.device("cpu"))
        self.reduced = args.reduced
        self.card = args.card
        self.seq = 16 if args.reduced else SEQ

    def cfg(self, arch, layers=None, dtype=None):
        """``arch``'s config (reduced in fp32 with ``--reduced``) at
        ``layers`` layers (an enc-dec model's encoder too)."""
        from repro_torch.configs import get_config, get_reduced_config
        cfg = get_reduced_config(arch) if self.reduced else get_config(arch)
        if self.reduced or dtype:
            dt = "float32" if self.reduced else dtype
            cfg = dataclasses.replace(cfg, param_dtype=dt, activ_dtype=dt)
        if layers and cfg.encdec is not None:
            cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
                cfg.encdec, num_encoder_layers=layers))
        return dataclasses.replace(cfg, num_layers=layers) if layers else cfg

    def seq_of(self, cfg) -> int:
        """The train cell's tokens a row: the train phase's 448 for an
        enc-dec model (16 on the reduced configs), `SEQ` otherwise."""
        if cfg.encdec is not None:
            return 16 if self.reduced else cs.WHISPER_TRAIN_SEQ
        return self.seq

    def batch(self, cfg, B, step, placements=None):
        """Batch ``step`` of the seeded stream at B x `seq_of`: its rows
        under ``placements`` (`SyntheticLM.sharded_batch_at`) or whole; an
        enc-dec model's with its frames (`data.make_batch`), whole (the
        sharded step places it)."""
        from repro_torch.configs import ShapeCell
        from repro_torch.data import SyntheticLM, make_batch
        if cfg.encdec is not None:
            return make_batch(cfg, ShapeCell("train", "train", self.seq_of(cfg), B), step=step,
                              device=self.device)
        ds = SyntheticLM(cfg.vocab_size, self.seq, B, seed=0, device=self.device)
        return ds.batch_at(step) if placements is None else ds.sharded_batch_at(step, placements)

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


def setup(env, cfg, B, mesh, **model_kw):
    """``cfg``'s seeded weights made into their shards, its AdamW state, the
    sharded train step and the batches' placements, under the plan
    `plan_for_cell` gives a train cell of B x `env.seq_of`."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.dryrun import plan_for_cell
    from repro_torch.launch.steps import jit_train_step, named
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import batch_specs, default_plan, plan_to_shardings
    cell = ShapeCell("train", "train", env.seq_of(cfg), B)
    plan = default_plan().with_(
        sequence_parallel=plan_for_cell(cfg, cell, False).sequence_parallel)
    t0 = time.perf_counter()
    shardings = plan_to_shardings(cfg, plan, mesh, n_slots=1)["params"]
    model = Model(cfg, device=env.device, seed=0, shardings=shardings, **model_kw)
    opt = AdamW(lr=LR)
    state = opt.init(model.params)
    env.sync()
    say(f"[train ranks] {cfg.name} {cfg.num_layers} layers {cfg.param_dtype} made sharded in "
        f"{time.perf_counter() - t0:.1f} s; sequence-parallel {plan.sequence_parallel}  "
        f"[{env.card}]")
    step = jit_train_step(model, opt, mesh, plan, cell)
    return model, opt, state, step, named(mesh, batch_specs(cfg, plan, cell)), plan


def part_builders(env, mesh, cases=BUILDER_CASES):
    """The sharded step of each of ``cases`` against rank 0's card (module
    doc)."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import ctx
    tag = "[train ranks builders]"
    B = 2
    out = {}
    for arch, layers in cases:
        cfg = env.cfg(arch, layers, "float32")
        one_loss, one_m = None, None
        if rank() == 0:
            model = Model(cfg, device=env.device, seed=0)
            opt = AdamW(lr=LR)
            state = opt.init(model.params)
            _, state, loss, _ = make_train_step(model, opt)(model.params, state,
                                                            env.batch(cfg, B, 0))
            one_loss, one_m = float(loss), state["m"]
            del model, state
            env.free()
        model, opt, state, step, bsh, plan = setup(env, cfg, B, mesh)
        ctx.reset_tp_counts()
        env.sync()
        t0 = time.perf_counter()
        _, state, loss, _ = step(model.params, state, env.batch(cfg, B, 0, bsh))
        env.sync()
        secs = time.perf_counter() - t0
        counts = ctx.tp_counts()
        loss = float(ctx.full(loss))
        bad = total = 0
        worst = 0.0
        for name, m in tree_util.items(state["m"]):
            whole = ctx.full(m)          # a collective: every rank
            if rank() == 0:
                want = dict(tree_util.items(one_m))[name].double()
                got = whole.double()
                bad += int((~torch.isclose(got, want, atol=1e-7, rtol=1e-4)).sum())
                total += want.numel()
                worst = max(worst, float((got - want).abs().max()
                                         / want.abs().max().clamp(min=1e-30)))
            del whole
        ok = True
        if rank() == 0:
            rel = abs(loss - one_loss) / abs(one_loss)
            ok = (rel <= BUILDER_LOSS_REL and bad <= BUILDER_M_SHARE * total
                  and counts.get("tp_local", 0) > 0 and not counts.get("tp_gathered"))
            out[arch] = {"layers": cfg.num_layers, "loss": loss, "one_loss": one_loss,
                         "loss_rel": rel, "m_outside": bad, "m_total": total,
                         "m_worst_share": worst, "counts": counts, "seconds": secs,
                         "sequence_parallel": plan.sequence_parallel}
            say(f"{tag} {cfg.name} {cfg.num_layers} layers fp32 {MESH} B={B} x "
                f"S={env.seq_of(cfg)}: "
                f"loss {loss:.6f} against one card's {one_loss:.6f} (rel {rel:.2e}, limit "
                f"{BUILDER_LOSS_REL}); m outside atol 1e-7 + rtol 1e-4 at {bad} of {total} "
                f"(limit {BUILDER_M_SHARE:g} of them), largest |diff| {worst:.3e} of a leaf's "
                f"largest |m|; {counts}; {secs:.2f} s  {'ok' if ok else 'FAIL'}  [{env.card}]")
        fail(bcast(ok), f"{tag} {arch}: the sharded step leaves one card's")
        del model, state, step, one_m
        env.free()
    return out


def predicted_peak(arch: str, B: int, seq: int, device: str) -> dict:
    """The dry run's record of ``arch``'s train step (bf16, B x seq, the
    plan `plan_for_cell` gives it) on a fake (1, 2, 2) mesh, in a child
    process (`main` with ``--predict``)."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--predict",
                           f"{arch}:{B}:{seq}:{device}"], capture_output=True, text=True,
                          timeout=900)
    fail(proc.returncode == 0, f"the dry run's prediction failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def predict(spec: str) -> dict:
    """``--predict arch:B:seq:device``: the dry run of that train step on a
    fake (1, 2, 2) world, one record (argument and peak bytes, wire bytes,
    tensor-parallel counts)."""
    import torch

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    arch, B, seq, device = spec.split(":")
    cfg = get_config(arch)
    cell = ShapeCell("train", "train", int(seq), int(B))
    mesh = mesh_lib.fake_mesh(MESH, ("pod", "data", "model"), device=device)
    plan = dryrun.plan_for_cell(cfg, cell, False)
    chunk = MINITRON_CHUNK if arch == "minitron_4b" else None
    model = Model(cfg, device="meta", loss_chunk=chunk)
    inputs = dryrun.build_step(model, cell, mesh, plan, opt_state_dtype=None, lr=LR)
    counts = dryrun.dry_run_step(inputs, mesh, torch.device(device))
    rec = dryrun.record_of(counts, cfg, cell, mesh)
    return {"argument_gb": rec["memory"]["argument_bytes"] / 1e9,
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
            "wire_gb": {k: v / 1e9 for k, v in rec["collectives"]["wire_bytes_by_axis"].items()},
            "tp": rec["tp"], "sequence_parallel": plan.sequence_parallel}


def run_steps(env, tag, cfg, B, n, mesh, **model_kw):
    """``n`` steps of ``cfg`` (B x `env.seq_of`, batches 0 .. n - 1 of the
    seeded stream): each loss, ms a step (host clock around the step,
    ending in the loss's read), each rank's peak."""
    from repro_torch.sharding import ctx
    env.reset_peak()
    model, opt, state, step, bsh, plan = setup(env, cfg, B, mesh, **model_kw)
    params = model.params
    losses, ms = [], []
    for i in range(n):
        batch = env.batch(cfg, B, i, bsh)
        env.sync()
        ctx.reset_tp_counts()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        losses.append(float(ctx.full(loss)))
        ms.append((time.perf_counter() - t0) * 1e3)
        say(f"{tag} step {i}: loss {losses[-1]:.4f}, {ms[-1]:.1f} ms  [{env.card}]")
    counts = ctx.tp_counts()
    peaks = gather(env.peak())
    warm = sorted(ms[1:])
    res = {"layers": cfg.num_layers, "B": B, "S": env.seq_of(cfg), "losses": losses, "ms": ms,
           "ms_median_warm": warm[len(warm) // 2] if warm else None,
           "peak_gb_by_rank": peaks, "counts": counts,
           "sequence_parallel": plan.sequence_parallel}
    fail(all(math.isfinite(x) for x in losses), f"{tag} a loss is not finite: {losses}")
    fail(counts.get("tp_local", 0) > 0 and not counts.get("tp_gathered"),
         f"{tag} groups ran gathered: {counts}")
    if env.cuda:
        fail(max(peaks) * 1e9 < CARD_BYTES, f"{tag} a rank's peak is over 80 GB: {peaks}")
    say(f"{tag} {cfg.name} {cfg.num_layers} layers {cfg.param_dtype} {MESH} B={B} x "
        f"S={env.seq_of(cfg)}, {n} steps: losses {[round(x, 4) for x in losses]}; ms a step "
        f"{[round(x, 1) for x in ms]} (median of the warm steps {res['ms_median_warm']:.1f}); "
        f"peak GB by rank {[round(p, 2) for p in peaks]}; {counts}  [{env.card}]")
    del model, state, step, params
    env.free()
    return res


def part_qwen(env, mesh):
    tag = "[train ranks qwen]"
    pred = None
    if rank() == 0 and not env.reduced:
        pred = predicted_peak("qwen2_moe_a2_7b", QWEN_B, env.seq, "cpu")
        say(f"{tag} the dry run's prediction for the same layout: {pred}  [{env.card}]")
    res = run_steps(env, tag, env.cfg("qwen2_moe_a2_7b"), QWEN_B, QWEN_STEPS, mesh)
    res["predicted"] = pred
    return res


def part_minitron(env, mesh):
    return run_steps(env, "[train ranks minitron]", env.cfg("minitron_4b"), MINITRON_B,
                     MINITRON_STEPS, mesh, loss_chunk=MINITRON_CHUNK)


def part_whisper(env, mesh):
    out = {"builders": part_builders(env, mesh, WHISPER_BUILDER)}
    tag = "[train ranks whisper]"
    cfg = env.cfg("whisper_large_v3")
    pred = None
    if rank() == 0 and not env.reduced:
        pred = predicted_peak("whisper_large_v3", cs.WHISPER_TRAIN_BATCH, env.seq_of(cfg), "cpu")
        say(f"{tag} the dry run's prediction for the same layout: {pred}  [{env.card}]")
    out["whole"] = run_steps(env, tag, cfg, cs.WHISPER_TRAIN_BATCH, WHISPER_STEPS, mesh)
    out["whole"]["predicted"] = pred
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true", help="the reduced fp32 configs")
    ap.add_argument("--parts", default="builders,qwen,minitron,whisper")
    ap.add_argument("--predict", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.predict:
        print(json.dumps(predict(args.predict)), flush=True)
        return 0
    import torch
    import torch.distributed as dist
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("train_ranks: no CUDA device (pass --device cpu)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", timeout=timedelta(seconds=600),
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        torch.set_num_threads(2)
        dist.init_process_group("gloo", timeout=timedelta(seconds=600))
    world = dist.get_world_size()
    fail(world == 4, f"{world} ranks: the (1, 2, 2) mesh takes 4")
    from repro_torch.sharding import rank_mesh
    t_start = time.perf_counter()
    args.card = "cpu"
    if args.device == "cuda":
        args.card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader", "-i",
                                    str(torch.cuda.current_device())],
                                   capture_output=True, text=True, check=True).stdout.strip()
        say(f"[train ranks] {world} ranks; rank 0's card: {args.card}; torch "
            f"{torch.__version__} CUDA {torch.version.cuda}")
    env = Env(args)
    mesh = rank_mesh(MESH, device=env.device.type)
    parts = args.parts.split(",")
    out = {"world": world, "card": args.card}
    for name, fn in (("builders", part_builders), ("qwen", part_qwen),
                     ("minitron", part_minitron), ("whisper", part_whisper)):
        if name in parts:
            out[name] = fn(env, mesh)
    out["seconds"] = time.perf_counter() - t_start
    say(f"[train ranks] done in {out['seconds']:.1f} s  [{args.card}]")
    if rank() == 0:
        cs.OUT.mkdir(exist_ok=True)
        (cs.OUT / "train_ranks.json").write_text(json.dumps(out, indent=1, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
