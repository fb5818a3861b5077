"""The dry run: does each (arch x shape cell x mesh) step fit one card's
memory under the port's plan, and what bounds it: compute, HBM or links.

The reference lowers each cell for 512 placeholder TPU devices and reads the
compiled module (`repro.launch.dryrun`). The port's steps are eager, so it
RUNS each cell's step once on rank 0 of a fake world of 256 or 512 ranks
(`launch.mesh`), on fake tensors (`FakeTensorMode`: shapes, dtypes and
devices, no memory, no arithmetic), under the counters of `launch.cost`.
The step is the one a card runs: the model, the plan and the sharded
builders of `launch.steps` (ZeRO-3 storage, each layer gathered over the
FSDP axes as the step reaches it, data parallel over the batch axes;
tensor-parallel over the model axis, each sub-layer whose dim divides it on
its shard, the others gathered whole, as the record's ``tp`` counts show,
in serving and in train; a train step's residual stream sequence-parallel
where the plan says so), with the stand-ins of
`launch.steps.{param,batch,decode}_struct` placed under the plan's specs as
each rank's shards. The kernels are custom ops whose fake implementations
give their output shapes after the card's own argument checks
(`kernels.ops`), so a cell fails here where the card would fail.

Usage (``--device cuda``, the default, on a machine with a card; ``cpu``
anywhere):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b --shape decode_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu [--out DIR]

Each cell prints one line and writes one JSON record (default
``experiments/dryrun_torch/``), with the reference's keys wherever the
quantity is the same: ``memory.{argument_bytes, temp_bytes, peak_bytes,
hbm_capacity, fits}``, ``cost.{hlo_flops_per_device,
hlo_bytes_per_device}`` (by the reference's HLO conventions, over the
eager step's ops), ``collectives.{n, by_kind, wire_bytes_by_axis,
wire_bytes_per_device}``, ``roofline.*`` (the H100's figures; each axis's
wire bytes over the link its groups cross), ``params``, ``plan``,
``accum_steps``; and ``kernel_calls``, ``tp`` (`ctx.tp_counts`), ``links``,
``wall_s``. A cell that
raises is recorded with ``"status": "error"`` and its reason, as the
reference records one: the sweep is a survey.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCH_IDS, applicable_cells, get_config, get_shape_cell
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.cost import StepCost
from repro_torch.models import Model
from repro_torch.models.common import torch_dtype
from repro_torch.optim import AdamW
from repro_torch.sharding import ctx
from repro_torch.sharding.plan import (
    P,
    ShardingPlan,
    batch_specs,
    cache_specs,
    default_plan,
    leaf_sharding,
    opt_state_specs,
    param_specs,
)

# gradient-accumulation steps per arch for train_4k: the reference's, kept
# so that cells compare; it sized them so that its saved scan-carry
# residuals (+ transients) fit a 16 GiB HBM budget, not an H100's 80 GB
TRAIN_ACCUM = {
    "nemotron-4-340b": 16,
    "deepseek-coder-33b": 4,
    "jamba-v0.1-52b": 4,
    "whisper-large-v3": 4,
    "minicpm3-4b": 2,
    "moonshot-v1-16b-a3b": 2,
    "mamba2-370m": 2,
}


def plan_for_cell(cfg: ModelConfig, cell: ShapeCell, multi_pod: bool,
                  overrides: Optional[Dict] = None,
                  profile: str = "baseline") -> ShardingPlan:
    """The reference's plan of a cell (`repro.launch.dryrun.plan_for_cell`):
    sequence parallelism for the dense, MoE, VLM and enc-dec train cells;
    pure data parallelism over every axis for a sub-1B train cell under the
    "optimized" profile; the KV cache's sequence over the model axis in
    serving, over every axis when the batch is 1."""
    plan = default_plan(multi_pod)
    if cell.kind == "train" and cfg.family in ("dense", "moe", "vlm", "encdec"):
        plan = plan.with_(sequence_parallel=True)
    n_devices = 512 if multi_pod else 256
    if (profile == "optimized" and cell.kind == "train"
            and cfg.param_count() < 1e9
            and cell.global_batch % n_devices == 0):
        axes = (("pod", "data", "model") if multi_pod else ("data", "model"))
        plan = plan.with_(tp_axis=None, ep_axis=None, batch_axes=axes,
                          fsdp_axes=axes, sequence_parallel=False)
    if cell.kind in ("decode", "prefill"):
        if cell.global_batch == 1:
            axes = ("pod", "data", "model") if multi_pod else ("data", "model")
            plan = plan.with_(seq_axis=axes)
        else:
            plan = plan.with_(seq_axis="model")
    if overrides:
        plan = plan.with_(**overrides)
    return plan


def resolve_accum(cfg: ModelConfig, cell: ShapeCell, plan: ShardingPlan, n_ranks: int,
                  accum_steps: Optional[int] = None) -> int:
    """The reference's accumulation: `TRAIN_ACCUM` by the config's dashed
    name for a train cell (1 otherwise); a pure data-parallel train plan
    takes as many microbatches as cover every rank once."""
    if accum_steps is not None:
        return accum_steps
    accum = TRAIN_ACCUM.get(cfg.name, 1) if cell.kind == "train" else 1
    if plan.tp_axis is None and cell.kind == "train":
        accum = max(1, cell.global_batch // n_ranks)
        accum = min(accum, cell.global_batch // n_ranks or 1)
    return accum


# dry-run profiles: the reference's conservative baseline and its
# optimized defaults
PROFILES = {
    "baseline": dict(shard_grads=False, grad_reduce_dtype=None,
                     profile="baseline"),
    "optimized": dict(shard_grads=True, grad_reduce_dtype="bfloat16",
                      cache_dtype="float8_e4m3fn",
                      profile="optimized"),
}


# ---------------------------------------------------------------------------
# one step, counted
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepInputs:
    """A step and what it takes: ``structs`` (meta stand-ins, as the step's
    positional arguments, named by ``names``) and ``shardings`` (a
    `LeafSharding` tree of the same structure), on ``mesh``."""

    step: Any
    names: Tuple[str, ...]
    structs: Tuple[Any, ...]
    shardings: Tuple[Any, ...]


def build_step(model: Model, cell: ShapeCell, mesh, plan: ShardingPlan, *,
               accum_steps: int = 1, opt_state_dtype: Optional[str] = "bfloat16",
               cache_dtype: str = "bfloat16", grad_reduce_dtype: Optional[str] = None,
               shard_grads: bool = True, lr: float = 3e-4) -> StepInputs:
    """The sharded step of ``cell`` (`launch.steps.jit_train_step`,
    `jit_prefill` or `jit_decode_step`) over ``mesh`` under ``plan``, its
    inputs' stand-ins and their placements: params, AdamW state and batch
    (train); params and batch (prefill); params, tokens, cache and position
    (decode). Every `DeviceMesh` the step uses is made here, outside any
    fake mode."""
    cfg = model.cfg
    named = lambda specs: steps.named(mesh, specs)  # noqa: E731
    pspecs = param_specs(cfg, plan)
    params = steps.param_struct(model, cell)
    if cell.kind == "train":
        opt = AdamW(lr=lr, state_dtype=opt_state_dtype)
        sd = opt._sdtype()
        state = {"m": tree_util.map_tree(lambda _, p: torch.empty_like(p, dtype=sd), params),
                 "v": tree_util.map_tree(lambda _, p: torch.empty_like(p, dtype=sd), params),
                 "count": torch.empty((), dtype=torch.int32, device="meta")}
        step = steps.jit_train_step(model, opt, mesh, plan, cell, accum_steps,
                                    grad_reduce_dtype, shard_grads)
        names = ("params", "state", "batch")
        structs = (params, state, steps.batch_struct(cfg, cell))
        shardings = (named(pspecs), named(opt_state_specs(pspecs)),
                     named(batch_specs(cfg, plan, cell)))
    elif cell.kind == "prefill":
        step = steps.jit_prefill(model, mesh, plan, cell)
        names = ("params", "batch")
        structs = (params, steps.batch_struct(cfg, cell))
        shardings = (named(pspecs), named(batch_specs(cfg, plan, cell)))
    else:
        step = steps.jit_decode_step(model, mesh, plan, cell)
        tokens, cache, pos = steps.decode_struct(model, cell, torch_dtype(cache_dtype))
        b_ax = plan.batch_axes if cell.global_batch > 1 else None
        names = ("params", "tokens", "cache", "pos")
        structs = (params, tokens, cache, pos)
        shardings = (named(pspecs), leaf_sharding(mesh, P(b_ax, None)),
                     named(cache_specs(cfg, plan, batch=cell.global_batch)),
                     leaf_sharding(mesh, P()))
    return StepInputs(step, names, structs, shardings)


def place_fake(structs: Any, shardings: Any, device: torch.device) -> Any:
    """Each meta stand-in as a DTensor whose local shard is an empty tensor
    on ``device`` of this rank's shard shape (call under a fake mode: the
    shards then hold no memory)."""
    def one(meta: torch.Tensor, sh) -> Any:
        local, _ = ctx.local_shape_and_offset(tuple(meta.shape), sh)
        return ctx.to_dtensor(torch.empty(local, dtype=meta.dtype, device=device), sh,
                              meta.shape)
    if isinstance(structs, dict):
        return {k: place_fake(v, shardings[k], device) for k, v in structs.items()}
    return one(structs, shardings)


def count_step(inputs: StepInputs, args: Tuple[Any, ...], mesh) -> Dict[str, Any]:
    """Run ``inputs.step(*args)`` once under a `StepCost` whose arguments are
    ``args``; returns the counter's summary."""
    cost = StepCost(mesh)
    cost.add_arguments(args)
    ctx.reset_tp_counts()
    with cost:
        out = inputs.step(*args)
    del out
    return {**cost.summary(), "tp": ctx.tp_counts()}


def dry_run_step(inputs: StepInputs, mesh, device: torch.device) -> Dict[str, Any]:
    """`count_step` over fake stand-ins placed on ``device``: what the step
    costs rank 0, without running it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        args = tuple(place_fake(s, sh, device)
                     for s, sh in zip(inputs.structs, inputs.shardings))
        return count_step(inputs, args, mesh)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        return 6 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2 * n_active * cell.global_batch * cell.seq_len
    return 2 * n_active * cell.global_batch


def record_of(counts: Dict[str, Any], cfg: ModelConfig, cell: ShapeCell,
              mesh) -> Dict[str, Any]:
    """The reference's record keys from one rank's counts on ``mesh``:
    memory against the H100's, cost, collectives, and the roofline on the
    H100's figures, each axis's wire bytes over the link its groups
    cross (an axis of one rank moves none)."""
    shape = tuple(mesh.devices.shape)
    n_chips = int(mesh.devices.size)
    hbm_bytes = mesh_lib.H100_HBM_BYTES
    links = mesh_lib.axis_links(shape, mesh.axis_names)
    bw = mesh_lib.axis_bandwidth(shape, mesh.axis_names)
    col = counts["collectives"]
    collective_s = sum(b / bw[axis] for axis, b in col["wire_bytes_by_axis"].items() if b)
    compute_s = counts["flops"] / mesh_lib.H100_PEAK_FLOPS_BF16
    memory_s = counts["bytes"] / mesh_lib.H100_HBM_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    lower = max(terms.values())
    model_flops = _model_flops(cfg, cell)
    flops_all = counts["flops"] * n_chips
    peak = counts["argument_bytes"] + counts["peak_transient"]
    return {
        "n_chips": n_chips,
        "memory": {"argument_bytes": counts["argument_bytes"],
                   "temp_bytes": counts["peak_transient"],
                   "peak_bytes": peak, "hbm_capacity": hbm_bytes,
                   "fits": peak <= hbm_bytes,
                   # the largest storages live at the peak, by the op that made each
                   "peak_tensors": counts.get("peak_tensors", [])},
        "cost": {"hlo_flops_per_device": counts["flops"],
                 "hlo_bytes_per_device": counts["bytes"]},
        "collectives": {**col, "links": links},
        "roofline": {**terms, "bottleneck": max(terms, key=terms.get),
                     "model_flops": model_flops, "hlo_flops_all_chips": flops_all,
                     "useful_flops_ratio": model_flops / flops_all if flops_all else 0.0,
                     "step_time_lower_bound_s": lower,
                     "roofline_fraction": compute_s / max(lower, 1e-30)},
        "params": {"total": cfg.param_count(), "active": cfg.active_param_count()},
        "kernel_calls": counts["kernel_calls"],
        # the tensor-parallel sub-layers (serving and train): on their
        # model-axis shard, or gathered whole where their dim does not
        # divide the axis
        "tp": counts.get("tp", {}),
    }


def dry_run_cell(arch: str, shape: str, *, multi_pod: bool = False,
                 device: str = "cuda", accum_steps: Optional[int] = None,
                 cache_dtype: str = "bfloat16",
                 grad_reduce_dtype: Optional[str] = None,
                 shard_grads: bool = True,
                 profile: str = "baseline",
                 config_fn=get_config) -> Dict[str, Any]:
    """Dry-run one cell on the production mesh (the counterpart of the
    reference's ``lower_cell``, with its defaults: loss chunk 2048, remat
    "nothing", bf16 AdamW moments). ``config_fn`` maps the arch to its
    config (`get_config`; tests pass `get_reduced_config`)."""
    cfg = config_fn(arch)
    cell = get_shape_cell(shape)
    dev = torch.device(device)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device=dev)
    plan = plan_for_cell(cfg, cell, multi_pod, None, profile)
    accum = resolve_accum(cfg, cell, plan, int(mesh.devices.size), accum_steps)
    model = Model(cfg, device="meta", loss_chunk=2048, remat_policy="nothing")
    t0 = time.perf_counter()
    inputs = build_step(model, cell, mesh, plan, accum_steps=accum,
                        opt_state_dtype="bfloat16", cache_dtype=cache_dtype,
                        grad_reduce_dtype=grad_reduce_dtype, shard_grads=shard_grads)
    counts = dry_run_step(inputs, mesh, dev)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_lib.mesh_name(mesh.devices.shape),
           "device": dev.type, "accum_steps": accum,
           "plan": dataclasses.asdict(plan), "run_s": time.perf_counter() - t0}
    rec.update(record_of(counts, cfg, cell, mesh))
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             **kwargs) -> Dict[str, Any]:
    """`dry_run_cell`, its record written to ``out_dir`` (and returned); a
    cell that raises is recorded with ``"status": "error"``."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    name = f"{arch}__{shape}__{mesh_name}"
    t0 = time.perf_counter()
    try:
        record = dry_run_cell(arch, shape, multi_pod=multi_pod, **kwargs)
        record["status"] = "ok"
        m, rf = record["memory"], record["roofline"]
        print(f"[dryrun] {name}: OK peak={m['peak_bytes'] / 1e9:.2f}GB "
              f"fits={m['fits']} bottleneck={rf['bottleneck']} "
              f"rf={rf['roofline_fraction']:.3f}", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        record = {"arch": arch, "shape": shape, "mesh": mesh_name,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
        print(f"[dryrun] {name}: FAIL {type(e).__name__}: {e}", flush=True)
    record["wall_s"] = time.perf_counter() - t0
    gc.collect()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(record, indent=1, default=str))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--profile", default="baseline", choices=sorted(PROFILES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the fake tensors claim (the card by default)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu)")
    out_dir = Path(args.out)

    jobs = []
    if args.all:
        for arch in ARCH_IDS:
            for cell in applicable_cells(get_config(arch)):
                jobs.append((arch, cell.name))
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape (or --all)")
        jobs.append((args.arch, args.shape))

    # the 512-rank world first, so that the 256-rank mesh reuses it
    meshes = [True, False] if args.both_meshes else [args.multi_pod]
    results = []
    for mp in meshes:
        for arch, shape in jobs:
            results.append(run_cell(arch, shape, mp, out_dir, device=args.device,
                                    **PROFILES[args.profile]))

    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"[dryrun] {ok}/{len(results)} cells ran")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
