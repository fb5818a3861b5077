"""The two sides of `test_torch_dryrun.py`'s reduced-size comparison, each
run in a process of its own (``python tests/_torch_dryrun_jobs.py
reference|port CELLS``), printing one JSON line:

  * ``reference``: `repro.launch.dryrun.lower_cell` over 512 placeholder
    host devices (``XLA_FLAGS``, set before JAX starts) with the reduced
    configs, and the reference's plans and accumulation for every arch x
    cell x mesh x profile;
  * ``port``: `repro_torch.launch.dryrun.dry_run_cell` on a fake world of
    256 ranks (``device="cpu"``) with the reduced configs.

A cell is ``arch:shape`` (the baseline profile) or ``arch:shape:profile``;
each record keeps the status (and the error's type and text), the argument
bytes, the model FLOPs, the parameter counts and the accumulation.
"""
import json
import os
import sys


def _ref_plans():
    """The reference's plan and resolved accumulation of every cell."""
    import dataclasses

    from repro.configs import ARCH_IDS, applicable_cells, get_config
    from repro.launch import dryrun
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for cell in applicable_cells(cfg):
            for mp in (False, True):
                for profile in sorted(dryrun.PROFILES):
                    plan = dryrun.plan_for_cell(cfg, cell, mp, None, profile)
                    # the accumulation as `lower_cell` resolves it
                    # (src/repro/launch/dryrun.py:124-133)
                    n = 512 if mp else 256
                    accum = dryrun.TRAIN_ACCUM.get(cfg.name, 1) if cell.kind == "train" else 1
                    if plan.tp_axis is None and cell.kind == "train":
                        accum = max(1, cell.global_batch // n)
                        accum = min(accum, cell.global_batch // n or 1)
                    out[f"{arch}:{cell.name}:{int(mp)}:{profile}"] = {
                        "plan": dataclasses.asdict(plan), "accum": accum}
    return out, {a: [c.name for c in applicable_cells(get_config(a))] for a in ARCH_IDS}


def reference(cells):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from repro import configs
    from repro.launch import dryrun
    dryrun.get_config = configs.get_reduced_config
    records = {}
    for cell in cells:
        arch, shape, profile = (cell.split(":") + ["baseline"])[:3]
        try:
            rec, _ = dryrun.lower_cell(arch, shape, **dryrun.PROFILES[profile])
            records[cell] = {"status": "ok", "argument_bytes": rec["memory"]["argument_bytes"],
                             "model_flops": rec["roofline"]["model_flops"],
                             "params": rec["params"], "accum_steps": rec["accum_steps"],
                             "flops": rec["cost"]["hlo_flops_per_device"]}
        except Exception as e:  # noqa: BLE001 — the status is what is compared
            records[cell] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    plans, cells_of = _ref_plans()
    return {"records": records, "plans": plans, "cells": cells_of,
            "train_accum": dryrun.TRAIN_ACCUM}


def port(cells):
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import dryrun
    records = {}
    for cell in cells:
        arch, shape, profile = (cell.split(":") + ["baseline"])[:3]
        try:
            rec = dryrun.dry_run_cell(arch, shape, device="cpu", config_fn=get_reduced_config,
                                      **dryrun.PROFILES[profile])
            records[cell] = {"status": "ok", "argument_bytes": rec["memory"]["argument_bytes"],
                             "model_flops": rec["roofline"]["model_flops"],
                             "params": rec["params"], "accum_steps": rec["accum_steps"],
                             "kernel_calls": rec["kernel_calls"], "tp": rec["tp"],
                             "flops": rec["cost"]["hlo_flops_per_device"],
                             "peak_bytes": rec["memory"]["peak_bytes"],
                             "wire_bytes_by_axis":
                                 rec["collectives"]["wire_bytes_by_axis"],
                             "by_kind": rec["collectives"]["by_kind"],
                             "peak_tensors": rec["memory"]["peak_tensors"]}
        except Exception as e:  # noqa: BLE001 — the status is what is compared
            records[cell] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
    return {"records": records}


def mesh2x2(_cells):
    """One prefill of reduced Minitron-4B cut to one layer (B=2, S=8) over a
    2 x 2 ``("data", "model")`` fake mesh under `default_plan()`: the
    collectives rank 0 issues, one by one, and its tensor-parallel counts."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeCell, get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.cost import StepCost
    from repro_torch.models import Model
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import default_plan
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = dataclasses.replace(get_reduced_config("minitron_4b"), num_layers=1)
    cell = ShapeCell("prefill_8", "prefill", 8, 2)
    mesh = mesh_lib.fake_mesh((2, 2), ("data", "model"), device="cpu")
    inputs = dryrun.build_step(Model(cfg, device="meta"), cell, mesh, default_plan())
    with FakeTensorMode():
        args = tuple(dryrun.place_fake(s, sh, torch.device("cpu"))
                     for s, sh in zip(inputs.structs, inputs.shardings))
        cost = StepCost(mesh)
        ctx.reset_tp_counts()
        with cost:
            inputs.step(*args)
    return {"collectives": cost.collectives, "summary": cost.summary(), "tp": ctx.tp_counts()}


def train2x2(_cells):
    """The train step of reduced Minitron-4B, Qwen1.5-MoE and MiniCPM3-4B
    (B=2, S=16, the plan `plan_for_cell` gives a train cell:
    sequence-parallel) over a 2 x 2 ``("data", "model")`` fake mesh: rank
    0's argument and peak bytes, every all-gather's result bytes, its
    tensor-parallel counts, every model-axis collective (kind, operand and
    result bytes, wire bytes), and the bytes of the whole parameter tree,
    of one layer, of the largest leaf of one layer and of the largest leaf
    outside the layers."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeCell, get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.cost import StepCost
    from repro_torch.models import Model, lm
    from repro_torch.sharding import ctx
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {}
    for arch in ("minitron_4b", "qwen2_moe_a2_7b", "minicpm3_4b"):
        cfg = get_reduced_config(arch)
        cell = ShapeCell("train_16", "train", 16, 2)
        mesh = mesh_lib.fake_mesh((2, 2), ("data", "model"), device="cpu")
        plan = dryrun.plan_for_cell(cfg, cell, False)
        model = Model(cfg, device="meta")
        inputs = dryrun.build_step(model, cell, mesh, plan)
        nbytes = {name: p.numel() * p.element_size() for name, p in tree_util.items(model.params)}
        with FakeTensorMode():
            args = tuple(dryrun.place_fake(s, sh, torch.device("cpu"))
                         for s, sh in zip(inputs.structs, inputs.shardings))
            cost = StepCost(mesh)
            cost.add_arguments(args)
            ctx.reset_tp_counts()
            with cost:
                inputs.step(*args)
        summary = cost.summary()
        out[arch] = {
            "sequence_parallel": plan.sequence_parallel,
            "whole_tree": sum(nbytes.values()),
            "one_layer": sum(b for k, b in nbytes.items() if k.startswith("layers/"))
            // lm.n_scan_steps(cfg),
            "largest_other": max(b for k, b in nbytes.items() if not k.startswith("layers/")),
            "largest_layer_leaf": max(b for k, b in nbytes.items() if k.startswith("layers/"))
            // lm.n_scan_steps(cfg),
            "argument_bytes": summary["argument_bytes"],
            "peak_bytes": summary["argument_bytes"] + summary["peak_transient"],
            "all_gathers": [c["result_bytes"] for c in cost.collectives
                            if c["kind"] == "all-gather"],
            "by_kind": summary["collectives"]["by_kind"], "tp": ctx.tp_counts(),
            "model": [{k: c[k] for k in ("kind", "operand_bytes", "result_bytes", "wire_bytes")}
                      for c in cost.collectives if c["axis"] == "model"],
            "wire_model": summary["collectives"]["wire_bytes_by_axis"].get("model", 0.0)}
    return out


if __name__ == "__main__":
    side, cells = sys.argv[1], sys.argv[2].split(",")
    out = {"reference": reference, "port": port, "mesh2x2": mesh2x2,
           "train2x2": train2x2}[side](cells)
    print(json.dumps(out), flush=True)
