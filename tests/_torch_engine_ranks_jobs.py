"""Jobs run by `tests/test_torch_engine_ranks.py` on a 4-rank gloo mesh on
the CPU, one spawned process per rank (`_torch_dist_jobs.run_job` with
``module="_torch_engine_ranks_jobs"``). Nothing here imports JAX.

  * ``uneven``: the sharded train step on microbatches whose rows do not
    split evenly over the batch axes (2 rows over 4 ranks, 3 over 2),
    against the one-device step;
  * ``engine``: a `ServingCluster` over the rank mesh whose engine spans
    the ranks a plan resolves to: a few requests served, reconfigured 1 ->
    4 -> 2 (pod 0) -> 4 ranks with requests resident, one lane exported and
    imported, the pod-forbidding validator on the pinned and the spanning
    plan.

To debug a part alone: ``DIST_JOB_TRACE=1`` prints each part as a rank
enters it, and ``ENGINE_PARTS=engine:qwen2_moe_a2_7b:2x2x1,uneven:minitron_4b:1x2x2``
picks the parts ``engine_ranks_job`` runs.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from _torch_dist_jobs import LR, WD, _fp32, _full, _meshes, _part, _train_check

ENGINE_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "jamba_v0_1_52b")
UNEVEN_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b")
#: (mesh, global batch, accumulation): 2 rows a microbatch over the 4-way
#: (pod, data) split, 3 rows over the 2-way data split
UNEVEN = {"2x2x1": (8, 4), "1x2x2": (6, 2)}
S_TRAIN = 16

#: the serving case both packages run (`tests/_torch_engine_ranks_ref.py`)
N_SLOTS, S_MAX, PAGE, WATERMARK = 4, 32, 8, 3
PROMPT_LENS = (5, 9, 5, 11, 9, 5)
MAX_NEW = (7, 9, 8, 6, 9, 7)
#: steps between the events of the case: reconfigure to all ranks after
#: step 1, to pod 0 after step 3, back to all after step 5; the lane is
#: exported and imported after step 6
SCHEDULE = (1, 3, 5, 6)


def _requests(cfg):
    rng = np.random.default_rng(11)
    return [rng.integers(2, cfg.vocab_size, size=n).astype(np.int64) for n in PROMPT_LENS]


def _parts():
    spec = os.environ.get("ENGINE_PARTS")
    if spec:
        return [tuple(p.split(":")) for p in spec.split(",")]
    return ([("uneven", a, m) for a in UNEVEN_ARCHS for m in sorted(UNEVEN)]
            + [("engine", a, m) for a in ENGINE_ARCHS for m in ("1x2x2", "2x2x1")]
            + [("refuse", "minitron_4b", "2x2x1")])


def engine_ranks_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    for kind, arch, mname in _parts():
        fn = {"uneven": _uneven_part, "engine": _engine_part, "refuse": _refuse_part}[kind]
        _part(out, f"{kind}/{arch}/{mname}", fn, arch, mname, *meshes[mname])
    return out


# ---------------------------------------------------------------------------
# A: the sharded train step on an uneven microbatch split
# ---------------------------------------------------------------------------


def _uneven_part(arch, mname, mesh, plan):
    from repro_torch.configs import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import jit_train_step, make_train_step, named
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import batch_specs, param_specs
    from repro_torch.sharding.ctx import place_tree
    gb, accum = UNEVEN[mname]
    cfg = _fp32(arch)
    opt = AdamW(lr=LR, weight_decay=WD)
    ds = SyntheticLM(cfg.vocab_size, S_TRAIN, gb, seed=4, device="cpu")
    cell = ShapeCell("t", "train", S_TRAIN, gb)
    ref = Model(cfg, device="cpu")
    ref_state = opt.init(ref.params)
    _, _, ref_loss, ref_metrics = make_train_step(ref, opt, accum_steps=accum)(
        ref.params, ref_state, ds.batch_at(1))
    model = Model(cfg, device="cpu")
    params = place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    state = opt.init(params)
    step = jit_train_step(model, opt, mesh, plan, cell, accum_steps=accum)
    batch = ds.sharded_batch_at(1, named(mesh, batch_specs(cfg, plan, cell)))
    params, state, loss, metrics = step(params, state, batch)
    return {
        "micro_rows": gb // accum,
        "loss": float(_full(loss)), "ref_loss": float(ref_loss),
        "metrics": {k: float(_full(v)) for k, v in metrics.items()},
        "ref_metrics": {k: float(v) for k, v in ref_metrics.items()},
        "params": _train_check(params, ref.params, moments=False),
        "m": _train_check(state["m"], ref_state["m"], moments=True),
        "v": _train_check(state["v"], ref_state["v"], moments=True)}


# ---------------------------------------------------------------------------
# B: the engine across ranks
# ---------------------------------------------------------------------------


def _weights(arch, cfg):
    """The reference's weights of ``arch`` (written by the test module from
    `conftest.build_tiny_model`), on the CPU."""
    import pickle

    from repro_torch import bridge
    with open(os.path.join(os.environ["ENGINE_WEIGHTS"], f"{arch}.pkl"), "rb") as f:
        return bridge.params_from_numpy(cfg, pickle.load(f), device="cpu")


def _plans(plan):
    """The case's plans: every rank, pod 0, and every rank under a route
    that forbids the pod axis."""
    return {"all": plan, "pod0": plan.with_(device_constraints=(("pod", 0),)),
            "nopod": plan.with_(forbidden_collective_axes=("pod",))}


def _engine_part(arch, mname, mesh, plan):
    """The serving case: 6 requests on one engine over ``mesh``, swapped 1 ->
    every rank -> pod 0 -> every rank (claiming a pod-free route), a lane
    exported and imported, served to the end. Records what the reference's
    run records (`tests/_torch_engine_ranks_ref.py`)."""
    import torch.distributed as dist

    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingCluster, ServingEngine, kvpool
    from repro_torch.sharding import ShardingPlan
    cfg = _fp32(arch)
    model = Model(cfg, _weights(arch, cfg), device="cpu")
    cluster = ServingCluster(mesh, device="cpu")
    paged = kvpool.supports_paging(model)
    eng = ServingEngine(model, n_slots=N_SLOTS, s_max=S_MAX, page_size=PAGE,
                        watermark=WATERMARK if paged else 0, device="cpu")
    cluster.register("e0", eng)
    cluster.set_route_constraint("phi", ShardingPlan(forbidden_collective_axes=("pod",)))
    for i, prompt in enumerate(_requests(cfg)):
        cluster.submit(Request(rid=i, prompt=prompt, max_new_tokens=MAX_NEW[i]))
    plans = _plans(plan)
    out = {"steps": [], "reports": [], "verdicts": {}, "layouts": []}

    def note():
        out["steps"].append({"free_pages": eng.pool.free_pages if paged else eng.free_slots,
                             "queued": len(eng.queue),
                             "resident": sum(r is not None for r in eng.slot_req)})

    def swap(key):
        resident = sum(r is not None for r in eng.slot_req)
        try:
            rep = cluster.reconfigure("e0", plans[key])
            verdict = "pass"
        except ValueError as e:
            rep, verdict = cluster.history[-1], "fail: " + str(e)[:200]
        out["reports"].append({"to": key, "migrate_bytes": rep.migrate_bytes,
                               "compiled": rep.compiled_in_prepare, "resident": resident,
                               "completed_before": rep.metrics_before["completed"]})
        out["verdicts"][key] = verdict
        out["layouts"].append({"members": list(eng.ranks),
                               "local_params": sum(v.to_local().numel() for v in _leaves(eng.params))
                               if eng.params is not None else None,
                               "shard_params": _shard_numel(eng)})

    for k, until in enumerate(SCHEDULE):
        while len(out["steps"]) < until:
            cluster.step()
            note()
        if k < 3:
            swap(("all", "pod0", "nopod")[k])
    resident = [r for r in eng.slot_req if r is not None]
    rid = min(r.rid for r in resident)
    snap = eng.export_slot(rid)
    moved = eng.import_slot(snap)
    out["migration"] = {"rid": rid, "pos": snap.pos, "nbytes": snap.nbytes, "moved": moved}
    while eng.queue or any(r is not None for r in eng.slot_req):
        cluster.step()
        note()
    out["streams"] = {r.rid: list(r.tokens_out) for r in eng.done}
    out["stats"] = dict(eng.decode_stats)
    out["rank"] = dist.get_rank()
    if out["rank"] == 0:
        # the same requests on one engine that never leaves one device (on
        # rank 0 alone, the rank the test reads: a one-device run needs no
        # other rank, and the others go on to the next part meanwhile)
        solo = ServingEngine(model, n_slots=N_SLOTS, s_max=S_MAX, page_size=PAGE,
                             watermark=WATERMARK if paged else 0, device="cpu")
        for i, prompt in enumerate(_requests(cfg)):
            solo.submit(Request(rid=i, prompt=prompt, max_new_tokens=MAX_NEW[i]))
        solo.run()
        out["solo_streams"] = {r.rid: list(r.tokens_out) for r in solo.done}
    return out


def _shard_numel(eng):
    """The elements of this rank's shard of every param leaf under the
    engine's layout, by DTensor's chunk rule on the plan's specs (its
    model-axis shards included); None on one device."""
    if eng.layout is None:
        return None
    from repro_torch import tree as tree_util
    from repro_torch.sharding import ctx
    sh = dict(tree_util.items(eng.layout["params"]))
    return sum(int(np.prod(ctx.local_shape_and_offset(tuple(x.shape), sh[k])[0]))
               for k, x in tree_util.items(eng.model.params))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _refuse_part(arch, mname, mesh, plan):
    """Layouts the reference's jit refuses are refused at PREPARE, on every
    rank: 2 decode lanes over the 4-way (pod, data) split, and a pool of 18
    pages over it; the engine keeps serving on one device."""
    from repro_torch.models import Model
    from repro_torch.serving import ServingCluster, ServingEngine
    cfg = _fp32(arch)
    model = Model(cfg, _weights(arch, cfg), device="cpu")
    out = {}
    for name, kw in (("lanes", dict(n_slots=2, s_max=32, page_size=8, watermark=3)),
                     ("pages", dict(n_slots=4, s_max=32, page_size=8, watermark=1))):
        cluster = ServingCluster(mesh, device="cpu")
        eng = ServingEngine(model, device="cpu", **kw)
        cluster.register("e0", eng)
        try:
            cluster.reconfigure("e0", plan)
            out[name] = "swapped"
        except ValueError as e:
            out[name] = str(e)
        out[name + "_layout"] = eng.layout is None
    return out
