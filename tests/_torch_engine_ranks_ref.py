"""The reference's side of `tests/test_torch_engine_ranks.py`, run in a
process of its own (``python tests/_torch_engine_ranks_ref.py WEIGHTS_DIR
CASES``) over four placeholder host devices (``XLA_FLAGS``, set before JAX
starts, also keeps XLA's CPU work on one intra-op thread, so the child
takes one core beside the port's ranks), printing one JSON line.

For each case ``arch:mesh`` it runs `_torch_engine_ranks_jobs`'s serving
case with `repro.serving.ServingCluster` over a ``jax.sharding.Mesh`` of
that shape: the same weights (the pickles the test module wrote), requests,
swaps (1 -> every device -> pod 0 -> every device, claiming a route that
forbids ``pod``), export and import of a lane, and what the port's job
records: per step the free pages (or slots), queue and residents; per swap
the migrated bytes, the executables compiled, the residents and the
completions before it; the validator's verdicts; the migration's bytes; the
streams.
"""
import json
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"


def case(weights_dir, arch, mname):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from _torch_engine_ranks_jobs import (
        MAX_NEW,
        N_SLOTS,
        PAGE,
        S_MAX,
        SCHEDULE,
        WATERMARK,
        _requests,
    )

    from repro.configs import get_reduced_config
    from repro.models import build_model
    from repro.serving import Request, ServingCluster, ServingEngine, kvpool
    from repro.sharding import ShardingPlan, default_plan
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                              activ_dtype="float32")
    model = build_model(cfg)
    with open(os.path.join(weights_dir, f"{arch}.pkl"), "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    shape = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}[mname]
    plan = default_plan() if mname == "1x2x2" else default_plan(multi_pod=True)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                             ("pod", "data", "model"))
    cluster = ServingCluster(mesh)
    paged = kvpool.supports_paging(model)
    eng = ServingEngine(model, params, n_slots=N_SLOTS, s_max=S_MAX, page_size=PAGE,
                        watermark=WATERMARK if paged else 0)
    cluster.register("e0", eng)
    cluster.set_route_constraint("phi", ShardingPlan(forbidden_collective_axes=("pod",)))
    for i, prompt in enumerate(_requests(cfg)):
        cluster.submit(Request(rid=i, prompt=prompt.astype(np.int32),
                               max_new_tokens=MAX_NEW[i]))
    plans = {"all": plan, "pod0": plan.with_(device_constraints=(("pod", 0),)),
             "nopod": plan.with_(forbidden_collective_axes=("pod",))}
    out = {"steps": [], "reports": [], "verdicts": {}}

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

    try:
        run(cluster, eng, out, note, swap, SCHEDULE)
    except ValueError as e:
        # a fault of the reference: recorded with the step it stopped at
        out["fault"] = {"error": f"{type(e).__name__}: {str(e)[:600]}",
                        "at_step": len(out["steps"])}
    return out


def run(cluster, eng, out, note, swap, schedule):
    for k, until in enumerate(schedule):
        while len(out["steps"]) < until:
            cluster.step()
            note()
        if k < 3:
            swap(("all", "pod0", "nopod")[k])
    resident = [r for r in eng.slot_req if r is not None]
    rid = min(r.rid for r in resident)
    snap = eng.export_slot(rid)
    moved = eng.import_slot(snap)
    out["migration"] = {"rid": rid, "pos": int(snap.pos), "nbytes": int(snap.nbytes),
                        "moved": int(moved)}
    while eng.queue or any(r is not None for r in eng.slot_req):
        cluster.step()
        note()
    out["streams"] = {str(r.rid): [int(t) for t in r.tokens_out] for r in eng.done}


def main():
    weights_dir, cases = sys.argv[1], sys.argv[2].split(",")
    out = {}
    import time
    for c in cases:
        arch, mname = c.split(":")
        t0 = time.perf_counter()
        try:
            out[c] = case(weights_dir, arch, mname)
            out[c]["seconds"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — the status is what is compared
            import traceback
            out[c] = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
