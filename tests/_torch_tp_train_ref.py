"""The reference's side of `tests/test_torch_tp_train.py`, run in a process
of its own (``python tests/_torch_tp_train_ref.py WEIGHTS_DIR OUT.npz
CASES``) over four placeholder host devices (``XLA_FLAGS``, set before JAX
starts, also keeps XLA's CPU work on one intra-op thread), printing one
JSON line.

For each case ``arch:mesh:sp:accum:dtype`` (`_torch_tp_train_jobs.CASES`)
it runs the reference's `jit_train_step` once on a ``jax.sharding.Mesh`` of
that shape under the mesh's default plan, ``sequence_parallel`` as the
reference's `plan_for_cell` sets it for a train cell ("sp") or off
("nosp"), from the port's seeded weights (the pickles the test module
wrote), a zeroed AdamW state and `_torch_tp_train_jobs.train_batch`. The
loss, the metrics, the params and the moments go to ``OUT.npz`` as
``{case}|{name}``.
"""
import json
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"


def case(weights_dir, arch, mname, sp, accum, dtype):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from _torch_tp_jobs import odd_config
    from _torch_tp_train_jobs import B, LR, S, WD, train_batch

    from repro.configs import get_reduced_config
    from repro.configs.base import ShapeCell
    from repro.launch.dryrun import plan_for_cell
    from repro.launch.steps import jit_train_step
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.sharding import default_plan
    base = arch[4:] if arch.startswith("odd_") else arch
    cfg = dataclasses.replace(get_reduced_config(base), param_dtype="float32",
                              activ_dtype="float32")
    if arch.startswith("odd_"):     # cut to 3 heads: the partitioner pads them
        cfg = odd_config(cfg, base)
    model = build_model(cfg)
    with open(os.path.join(weights_dir, f"{arch}.pkl"), "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    shape = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}[mname]
    cell = ShapeCell("t", "train", S, B)
    on = plan_for_cell(cfg, cell, False).sequence_parallel and sp == "sp"
    plan = (default_plan() if mname == "1x2x2" else default_plan(multi_pod=True)).with_(
        sequence_parallel=on)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                             ("pod", "data", "model"))
    opt = AdamW(lr=LR, weight_decay=WD)
    step = jit_train_step(model, opt, mesh, plan, cell, accum_steps=int(accum),
                          grad_reduce_dtype=None if dtype == "fp32" else dtype)
    batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
    params, state, loss, metrics = step(params, opt.init(params), batch)
    out = {"loss": np.asarray(loss), **{f"metric/{k}": np.asarray(v) for k, v in metrics.items()}}
    for key, tree in (("params", params), ("m", state["m"]), ("v", state["v"])):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{key}/" + "/".join(str(k.key) for k in path)] = np.asarray(x, np.float32)
    return out


def main():
    weights_dir, out_path, cases = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    arrays, status = {}, {}
    import time
    for c in cases:
        t0 = time.perf_counter()
        try:
            for k, x in case(weights_dir, *c.split(":")).items():
                arrays[f"{c}|{k}"] = x
            status[c] = {"status": "ok", "seconds": time.perf_counter() - t0}
        except Exception as e:  # noqa: BLE001 — the status is what is compared
            import traceback
            status[c] = {"status": "error", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-3000:]}
    import numpy as np
    np.savez(out_path, **arrays)
    print(json.dumps(status), flush=True)


if __name__ == "__main__":
    main()
