"""The reference's side of `tests/test_torch_tp_serving.py`, run in a process
of its own (``python tests/_torch_tp_ref.py WEIGHTS_DIR OUT.npz CASES``) over
four placeholder host devices (``XLA_FLAGS``, set before JAX starts, also
keeps XLA's CPU work on one intra-op thread), printing one JSON line.

For each case ``arch:mesh`` it runs the reference's `jit_prefill` and four
`jit_decode_step`s on a ``jax.sharding.Mesh`` of that shape under the mesh's
plan, with the port's seeded weights (the pickles the test module wrote)
and the prompts of `_torch_tp_jobs.prompt_batch`: the prefill cache written
into a zeroed fp32 cache of ``S_PROMPT + N_NEW + 1`` positions, each step
fed its own greedy pick. A case ``arch:seq2`` or ``arch:seq1`` runs on
``(1, 2, 2)`` under `_torch_tp_jobs.seq_plan` (the cache's sequence over
the model axis with `SEQ_ROWS` rows, or over the data and model axes with
one), from `SEQ_PROMPT` tokens in a cache of `SEQ_S_MAX` positions. A case
``arch:odd`` runs the config cut to 3 heads (`_torch_tp_jobs.odd_config`,
the weights of ``odd_<arch>.pkl``) on ``(1, 2, 2)`` under `default_plan()`,
where the reference's partitioner pads the heads over the model axis of 2.
Every step's logits go to ``OUT.npz`` as ``{arch}:{mesh}:{step}``.
"""
import json
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
os.environ["JAX_PLATFORMS"] = "cpu"

POSITIONAL = ("k", "v", "ckv", "kpe")


def case(weights_dir, arch, mname):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from _torch_tp_jobs import (N_NEW, S_PROMPT, SEQ_PROMPT, SEQ_ROWS, SEQ_S_MAX, odd_config,
                                prompt_batch, seq_plan)

    from repro.configs import get_reduced_config
    from repro.configs.base import ShapeCell
    from repro.launch.steps import jit_decode_step, jit_prefill
    from repro.models import build_model
    from repro.sharding import default_plan
    cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                              activ_dtype="float32")
    name = arch
    if mname == "odd":
        cfg, name = odd_config(cfg, arch), f"odd_{arch}"
    model = build_model(cfg)
    with open(os.path.join(weights_dir, f"{name}.pkl"), "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    shape = {"2x2x1": (2, 2, 1)}.get(mname, (1, 2, 2))
    s_prompt, s_max, rows = S_PROMPT, S_PROMPT + N_NEW + 1, None
    if mname in ("seq2", "seq1"):
        plan = seq_plan(arch, mname, default_plan)
        s_prompt, s_max = SEQ_PROMPT, SEQ_S_MAX
        rows = SEQ_ROWS if mname == "seq2" else 1
    else:
        plan = default_plan() if mname == "1x2x2" else default_plan(multi_pod=True)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                             ("pod", "data", "model"))
    batch = {k: np.asarray(v) for k, v in
             (prompt_batch(cfg, rows, s_prompt) if rows else prompt_batch(cfg)).items()}
    B = batch["tokens"].shape[0]
    prefill = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", s_prompt, B))
    decode = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, B))
    logits, cache = prefill(params, batch)
    zero = model.init_cache(B, s_max, dtype=jnp.float32)

    def fill(path, z, c):
        z, c = np.asarray(z).copy(), np.asarray(c)
        if path[-1].key in POSITIONAL:
            z[:, :, :c.shape[2]] = c
        else:
            z[...] = c
        return z

    cache = jax.tree_util.tree_map_with_path(fill, zero, cache)
    out = [np.asarray(logits)]
    for i in range(N_NEW + 1):
        tok = np.argmax(out[-1][:, :cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
        if i == N_NEW:
            break
        logits, cache = decode(params, tok, cache, np.int32(s_prompt + i))
        cache = jax.tree.map(np.asarray, cache)
        out.append(np.asarray(logits))
    return out


def main():
    weights_dir, out_path, cases = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    arrays, status = {}, {}
    import time
    for c in cases:
        arch, mname = c.split(":")
        t0 = time.perf_counter()
        try:
            for i, x in enumerate(case(weights_dir, arch, mname)):
                arrays[f"{c}:{i}"] = x
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
