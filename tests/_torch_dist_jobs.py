"""Jobs run by `tests/test_torch_sharding_dist.py` on a 4-rank gloo mesh on
the CPU, one spawned process per rank.

`run_job` spawns the ranks, each of which runs a job's parts in turn and
saves what it found; a part that raises records its error and the job goes
on. Nothing here imports JAX: the sharded port is held to the one-device
port, computed in the same process from the same weights.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m", "jamba_v0_1_52b", "whisper_large_v3")
TRAIN_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b")
B, S_PROMPT, N_NEW = 4, 8, 3
B_TRAIN, S_TRAIN = 8, 16
LR, WD = 1e-3, 0.1


def run_job(job: str, world: int = 4, timeout: float = 1200.0,
            module: str = "_torch_dist_jobs", stall: float = 300.0) -> list:
    """Run ``job`` (a function of ``module``, this one by default:
    ``job(rank, world)`` -> dict) on ``world`` spawned ranks over gloo;
    returns each rank's dict. The ranks are killed when no rank has
    finished a part (`_part`) for ``stall`` seconds (a rank that raised
    inside a collective leaves the others waiting), or when the job has run
    ``timeout`` seconds in all. Both limits are far above the job's time
    on a loaded machine: a part is a few seconds alone, and the whole
    test suite's other workers may slow it several times.

    Raises:
        RuntimeError: a rank died, or the job stalled or timed out.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(job, r, world, tmp, module))
                 for r in range(world)]
        for p in procs:
            p.start()
        start = last = time.monotonic()
        seen = 0
        why = None
        while any(p.is_alive() for p in procs):
            time.sleep(0.5)
            now = time.monotonic()
            done = sum(len(f.read_text()) for f in Path(tmp).glob("progress*"))
            if done != seen:
                seen, last = done, now
            if now - last > stall:
                why = f"stalled: no part finished for {stall:.0f} s"
            elif now - start > timeout:
                why = f"timed out after {timeout:.0f} s"
            if why:
                break
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        for p in procs:
            p.join()
        if alive:
            raise RuntimeError(f"job {job} {why}")
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"job {job}: exit codes {[p.exitcode for p in procs]}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


#: where this rank notes each part it finishes (`run_job`'s stall check)
_PROGRESS: list = []


def _rank_main(job: str, rank: int, world: int, tmp: str,
               module: str = "_torch_dist_jobs") -> None:
    import importlib
    import logging

    import torch.distributed as dist
    torch.set_num_threads(1)
    _PROGRESS.append(Path(tmp) / f"progress{rank}")
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = getattr(importlib.import_module(module), job)(rank, world)
    finally:
        dist.barrier()
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def _part(out: dict, name: str, fn, *args) -> None:
    if os.environ.get("DIST_JOB_TRACE"):
        print(f"[{out['rank']}] {time.strftime('%H:%M:%S')} {name}", flush=True)
    t0 = time.perf_counter()
    try:
        out[name] = fn(*args)
    except Exception:
        out[name] = {"error": traceback.format_exc()}
    out.setdefault("seconds", {})[name] = time.perf_counter() - t0
    for f in _PROGRESS:
        with open(f, "a") as fh:
            fh.write(".")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _fp32(arch):
    from repro_torch.configs import get_reduced_config
    return dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                               activ_dtype="float32")


def _meshes():
    from repro_torch.sharding import default_plan, rank_mesh
    return {"1x2x2": (rank_mesh((1, 2, 2), device="cpu"), default_plan()),
            "2x2x1": (rank_mesh((2, 2, 1), device="cpu"), default_plan(multi_pod=True))}


def _full(x):
    from repro_torch.sharding.ctx import full
    return full(x)


def _prompt_batch(cfg):
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(
        rng.integers(2, cfg.vocab_size, size=(B, S_PROMPT)).astype(np.int32))}
    if cfg.encdec is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return batch


def _decode_cache(model, cache, s_max):
    """A prefill cache written into a zeroed fp32 cache of ``s_max``."""
    from repro_torch.models.lm import is_positional
    enc = model.cfg.encdec
    out = model.init_cache(B, s_max, dtype=torch.float32,
                           enc_len=enc.encoder_seq_len if enc else None)
    for k, v in cache.items():
        if is_positional(k) and not k.startswith("cross/"):
            out[k][:, :, :v.shape[2]] = v
        else:
            out[k].copy_(v)
    return out


def _greedy(prefill_out, decode, cache_of, n):
    logits, cache = prefill_out
    cache = cache_of(cache)
    toks, all_logits = [], [_full(logits)]
    for i in range(n):
        tok = _full(logits).argmax(-1).to(torch.int32)
        toks.append(tok)
        logits, cache = decode(tok[:, None], cache, torch.tensor(S_PROMPT + i))
        all_logits.append(_full(logits))
    toks.append(_full(logits).argmax(-1).to(torch.int32))
    return torch.stack(toks, 1), all_logits, cache


def _excess(got, want, atol=1e-5, rtol=1e-5):
    """How far ``got`` is outside atol + rtol of ``want`` at its worst
    element (<= 0: within)."""
    return float(((got - want).abs() - atol - rtol * want.abs()).max())


def _train_check(got_tree, want_tree, *, moments):
    """The train-step tolerance of `tests/test_torch_train_step.py`: each
    leaf's count of coordinates outside atol + rtol, and of those, how many
    are outside the sign-flip bound (params only)."""
    from repro_torch import tree as tree_util
    bad = flips = total = 0
    for (name, g), (_, w) in zip(tree_util.items(got_tree), tree_util.items(want_tree)):
        g, w = _full(g).double(), w.double()
        total += w.numel()
        if moments:
            bad += int((~torch.isclose(g, w, atol=1e-7, rtol=1e-4)).sum())
            continue
        off = ~torch.isclose(g, w, atol=1e-6, rtol=1e-5)
        flips += int(off.sum())
        bad += int((off & ((g - w).abs() > 2 * LR * (1 + WD) + 1e-6)).sum())
    return {"bad": bad, "flips": flips, "total": total}


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------


def sharding_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    _part(out, "shardings", _shardings_part, meshes)
    _part(out, "restricted", _restricted_part, meshes)
    _part(out, "batch", _batch_part, meshes)
    for arch in ARCHS:
        for mname, (mesh, plan) in meshes.items():
            _part(out, f"serve/{arch}/{mname}", _serve_part, arch, mesh, plan)
    for arch in TRAIN_ARCHS:
        for mname, (mesh, plan) in meshes.items():
            for accum in (1, 2):
                for shard_grads in (True, False):
                    _part(out, f"train/{arch}/{mname}/{accum}/{shard_grads}", _train_part,
                          arch, mesh, plan, accum, shard_grads)
    _part(out, "checkpoint", _checkpoint_part, meshes)
    _part(out, "collectives", _collectives_part, meshes)
    return out


def _shardings_part(meshes):
    from repro_torch import tree as tree_util
    from repro_torch.models import Model
    from repro_torch.sharding import plan_to_shardings
    from repro_torch.sharding.ctx import place
    res = {}
    for mname, (mesh, plan) in meshes.items():
        for arch in ("minitron_4b", "mamba2_370m"):
            cfg = _fp32(arch)
            model = Model(cfg, device="cpu")
            sh = plan_to_shardings(cfg, plan, mesh, n_slots=B)
            cache = model.init_cache(B, 16, dtype=torch.float32)
            for k in cache:
                cache[k].normal_(generator=torch.Generator().manual_seed(len(k)))
            for kind, tree in (("params", model.params), ("cache", cache)):
                flat = dict(tree_util.items(sh[kind]))
                for name, leaf in tree_util.items(tree):
                    d = place(leaf, flat[name])
                    res[(mname, arch, kind, name)] = {
                        "shape": tuple(leaf.shape), "local": tuple(d.to_local().shape),
                        "spec": tuple(flat[name].spec),
                        "coord": tuple(mesh.device_mesh().get_coordinate()),
                        "equal": bool(torch.equal(d.full_tensor(), leaf))}
    return res


def _restricted_part(meshes):
    """A plan pinned to ``("data", 1)`` on the 1x2x2 mesh: its sub-mesh is
    ranks 2 and 3; every rank makes it, the others hold nothing."""
    from repro_torch.sharding import plan_to_shardings
    from repro_torch.sharding.ctx import local_range, place
    mesh, plan = meshes["1x2x2"]
    pinned = plan.with_(device_constraints=(("data", 1),))
    cfg = _fp32("minitron_4b")
    sh = plan_to_shardings(cfg, pinned, mesh, n_slots=B)
    again = plan_to_shardings(cfg, pinned, mesh, n_slots=B)
    w = torch.arange(cfg.d_model * 24, dtype=torch.float32).reshape(cfg.d_model, 24)
    leaf = sh["params"]["lm_head"] if "lm_head" in sh["params"] else sh["params"]["embed"]
    d = place(w, leaf)
    return {"sub_ranks": leaf.mesh.mesh.flatten().tolist(),
            "cached": again["params"]["embed"].mesh is sh["params"]["embed"].mesh,
            "coord": leaf.mesh.get_coordinate(),
            "local": tuple(d.to_local().shape),
            "range": local_range(w.shape, leaf, dim=1)}


def _batch_part(meshes):
    from repro_torch.configs import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import named
    from repro_torch.sharding import batch_specs
    res = {}
    for mname, (mesh, plan) in meshes.items():
        for gb in (4, 6, 1):
            cfg = _fp32("minitron_4b")
            ds = SyntheticLM(cfg.vocab_size, 32, gb, seed=3, device="cpu")
            cell = ShapeCell("t", "train", 32, gb)
            sb = ds.sharded_batch_at(7, named(mesh, batch_specs(cfg, plan, cell)))
            whole = ds.batch_at(7)
            res[(mname, gb)] = {
                "local_rows": sb["tokens"].to_local().shape[0],
                "equal": all(torch.equal(sb[k].full_tensor(), whole[k]) for k in whole)}
    return res


def _serve_part(arch, mesh, plan):
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, jit_prefill
    from repro_torch.models import Model
    cfg = _fp32(arch)
    model = Model(cfg, device="cpu")
    batch = _prompt_batch(cfg)
    s_max = S_PROMPT + N_NEW + 1
    with torch.no_grad():
        ref_prefill = model.prefill(batch)
        ref_toks, ref_logits, _ = _greedy(
            ref_prefill, model.decode_step, lambda c: _decode_cache(model, c, s_max), N_NEW)
    prefill = jit_prefill(model, mesh, plan, ShapeCell("p", "prefill", S_PROMPT, B))
    decode = jit_decode_step(model, mesh, plan, ShapeCell("d", "decode", s_max, B))
    params = {}
    from repro_torch.sharding import param_specs
    from repro_torch.launch.steps import named
    from repro_torch.sharding.ctx import place_tree
    params = place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    logits, cache = prefill(params, batch)
    cache_err = max(_excess(_full(cache[k]), ref_prefill[1][k]) for k in cache)
    toks, all_logits, _ = _greedy(
        (logits, cache), lambda t, c, p: decode(params, t, c, p),
        lambda c: _decode_cache(model, {k: _full(v) for k, v in c.items()}, s_max), N_NEW)
    err = [_excess(a, b) for a, b in zip(all_logits, ref_logits)]
    return {"tokens_equal": bool(torch.equal(toks, ref_toks)), "logit_excess": max(err),
            "cache_err": cache_err, "logits_placements": str(logits.placements),
            "dtensor_cache": all(hasattr(v, "placements") for v in cache.values())}


def _train_part(arch, mesh, plan, accum, shard_grads):
    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import jit_train_step, make_train_step, named
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import batch_specs, opt_state_specs, param_specs
    from repro_torch.sharding.ctx import place_tree
    cfg = _fp32(arch)
    opt = AdamW(lr=LR, weight_decay=WD)
    ds = SyntheticLM(cfg.vocab_size, S_TRAIN, B_TRAIN, seed=1, device="cpu")
    cell = ShapeCell("t", "train", S_TRAIN, B_TRAIN)
    ref = Model(cfg, device="cpu")
    ref_state = opt.init(ref.params)
    _, _, ref_loss, ref_metrics = make_train_step(ref, opt, accum_steps=accum)(
        ref.params, ref_state, ds.batch_at(2))
    model = Model(cfg, device="cpu")
    pspecs = param_specs(cfg, plan)
    params = place_tree(model.params, named(mesh, pspecs))
    state = opt.init(params)
    want = named(mesh, opt_state_specs(pspecs))
    placed_as_specs = all(tuple(s.placements) == tuple(x.placements) for s, x in zip(
        tree_util.leaves(want), tree_util.leaves(state)))
    step = jit_train_step(model, opt, mesh, plan, cell, accum_steps=accum,
                          shard_grads=shard_grads)
    batch = ds.sharded_batch_at(2, named(mesh, batch_specs(cfg, plan, cell)))
    params, state, loss, metrics = step(params, state, batch)
    return {
        "loss": float(_full(loss)), "ref_loss": float(ref_loss),
        "metrics": {k: float(_full(v)) for k, v in metrics.items()},
        "ref_metrics": {k: float(v) for k, v in ref_metrics.items()},
        "params": _train_check(params, ref.params, moments=False),
        "m": _train_check(state["m"], ref_state["m"], moments=True),
        "v": _train_check(state["v"], ref_state["v"], moments=True),
        "count": int(_full(state["count"])),
        "state_placed": placed_as_specs,
        "loss_placements": str(loss.placements)}


def _checkpoint_part(meshes):
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import jit_train_step, named
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import TrainRunner
    from repro_torch.sharding import opt_state_specs, param_specs
    from repro_torch.sharding.ctx import place_tree
    import torch.distributed as dist
    cfg = _fp32("minitron_4b")
    opt = AdamW(lr=LR, weight_decay=WD)
    (m1, p1), (m2, p2) = meshes["1x2x2"], meshes["2x2x1"]
    cell = ShapeCell("t", "train", S_TRAIN, B_TRAIN)
    obj = [tempfile.mkdtemp() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(obj, src=0)
    ckpt = obj[0]

    def runner(mesh, plan):
        model = Model(cfg, device="cpu")
        params = place_tree(model.params, named(mesh, param_specs(cfg, plan)))
        return TrainRunner(step_fn=jit_train_step(model, opt, mesh, plan, cell),
                           params=params, opt_state=opt.init(params),
                           dataset=SyntheticLM(cfg.vocab_size, S_TRAIN, B_TRAIN, device="cpu"),
                           ckpt_dir=ckpt, ckpt_every=2)

    first = runner(m1, p1)
    summary = first.run(3)
    saved = {k: _full(v) for k, v in tree_util.items({"params": first.params, "opt": first.opt_state})}
    second = runner(m2, p2)
    pspecs = param_specs(cfg, p2)
    sh = {"params": named(m2, pspecs), "opt": named(m2, opt_state_specs(pspecs))}
    restored = second.try_restore(shardings=sh)
    got = dict(tree_util.items({"params": second.params, "opt": second.opt_state}))
    step, direct = load_checkpoint(ckpt, {"params": second.params, "opt": second.opt_state},
                                   device="cpu", shardings=sh)
    want_pl = {k: tuple(s.placements) for k, s in tree_util.items(sh)}
    res = {
        "restored": restored, "step": second.step, "load_step": step,
        "losses": first.losses, "final_loss": summary["final_loss"],
        "equal": all(torch.equal(_full(got[k]), saved[k]) for k in saved),
        "direct_equal": all(torch.equal(_full(v), saved[k])
                            for k, v in tree_util.items(direct)),
        "placed": all(tuple(got[k].placements) == want_pl[k] for k in saved)}
    resumed = second.recover_and_run(4, shardings=sh)
    res["resumed"] = (resumed["steps"], resumed["restarts"])
    res["resumed_loss"] = resumed["final_loss"]
    return res


def _collectives_part(meshes):
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_decode_step, named
    from repro_torch.models import Model
    from repro_torch.serving.engine import trace_collectives
    from repro_torch.sharding import cache_specs, param_specs
    from repro_torch.sharding.ctx import place_tree
    out = {}
    for mname, (mesh, plan) in meshes.items():
        cfg = _fp32("minitron_4b")
        model = Model(cfg, device="cpu")
        cell = ShapeCell("d", "decode", 16, B)
        params = place_tree(model.params, named(mesh, param_specs(cfg, plan)))
        cache = place_tree(model.init_cache(B, 16, dtype=torch.float32),
                           named(mesh, cache_specs(cfg, plan, batch=B)))
        decode = jit_decode_step(model, mesh, plan, cell)
        tokens = torch.full((B, 1), 3, dtype=torch.int32)
        out[mname] = trace_collectives(lambda: decode(params, tokens, cache, torch.tensor(0)),
                                       torch.device("cpu"))
    return out


def debug_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    for part in os.environ["DIST_PARTS"].split(","):
        name, *args = part.split(":")
        if name == "serve":
            _part(out, part, _serve_part, args[0], *meshes[args[1]])
        elif name == "train":
            _part(out, part, _train_part, args[0], *meshes[args[1]], int(args[2]), args[3] == "1")
        else:
            _part(out, part, globals()[f"_{name}_part"], meshes)
    return out
