#!/usr/bin/env python3
"""Tensor-parallel serving emulated on ONE card: two threads, each one rank
of a model axis of 2, against the same config served whole.

    python3 tools/tp_emulate.py [--device cpu]

Each thread holds its rank's cut of the seeded weights as plain tensors
(the model-axis dim of every group `lm.tp_groups` runs local, and the
vocab), and runs the model's own prefill and three greedy decode steps
with the card's kernels; the collectives of a tensor-parallel step
(`sharding.ctx.tp`, `tp_sum`, `tp_gather`) are exchanged between the two
threads at a barrier, in rank order, as an all-reduce and an all-gather
over two ranks compute them. What runs on the card is every line of the
tensor-parallel model code; what does not is NCCL and the FSDP gathers
(`tools/engine_ranks.py` runs those on four cards).

It prints, per case, each step's logits against the whole model's
(max |diff| and the step's largest logit), whether the greedy picks are
equal, and the first MoE call (prefill through the MoE top-k kernel, then
decode) where a token's expert picks differ, with the one-card router
logits' gap between the k-th and the next expert there and the router
logits' max |diff| up to it: in bf16 a tensor-parallel layer's partial
sums round otherwise, and a near-tie then picks another expert. The cases:
Qwen1.5-MoE whole in bf16 and at 12 layers in fp32, Jamba-v0.1 at 8
layers in bf16 (full width; the reduced configs with ``--device cpu``).
"""
from __future__ import annotations

import argparse
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
N = 2                   # ranks of the emulated model axis
B, S, NEW = 4, 64, 3

_TL = threading.local()
_BAR = threading.Barrier(N)
_SLOTS: list = [None] * N


def _exchange(x):
    """Every emulated rank's ``x``, in rank order."""
    _SLOTS[_TL.r] = x
    _BAR.wait()
    out = list(_SLOTS)
    _BAR.wait()
    return out


def _on() -> bool:
    return getattr(_TL, "on", False)


def _install(ctx) -> None:
    """The model axis's collectives over the two threads."""
    ctx.tp = lambda: (N, _TL.r) if _on() else (1, 0)
    ctx.tp_axis = lambda: "model" if _on() else None
    ctx.tp_sum = lambda x: functools.reduce(operator.add, _exchange(x)) if _on() else x
    ctx.tp_gather = lambda x, dim: __import__("torch").cat(_exchange(x), dim) if _on() else x


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
    from repro_torch.sharding.plan import Mesh, default_plan, param_specs
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
    specs = dict(tree_util.items(param_specs(cfg, plan)))
    res = {}

    def rank(r):
        _TL.r, _TL.on = r, True
        routing.start()
        try:
            with torch.no_grad(), ctx.activation_sharding(mesh, plan, tensor_parallel=True):
                groups = lm.tp_groups(cfg)
                local = lm._local_paths(cfg, groups)
                leaves = []
                for name, x in tree_util.items(model.params):
                    sub = name[len("layers/"):] if name.startswith("layers/") else None
                    if sub in local or (name in ("embed", "lm_head") and groups["vocab"]):
                        spec = specs[name]
                        d = next(i for i in range(len(spec)) if "model" in spec.axes(i))
                        w = x.shape[d] // N
                        x = x.narrow(d, r * w, w).contiguous()
                    leaves.append(x)
                ctx.reset_tp_counts()
                steps = serve(tree_util.like(model.params, leaves),
                              lm.tp_cache_local(cfg, groups), r)
                res[r] = (steps, ctx.tp_counts(), routing.take())
        except Exception:
            import traceback
            res[r] = traceback.format_exc()
            _BAR.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(N)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(N):
        if isinstance(res.get(r), str):
            raise SystemExit(f"tp_emulate: rank {r} failed:\n{res[r]}")
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
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
    _install(ctx)
    routing = _Routing()
    for arch, layers, dtype in CASES:
        run_case(torch.device(args.device), reduced, routing, arch, layers, dtype, card)
        if not reduced:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
