#!/usr/bin/env python3
"""One-card train steps of two checkouts of the port, in turns, in one call:
what a change does to the unsharded step's time.

    python3 tools/train_step_ab.py --base scratch/parent [--order bccb] [--arch minitron_4b]

``b`` runs the base checkout (another tree's ``src/``, e.g. the parent
commit unpacked with ``git archive`` into ``scratch/``), ``c`` this
checkout. Each run is a process of its own: the config at full width (bf16
params, fp32 AdamW moments, LR 1e-4, random weights from seed 0), the
train phase's batch of `chip_smoke.py` (B=2 x S=1024 for Minitron-4B with
the loss in chunks of 256, B=4 x S=1024 for Mamba2-370m), `STEPS` steps
through `make_train_step`; it prints the median of the warm steps (host
clock around each step, ending in the loss's read), the loss-and-gradients
part of one more step, and the peak memory.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8
SHAPES = {"minitron_4b": (2, 1024, 256), "mamba2_370m": (4, 1024, None)}


def one(src: str, arch: str) -> dict:
    """The runs of one checkout (this process)."""
    sys.path.insert(0, str(Path(src) / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    B, S, chunk = SHAPES[arch]
    cfg = get_config(arch)
    model = Model(cfg, device="cuda", seed=0, loss_chunk=chunk)
    opt = AdamW(lr=1e-4)
    state = opt.init(model.params)
    step = steps.make_train_step(model, opt)
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=0, device="cuda")
    batches = [ds.batch_at(i) for i in range(STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for b in batches[:STEPS]:
        t0 = time.perf_counter()
        _, state, loss, _ = step(model.params, state, b)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = steps._loss_and_grads(model, model.params, batches[STEPS])
    float(loss)
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    warm = sorted(ms[1:])
    return {"src": src, "arch": arch, "ms": ms, "median_warm_ms": warm[len(warm) // 2],
            "loss_and_grads_ms": grad_ms, "losses": losses,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", default=None, help="the other checkout (its root)")
    ap.add_argument("--order", default="bccb")
    ap.add_argument("--arch", default="minitron_4b", choices=sorted(SHAPES))
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.arch)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"], capture_output=True,
                          text=True, check=True).stdout.strip()
    trees = {"b": args.base, "c": str(ROOT)}
    out = []
    for k in args.order:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", trees[k],
                               "--arch", args.arch], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"train_step_ab: the {k} run failed:\n{proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        out.append(r)
        print(f"[train ab] {k} {r['src']} {args.arch}: warm step {r['median_warm_ms']:.1f} ms "
              f"(median of {STEPS - 1}; all {' '.join(f'{x:.1f}' for x in r['ms'])}), loss and "
              f"gradients {r['loss_and_grads_ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, losses "
              f"{' '.join(f'{x:.4f}' for x in r['losses'])}  [{card}]", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"train_ab_{args.arch}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
