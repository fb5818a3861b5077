#!/usr/bin/env python3
"""The first train steps of the train phase's models, on one CUDA card:
how the loss moves under each LR, and what Adam's first step changes.

    python3 tools/train_first_steps.py [--steps 8]

For each model of ``chip_smoke.py``'s train phase (full width, bf16 params,
fp32 AdamW moments, random weights from seed 0, the phase's batch shapes)
and each LR of a sweep (constant 1e-5, 3e-5, 1e-4, and the reference
example's ``warmup_cosine(3e-4, 20, 100)``), runs ``--steps`` steps of
`make_train_step` from a fresh model and prints the losses. Then, on
Minitron-4B and one batch: the loss before and after one step at LR 0, at
1e-5 (no decay, no clip) and at 1e-6, each with the leaves that step
changed most (max |change|, share of entries changed). Prints the card's
name and power limit first, and writes every figure to
``train_first_steps.json`` in ``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODELS = (("minitron_4b", 2, 1024, 256), ("mamba2_370m", 4, 1024, 256),
          ("whisper_large_v3", 2, 448, None))     # (arch, B, S, loss chunk)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, warmup_cosine

    cs.check(torch.cuda.is_available(), "no CUDA device: this tool needs one card")
    card = cs.phase_device()
    lrs = {"1e-5": lambda: 1e-5, "3e-5": lambda: 3e-5, "1e-4": lambda: 1e-4,
           "example": lambda: warmup_cosine(3e-4, 20, 100)}
    out = {"card": card, "sweep": {}, "first_step": []}
    for arch, B, S, chunk in MODELS:
        cfg = get_config(arch)
        cell = ShapeCell("train", "train", S, B)
        for name, lr in lrs.items():
            model = Model(cfg, device="cuda", seed=0, loss_chunk=chunk)
            opt = AdamW(lr=lr())
            state, step = opt.init(model.params), make_train_step(model, opt)
            losses = []
            for i in range(args.steps):
                _, _, loss, _ = step(model.params, state,
                                     make_batch(cfg, cell, step=i, device="cuda"))
                losses.append(float(loss))
            out["sweep"][f"{arch} {name}"] = losses
            cs.say(f"[first steps] {arch} LR {name}: losses "
                   + " ".join(f"{x:.4f}" for x in losses) + f"  [{card}]")
            del model, state, step
            cs.free_device()

    arch, B, S, chunk = MODELS[0]
    cfg = get_config(arch)
    batch = make_batch(cfg, ShapeCell("train", "train", S, B), step=0, device="cuda")
    for lr, wd, clip in ((0.0, 0.0, 1.0), (1e-5, 0.0, None), (1e-6, 0.1, 1.0)):
        model = Model(cfg, device="cuda", seed=0, loss_chunk=chunk)
        before = {n: t.clone() for n, t in tree_util.items(model.params)}
        opt = AdamW(lr=lr, weight_decay=wd, clip_norm=clip)
        state, step = opt.init(model.params), make_train_step(model, opt)
        _, _, loss0, _ = step(model.params, state, batch)
        with torch.no_grad():
            loss1 = float(model.train_loss(batch)[0])
        moved = sorted(((float((t.float() - before[n].float()).abs().max()),
                         float((t != before[n]).float().mean()), n)
                        for n, t in tree_util.items(model.params)), reverse=True)[:4]
        row = {"lr": lr, "weight_decay": wd, "clip": clip, "loss_before": float(loss0),
               "loss_after": loss1, "most_changed": moved}
        out["first_step"].append(row)
        cs.say(f"[first steps] {arch} one step at LR {lr} (decay {wd}, clip {clip}): loss "
               f"{row['loss_before']:.4f} -> {loss1:.4f}; most changed (max |change|, share "
               f"changed, leaf): " + "; ".join(f"{d:.3g} {100 * f:.1f} % {n}" for d, f, n in moved)
               + f"  [{card}]")
        del model, state, step, before
        cs.free_device()
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "train_first_steps.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
