#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/smoke_phases.py prefill_graphs
    python3 tools/smoke_phases.py scale replay

The device and build phases run first. ``prefill_graphs`` builds the serve
phase's full-width Qwen1.5-MoE-A2.7B (bf16, random weights from seed 0) and
runs `chip_smoke.phase_prefill_graphs` over it; ``scale`` builds the
cluster phase's Minitron-4B and runs `chip_smoke.phase_scale`, and
``replay`` runs `chip_smoke.phase_replay` after it (it needs the scale
phase's oracle). Each phase checks what it checks in the whole run; a
failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("prefill_graphs", "scale", "replay")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=PHASES)
    args = ap.parse_args(argv)
    if "replay" in args.phases and "scale" not in args.phases:
        ap.error("replay needs the scale phase's oracle: run scale with it")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.phase_build()
    if "prefill_graphs" in args.phases:
        from repro_torch.configs import get_config
        from repro_torch.models import Model
        model = Model(get_config(cs.SERVE_ARCH), device="cuda", seed=0)
        cs.phase_prefill_graphs(card, model)
        del model
        cs.free_device()
    if "scale" in args.phases:
        model = cs.cluster_model(card)
        _, oracle = cs.phase_scale(card, model)
        if "replay" in args.phases:
            cs.phase_replay(card, model, oracle)
    print(f"[smoke phases] {' '.join(args.phases)} in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
