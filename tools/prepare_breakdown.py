#!/usr/bin/env python3
"""Where a PREPARE's time goes, on one CUDA card, with nothing serving
beside it.

    python3 tools/prepare_breakdown.py [--repeats 3]

Builds full-width Minitron-4B (bf16, random weights from seed 0) and one
paged ``ServingEngine`` as ``chip_smoke.py``'s cluster phase does
(`CLUSTER_ENGINE`), then times, ``--repeats`` times, each part of
``prepare_executables`` at the lengths that phase's phi engine warms (each
part ending in a device synchronisation): the decode warm-up step on scratch
state, the decode graph's capture, each prefill executable's warm-up and
capture (in one fresh pool), and the whole call. Prints the card's name and
power limit, one line per repeat and a JSON line of every time, and writes
it to ``prepare_breakdown.json`` in ``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the prompt lengths the cluster phase's phi engine has seen when its
# PREPARE runs (its `recent_prompt_lengths`)
WARM_LENGTHS = (17, 100, 200, 256, 320, 384)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.executable import DecodeExecutable, PrefillExecutable
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    model = Model(get_config(cs.CLUSTER_ARCH), device="cuda", seed=0)
    eng = ServingEngine(model, **cs.CLUSTER_ENGINE)
    placement = {"params": eng.device, "cache": eng.device}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    eng.prepare_executables(placement, WARM_LENGTHS)       # first use: kernel build
    runs = []
    for k in range(args.repeats):
        decode_s = timed(eng._scratch_decode_inputs())
        capture_s = timed(lambda: DecodeExecutable(eng).capture(eng._scratch_decode_inputs()))
        pool = torch.cuda.graph_pool_handle()
        kept = []          # the pool lives while one of its graphs does

        def capture(n):
            kept.append(PrefillExecutable(model, n, device=eng.device))
            kept[-1].capture(pool)

        prefill_s = [timed(lambda n=n: capture(n)) for n in WARM_LENGTHS]
        del kept
        total_s = timed(lambda: eng.prepare_executables(placement, WARM_LENGTHS))
        runs.append({"total_s": total_s, "decode_s": decode_s, "capture_s": capture_s,
                     "prefill_s": prefill_s})
        print(f"[prepare] repeat {k}: PREPARE alone {total_s:.4f} s; decode warm-up step "
              f"{decode_s:.4f} s; decode graph capture {capture_s:.4f} s; prefill warm-up + capture at "
              f"{WARM_LENGTHS}: "
              + ", ".join(f"{t:.4f}" for t in prefill_s)
              + f" s (sum {sum(prefill_s):.4f})  [{card}]", flush=True)
    out = {"card": card, "lengths": WARM_LENGTHS, "runs": runs}
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "prepare_breakdown.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
