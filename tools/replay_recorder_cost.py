#!/usr/bin/env python3
"""What the flight recorder costs the replay phase, on one CUDA card, with
the order of the runs taken apart from the recorder.

    python3 tools/replay_recorder_cost.py [--pairs 4]

Builds full-width Minitron-4B (bf16, random weights from seed 0) as
``chip_smoke.py``'s cluster phase does, and replays ``_scale_trace``'s trace
through ``chip_smoke._replay_run`` (the replay phase's stack on a
``FakeClock``) once to warm up (not counted), then ``--pairs`` times with
recording off and on, in turns (off, on; on, off; ...), so each mode runs
first as often as second. Every run must give the same ``ReplayStats``.
Prints the card's name and power limit, each run's wall time of the replay
loop, each pair's ratio (on ÷ off), the median per mode and per position
in a pair, and a JSON line of every time; writes it to
``replay_recorder_cost.json`` in ``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.planner import calibrate_host_profile
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    model = Model(get_config(cs.CLUSTER_ARCH), device="cuda", seed=0)
    profile = calibrate_host_profile()
    trace, _ = cs._scale_trace(model.cfg.vocab_size)
    runs, first = [], None
    with tempfile.TemporaryDirectory() as bundles:
        # a warm-up run, not counted: the first builds the flash kernel and
        # meets every prompt length and cuBLAS handle for the first time
        warm = cs._replay_run(model, trace, profile, False, bundles)
        cs.say(f"warm-up (unrecorded, not counted): {warm['wall_s']:.3f} s  [{card}]")
        del warm
        cs.free_device()
        for pair in range(args.pairs):
            order = (False, True) if pair % 2 == 0 else (True, False)
            walls = {}
            for pos, record in enumerate(order):
                run = cs._replay_run(model, trace, profile, record, bundles)
                stats = dataclasses.asdict(run["stats"])
                first = stats if first is None else first
                cs.check(stats == first, f"pair {pair}: ReplayStats differ between runs")
                walls[record] = run["wall_s"]
                runs.append({"pair": pair, "position": pos, "recorded": record,
                             "wall_s": run["wall_s"]})
                del run
                cs.free_device()
            ratio = walls[True] / walls[False]
            runs[-1]["ratio"] = runs[-2]["ratio"] = ratio
            cs.say(f"pair {pair} ({'off, on' if not order[0] else 'on, off'}): recorded "
                   f"{walls[True]:.3f} s, unrecorded {walls[False]:.3f} s, ratio {ratio:.4f}  "
                   f"[{card}]")
    med = {k: statistics.median(r["wall_s"] for r in runs if sel(r))
           for k, sel in (("recorded", lambda r: r["recorded"]),
                          ("unrecorded", lambda r: not r["recorded"]),
                          ("first", lambda r: r["position"] == 0),
                          ("second", lambda r: r["position"] == 1))}
    ratios = [r["ratio"] for r in runs if r["position"] == 1]
    cs.say(f"median wall: recorded {med['recorded']:.3f} s, unrecorded "
           f"{med['unrecorded']:.3f} s; first of a pair {med['first']:.3f} s, second "
           f"{med['second']:.3f} s; ratio median {statistics.median(ratios):.4f} "
           f"({min(ratios):.4f}-{max(ratios):.4f}); {first['steps']} steps a run  [{card}]")
    out = {"card": card, "steps": first["steps"], "runs": runs, "medians": med,
           "ratios": ratios}
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "replay_recorder_cost.json").write_text(json.dumps(out, indent=1))
    cs.say(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
