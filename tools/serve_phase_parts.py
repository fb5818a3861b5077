#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s Mamba2 serve phase spends its time, on one CUDA
card.

    python3 tools/serve_phase_parts.py [--smoke DIR] [--tag NAME]

Imports ``chip_smoke.py`` from ``DIR`` (default: this checkout; an unpacked
older commit works too, so that two versions can be compared in one call),
wraps its serve-phase helpers with host timers (each serve run, the
profiled run, the path checks, the host-op count of one ``decode_step``),
then runs its device, build and Mamba2 serve phases as its ``main`` does.
Prints the card's name and power limit, each helper's calls and seconds and
the phase's whole time, then a JSON line, and writes it to
``serve_phase_parts[_NAME].json`` in that ``chip_smoke.py``'s output
directory.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py's serve-phase helpers, as every version of it names them
TIMED = ("_serve_once", "_profile_run", "_decode_step_host_ops", "_ssm_path_outputs")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", type=Path, default=ROOT,
                    help="directory holding the chip_smoke.py (and src/) to time")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    args = ap.parse_args()
    smoke_dir = args.smoke.resolve()
    sys.path.insert(0, str(smoke_dir / "src"))
    sys.path.insert(0, str(smoke_dir))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    parts = {name: [] for name in TIMED}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[name].append(time.perf_counter() - t0)
        return wrapper

    for name in TIMED:
        setattr(cs, name, timed(name, getattr(cs, name)))
    card = cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    cs.phase_serve(card, cs.SSM_ARCH, cs.SSM_PROMPT_LENS, cs._ssm_path_outputs,
                   ("ssd_scan_kernel",), paged=False, n_slots=4, s_max=1024)
    phase_s = time.perf_counter() - t0
    runs = parts["_serve_once"]
    profiled_serve = runs[2] if len(runs) > 2 else float("nan")
    out = {"card": card, "smoke": str(smoke_dir), "phase_s": phase_s, "parts_s": parts,
           "profile_processing_s": sum(parts["_profile_run"]) - profiled_serve}
    print(f"[parts] Mamba2 serve phase of {smoke_dir}: {phase_s:.2f} s; serve runs "
          + ", ".join(f"{t:.2f}" for t in runs)
          + f" s (the third under the profiler); profiled run in all "
          f"{sum(parts['_profile_run']):.2f} s, of which the profiler's own work "
          f"{out['profile_processing_s']:.2f} s; path checks {sum(parts['_ssm_path_outputs']):.2f} s "
          f"({len(parts['_ssm_path_outputs'])} prompts); decode_step host-op count "
          f"{sum(parts['_decode_step_host_ops']):.2f} s  [{card}]", flush=True)
    cs.OUT.mkdir(exist_ok=True)
    name = f"serve_phase_parts{'_' + args.tag if args.tag else ''}.json"
    (cs.OUT / name).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
