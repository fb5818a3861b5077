"""The readings that set a cell's limit on the logit gap: the program's
widest gap over many seeds (the lower reading) and the control's, the
plain reference in float8 put in the program's place (the upper reading),
read at the same positions of the same runs. One process; each seed makes
its weights, sets the cell up, serves a window at the cell's own load,
drains, and compares as a run does.

    python3 -m bench.readings --workload qwen-chat-poisson --seeds 11 12 13 --seconds 20

Prints one JSON line a seed. The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from bench.run import set_cache_dirs
    set_cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench import serve, spec as spec_mod, stats
    from bench.run import judge
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, args.workload)
    conf = spec_mod.load_config(spec, cell["config"])
    mix = spec_mod.load_traffic(cell["traffic"])
    dev = torch.device("cuda")
    out = []
    for seed in args.seeds:
        c = serve.Cell(conf, mix, seed, args.seconds, dev)
        c.setup()
        run = c.serve()
        s = stats.summary(run)
        g = judge(c, run, seed, dev, conf, control=True)
        line = {"workload": args.workload, "seed": seed, "mean_gap": g["mean_gap"],
                "control_mean_gap": g["control_mean_gap"], "gap": g["gap"],
                "control_gap": g["control_gap"], "requests": g["requests"],
                "tokens": g["tokens"], "disagree": g["disagree"],
                "control_disagree": g["control_disagree"],
                "per_request": g["per_request"], "control_per_request": g["control_per_request"],
                "due": s["due"], "refused_first": s["refused_first"],
                "unfinished": s["unfinished"]}
        print(json.dumps(line), flush=True)
        out.append(line)
        del c, run
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
