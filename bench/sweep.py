"""The rate sweep that fixes a cell's offered rate: the cell served at each
of several rates, each in several orders of its mix (the orders that
``--orders`` seeds draw), one process, one engine set up once, each window
drained before the next.

    python3 -m bench.sweep --workload qwen-chat-poisson --rates 1 1.5 2 2.5 --seconds 36

For each rate and order it prints one JSON line: the backlog (requests due
but not yet admitted) as a least-squares slope over the window's second
half, in requests a second, with its value at the close; the first-token
and per-token tails; tokens a second against those offered. Rates run in
ascending order and stop after the first at which any order's backlog
grows (a slope over `GROWS`). The knee is the highest rate at which no
order's backlog grows; the cell's traffic file takes 4/5 of it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: a backlog slope (requests a second) that counts as growing
GROWS = 0.1


def backlog(run) -> tuple:
    """The backlog, requests an engine took and that wait for a lane (a
    request the router refuses waits for a compliant engine, not for
    capacity), read at each step's end: (least-squares slope over the
    window's second half, its value at the close, its value at each tenth
    of the window)."""
    took = sorted(r.accepted if r.accepted else float("inf") for r in run.requests)
    first = sorted(r.stamps[0] if r.stamps else float("inf") for r in run.requests)
    ts = np.array([te for _, te, _ in run.steps if te <= run.t_close])
    if len(ts) < 4:
        return float("nan"), float("nan"), []
    back = np.searchsorted(took, ts, side="right") - np.searchsorted(first, ts, side="right")
    half = ts >= run.t0 + run.window_s / 2
    slope = float(np.polyfit(ts[half] - run.t0, back[half], 1)[0]) if half.sum() > 2 else float("nan")
    marks = [int(back[min(np.searchsorted(ts, run.t0 + k * run.window_s / 10), len(ts) - 1)])
             for k in range(1, 11)]
    return slope, int(back[-1]), marks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--orders", type=int, nargs="+", default=[2**31 + 11, 2**31 + 12])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from bench.run import set_cache_dirs
    set_cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench import serve, spec as spec_mod, stats, yardstick
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, args.workload)
    conf = spec_mod.load_config(spec, cell["config"])
    mix = spec_mod.load_traffic(cell["traffic"])
    dev = torch.device("cuda")
    print(json.dumps({"card": yardstick.card_power()}), flush=True)
    c = serve.Cell(conf, mix, args.seed, args.seconds, dev)
    c.setup()
    lines = []
    for rate in sorted(args.rates):
        grew = False
        for order in args.orders:
            c.reschedule(dict(mix, rate_per_s=rate), order)
            run = c.serve(drain_s=90.0)
            slope, close, marks = backlog(run)
            drained = max((r.stamps[-1] for r in run.requests if r.stamps), default=run.t0)
            e2e = stats.end_to_end(run, 0.0, 90.0)
            offered = sum(r.arrival.new_tokens for r in run.requests) / args.seconds
            line = {"workload": args.workload, "rate": rate, "order": order,
                    "due": len(run.requests), "backlog_slope_per_s": slope,
                    "backlog_at_close": close, "backlog_by_tenth": marks,
                    "grows": bool(slope > GROWS),
                    "last_token_after_close_s": drained - run.t_close,
                    "offered_tokens_per_s": offered, **e2e, **stats.summary(run),
                    "prefill": run.prefill_delta,
                    "prepare_s": None if run.report is None else run.report.prepare_s}
            line.pop("setup_s")
            print(json.dumps(line), flush=True)
            lines.append(line)
            grew = grew or line["grows"]
            if line["unfinished"]:
                break                       # the engine is not empty: the next would start loaded
        if grew or lines[-1]["unfinished"]:
            break
    c.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
