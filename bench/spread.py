"""The spread of a cell's runs, as the bounds are set from it: for each
end-to-end metric and each set of runs, the interquartile range over the
median (``statistics.quantiles(values, n=4)``), whole and with the set's
run farthest from its median left out, and five times the widest.

    python3 -m bench.spread A=chiprun_out/c13/*.A.*.t0.out B=chiprun_out/c13/*.B.*.t0.out

Each argument is ``SET=FILE`` (a shell glob expands to several); a file's
last line is a run's result line.
"""
from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List, Sequence


def spread(values: Sequence[float]) -> float:
    """Interquartile range over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def trimmed(values: Sequence[float]) -> float:
    """`spread` with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv: Sequence[str]) -> int:
    sets: Dict[str, List[dict]] = {}
    current = None
    for arg in argv:
        if "=" in arg:
            current, arg = arg.split("=", 1)
        with open(arg) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if lines:
            sets.setdefault(current or "all", []).append(json.loads(lines[-1])["metrics"])
    names = sorted({k for runs in sets.values() for r in runs for k in r})
    for name in names:
        row = {"metric": name}
        widest = 0.0
        for tag, runs in sets.items():
            vals = [r[name]["value"] for r in runs if name in r]
            if len(vals) < 3:
                continue
            row[tag] = {"n": len(vals), "median": statistics.median(vals),
                        "spread": spread(vals),
                        "trimmed": trimmed(vals) if len(vals) >= 4 else None}
            widest = max(widest, row[tag]["spread"])
        row["five_times_widest"] = 5 * widest
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
