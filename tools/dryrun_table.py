#!/usr/bin/env python3
"""The dry run's records as one markdown table: a row per (arch, shape
cell), one column group per mesh.

    python3 tools/dryrun_table.py [--dir experiments/dryrun_torch] [--base DIR]

Reads the JSON records `python -m repro_torch.launch.dryrun` writes (one a
cell and mesh). Each mesh's cell shows the argument and peak GB a rank
(peak marked ``*`` where it exceeds the card's memory), the FLOPs a rank,
the wire GB a rank moves over each mesh axis, and the roofline term that
bounds the step, how many sub-layers ran on their model-axis shard, on
their padded head slots and gathered whole (and how many attention
sub-layers of a decode step ran over the rank's piece of the cache's
sequence), and the tensor-parallel groups a step ran padded or gathered
where their dim does not divide the model axis (``tp`` counts of the
record); a cell that raised shows its error's type and its first words.
``--base DIR`` prints instead, for each record of ``--dir``, its figures
beside those of the same cell and mesh in ``DIR`` (an older tree's sweep):
the argument and peak GB a rank, the FLOPs a rank, the wire GB a rank per
axis, the bound and the local / padded / gathered counts, before and
after.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

MESHES = ("16x16", "2x16x16")
TERMS = {"compute_s": "compute", "memory_s": "HBM", "collective_s": "links"}


def cell_text(rec: dict) -> str:
    if rec is None:
        return "not run"
    if rec.get("status") != "ok":
        err = rec.get("error", "?")
        kind, _, msg = err.partition(": ")
        return f"{kind}: {' '.join(msg.split()[:9])}"
    m, rf, col = rec["memory"], rec["roofline"], rec["collectives"]
    peak = m["peak_bytes"] / 1e9
    wire = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in sorted(col["wire_bytes_by_axis"].items()))
    tp = rec.get("tp", {})
    seq = sum(n for k, n in tp.items() if k.endswith(":seq_local"))
    counts = (f", tp {_tp_counts(tp)}" + (f" / {seq} seq-local" if seq else "") if tp else "")
    names = "".join(f", {state}: {' '.join(_groups(tp, state))}"
                    for state in ("padded", "gathered") if _groups(tp, state))
    return (f"{m['argument_bytes'] / 1e9:.2f} / {peak:.2f}{'' if m['fits'] else '*'} GB, "
            f"{rec['cost']['hlo_flops_per_device'] / 1e12:.3g} TF, wire GB {wire or 'none'}, "
            f"{TERMS[rf['bottleneck']]}{counts}{names}")


def _tp_counts(tp: dict) -> str:
    """The sub-layers a step ran local, padded and gathered."""
    return " / ".join(f"{tp.get(f'tp_{s}', 0)} {s}" for s in ("local", "padded", "gathered"))


def _groups(tp: dict, state: str) -> list:
    """The tensor-parallel groups a step ran in ``state``."""
    return sorted({k.split(":")[0] for k in tp if k.endswith(f":{state}")})


def _short(rec: dict) -> str:
    """A record's argument / peak GB, TFLOP, wire GB per axis, bound and
    tensor-parallel counts."""
    if rec is None:
        return "not run"
    if rec.get("status") != "ok":
        return rec.get("error", "?").partition(":")[0]
    m, rf = rec["memory"], rec["roofline"]
    wire = ", ".join(f"{k} {v / 1e9:.2f}"
                     for k, v in sorted(rec["collectives"]["wire_bytes_by_axis"].items()))
    tp = rec.get("tp", {})
    return (f"{m['argument_bytes'] / 1e9:.2f} / {m['peak_bytes'] / 1e9:.2f}"
            f"{'' if m['fits'] else '*'} GB, {rec['cost']['hlo_flops_per_device'] / 1e12:.3g} "
            f"TF, {wire}, {TERMS[rf['bottleneck']]}" + (f", tp {_tp_counts(tp)}" if tp else ""))


def _load(path: str) -> dict:
    recs = {}
    for f in sorted(Path(path).glob("*.json")):
        r = json.loads(f.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--base", default=None, help="an older sweep's records, to compare")
    args = ap.parse_args(argv)
    recs = _load(args.dir)
    if args.base:
        base = _load(args.base)
        print("| arch | cell | mesh | before | after |")
        print("|---|---|---|---|---|")
        for key in sorted(recs):
            print(f"| {' | '.join(key)} | {_short(base.get(key))} | {_short(recs[key])} |")
        return
    rows = sorted({(a, s) for a, s, _ in recs})
    print("| arch | cell | " + " | ".join(MESHES) + " |")
    print("|---|---|" + "---|" * len(MESHES))
    for a, s in rows:
        print(f"| {a} | {s} | " + " | ".join(cell_text(recs.get((a, s, m))) for m in MESHES)
              + " |")
    ok = sum(1 for r in recs.values() if r.get("status") == "ok")
    fits = sum(1 for r in recs.values() if r.get("status") == "ok" and r["memory"]["fits"])
    print(f"\n{len(recs)} records: {ok} ran, {fits} fit a card's "
          f"{next(iter(recs.values()))['memory']['hbm_capacity'] if ok else '?'} B")


if __name__ == "__main__":
    main()
