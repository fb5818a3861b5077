"""The device trace of a traced run's profiled stretch, reduced to what the
per-layer readers and the result's ``breakdown`` need.

`torch.profiler` records CPU ops and the card's kernels, copies and sets,
kernels replayed inside CUDA graphs included. The profiler starts and stops
at step boundaries after the serving stream is synchronised, so every
device operation of a step profiled falls inside the stretch. The harness annotates its own
host work (``bench.idle`` while it waits for the next due request); an
idle gap on the device is named by what the host was doing across it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
#: the longest idle gaps named by host activity (the rest are summed in
#: no name)
GAPS_NAMED = 400


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # the stretch's length (host clock)
    busy_s: float                   # device time covered by operations
    active_s: float                 # stretch less the harness's idle waits
    busy_active_s: float            # device busy time while the engine had work
    by_name: Dict[str, Tuple[float, int]]     # device op -> (seconds, count)
    #: the same, of the ops the serving thread launched (by the launch's
    #: correlation id; all of them where the trace links none)
    by_name_serving: Dict[str, Tuple[float, int]]
    idle_gaps: List[Tuple[str, float]]        # longest gaps, by host activity
    steps: List[int]                # indices of the steps profiled


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(iv: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _intersect(a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]) -> float:
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def load_events(prof) -> List[Dict[str, Any]]:
    """The profile's Chrome trace events (written to a temporary file of
    the process's ``TMPDIR``, read, and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def reduce_events(events: List[Dict[str, Any]], window_s: float,
                  steps: List[int]) -> TraceSummary:
    """Busy time, device time by operation, and the idle gaps named by the
    innermost host op (or the harness's annotation) across each."""
    dev, host, idle = [], [], []
    by_name: Dict[str, List[float]] = {}
    launched_by: Dict[Any, Any] = {}          # correlation id -> launching thread
    serving_tids = set()
    kernels = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            acc = by_name.setdefault(e.get("name", "?"), [0.0, 0])
            acc[0] += dur
            acc[1] += 1
            kernels.append((e.get("name", "?"), dur, e.get("args", {}).get("correlation")))
        elif cat == "cuda_runtime":
            launched_by[e.get("args", {}).get("correlation")] = e.get("tid")
        elif cat == "user_annotation" and e.get("name") == "bench.idle":
            idle.append((ts, ts + dur))
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append((ts, dur, e.get("name", "?")))
            if e.get("name") == "cluster.step":
                serving_tids.add(e.get("tid"))
    by_serving: Dict[str, List[float]] = {}
    for name, dur, corr in kernels:
        if launched_by and serving_tids and launched_by.get(corr) not in serving_tids:
            continue
        acc = by_serving.setdefault(name, [0.0, 0])
        acc[0] += dur
        acc[1] += 1
    busy = _union(dev)
    if not busy:
        return TraceSummary(window_s, 0.0, 0.0, 0.0, {}, {}, [], steps)
    lo = min(a for a, _ in busy)
    hi = max(b for _, b in busy)
    start = min([lo] + [t for t, _, _ in host])
    end = max([hi] + [t + d for t, d, _ in host])
    idle_u = _union(idle)
    active = _union([(a, b) for a, b in _complement(idle_u, start, end)])
    gaps = [(a, b) for a, b in _complement(busy, start, end) if b - a > 0]
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    h_start = np.array([t for t, _, _ in host])
    h_dur = np.array([d for _, d, _ in host])
    for a, b in gaps[:GAPS_NAMED]:
        mid = (a + b) / 2
        cover = np.nonzero((h_start <= mid) & (h_start + h_dur >= mid))[0]
        name = host[cover[np.argmin(h_dur[cover])]][2] if len(cover) else "host (python)"
        named[name] = named.get(name, 0.0) + (b - a)
    return TraceSummary(
        window_s=window_s, busy_s=_length(busy), active_s=_length(active),
        busy_active_s=_intersect(busy, active),
        by_name={k: (v[0], int(v[1])) for k, v in by_name.items()},
        by_name_serving={k: (v[0], int(v[1])) for k, v in by_serving.items()},
        idle_gaps=sorted(named.items(), key=lambda kv: -kv[1])[:TOP], steps=steps)


def _complement(iv: Sequence[Tuple[float, float]], start: float, end: float
                ) -> List[Tuple[float, float]]:
    out, t = [], start
    for a, b in iv:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def summarize(prof, prof_t: List[float], run) -> TraceSummary:
    """The profiled stretch of ``run`` (``prof_t``: its host start and
    stop), with the indices of the steps that lie inside it."""
    t_a, t_b = prof_t
    steps = [k for k, (ts, te, _) in enumerate(run.steps) if ts >= t_a and te <= t_b]
    return reduce_events(load_events(prof), t_b - t_a, steps)


def kernel_time(trace: TraceSummary, names: Sequence[str]) -> Tuple[float, int]:
    """(seconds, launches) of the device ops the serving thread launched
    whose name holds any of ``names``."""
    s, n = 0.0, 0
    for key, (sec, cnt) in trace.by_name_serving.items():
        if any(x in key for x in names):
            s += sec
            n += cnt
    return s, n


def top_ops(trace: Optional[TraceSummary]) -> List[Tuple[str, float]]:
    if trace is None:
        return []
    rows = sorted(trace.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [(k, v[0]) for k, v in rows]
