"""The end-to-end statistics of a run, over every request due in the
window (`bench.serve.RunRecord`)."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q``-quantile by nearest rank: the ``ceil(q n)``-th smallest."""
    if not values:
        return float("nan")
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def end_to_end(run, setup_s: float, drain_s: float) -> Dict[str, float]:
    """``ttft_p90_ms``: from each request's due time to its first token
    (the wait of a request the router refused first included), a request
    with no first token by the end of the drain counted as the window plus
    the drain (it misses every limit); ``tpot_p95_ms``: (last token - first)
    / (tokens - 1) of the requests finished inside the window;
    ``itl_p99_ms`` and ``itl_p95_ms``: every gap between consecutive tokens
    stamped inside the window; ``output_tokens_per_s``: the tokens stamped
    inside the window over its length."""
    miss = run.window_s + drain_s
    ttft, tpot, itl = [], [], []
    tokens = 0
    for r in run.requests:
        if r.stamps:
            ttft.append(r.stamps[0] - r.due)
        else:
            ttft.append(miss)
        inside = [t for t in r.stamps if t <= run.t_close]
        tokens += len(inside)
        itl += [b - a for a, b in zip(inside, inside[1:])]
        if r.finished and len(r.stamps) > 1 and r.stamps[-1] <= run.t_close:
            tpot.append((r.stamps[-1] - r.stamps[0]) / (len(r.stamps) - 1))
    return {"ttft_p90_ms": 1e3 * nearest_rank(ttft, 0.90),
            "tpot_p95_ms": 1e3 * nearest_rank(tpot, 0.95),
            "itl_p99_ms": 1e3 * nearest_rank(itl, 0.99),
            "itl_p95_ms": 1e3 * nearest_rank(itl, 0.95),
            "output_tokens_per_s": tokens / run.window_s,
            "setup_s": setup_s}


def summary(run) -> Dict[str, float]:
    """Counts and medians beside the tails, for the run's log."""
    ttft = [r.stamps[0] - r.due for r in run.requests if r.stamps]
    late = [r.submitted - r.due for r in run.requests if r.submitted]
    itl: List[float] = []
    for r in run.requests:
        inside = [t for t in r.stamps if t <= run.t_close]
        itl += [b - a for a, b in zip(inside, inside[1:])]
    return {"due": len(run.requests),
            "ttft_mean_ms": 1e3 * sum(ttft) / max(len(ttft), 1),
            "ttft_p95_ms": 1e3 * nearest_rank(ttft, 0.95),
            "refused_first": sum(r.refused > 0 for r in run.requests),
            "refusals": sum(r.refused for r in run.requests),
            "unfinished": sum(not r.finished for r in run.requests),
            "ttft_median_ms": 1e3 * nearest_rank(ttft, 0.5), "ttft_n": len(ttft),
            "itl_median_ms": 1e3 * nearest_rank(itl, 0.5), "itl_n": len(itl),
            "late_median_ms": 1e3 * nearest_rank(late, 0.5),
            "late_max_ms": 1e3 * max(late, default=float("nan")),
            "steps": len(run.steps)}
