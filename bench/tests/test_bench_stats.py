"""The end-to-end statistics are taken over every request of the window:
one stall moves them, a request never answered misses."""
import dataclasses

import pytest

from bench import serve, stats
from bench.traffic.generator import Arrival


@dataclasses.dataclass
class _Req:
    tokens_out: list
    t_first: float
    t_done: float


def _rec(rid, due, stamps, refused=False):
    r = serve.ReqRecord(Arrival(rid, due, 8, len(stamps)), prompt=[0] * 8, due=due)
    r.stamps = list(stamps)
    r.refused = refused
    if not refused:
        r.req = _Req(list(range(len(stamps))), stamps[0], stamps[-1])
    return r


def _run(recs, window=100.0):
    return serve.RunRecord(model={}, window_s=window, t0=0.0, requests=recs,
                           prefill_delta={}, decode_delta={})


def _steady(n=40, stall_at=None):
    recs = []
    for i in range(n):
        due = float(i)
        stamps = [due + 0.1 + 0.01 * k for k in range(20)]
        if stall_at is not None and i == stall_at:
            stamps = stamps[:10] + [t + 2.0 for t in stamps[10:]]
        recs.append(_rec(i, due, stamps))
    return recs


def test_nearest_rank():
    assert stats.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert stats.nearest_rank([3.0], 0.99) == 3.0


def test_one_stall_moves_the_gap_tail_and_tpot():
    base = stats.end_to_end(_run(_steady()), 1.0, 60.0)
    stalled = stats.end_to_end(_run(_steady(stall_at=7)), 1.0, 60.0)
    assert base["itl_p99_ms"] == pytest.approx(10.0) and base["itl_p95_ms"] == pytest.approx(10.0)
    # one gap of 760 gaps: the 99th percentile is not it, but 10 stalls are
    many = _steady()
    for i in range(10):
        many[i] = _steady(stall_at=i)[i]
    assert stats.end_to_end(_run(many), 1.0, 60.0)["itl_p99_ms"] > 2000
    assert stalled["tpot_p95_ms"] == base["tpot_p95_ms"]        # 1 of 40 requests
    assert stalled["output_tokens_per_s"] == base["output_tokens_per_s"]


def test_ttft_from_due_time_and_the_unanswered_miss():
    recs = _steady()
    base = stats.end_to_end(_run(recs), 1.0, 60.0)
    assert base["ttft_p90_ms"] == pytest.approx(100.0)
    late = [_rec(r.arrival.rid, r.due - 0.5, r.stamps) for r in recs]   # due earlier
    assert stats.end_to_end(_run(late), 1.0, 60.0)["ttft_p90_ms"] == pytest.approx(600.0)
    # 4 of 40 unanswered: the 36th of 40 is still answered; 5 reach the 90th percentile
    four = recs[:-4] + [_rec(100 + i, 1.0, [], refused=True) for i in range(4)]
    assert stats.end_to_end(_run(four), 1.0, 60.0)["ttft_p90_ms"] == pytest.approx(100.0)
    five = recs[:-5] + [_rec(100 + i, 1.0, [], refused=True) for i in range(5)]
    assert stats.end_to_end(_run(five), 1.0, 60.0)["ttft_p90_ms"] == pytest.approx(160e3)


def test_tokens_after_the_close_do_not_count():
    recs = _steady()
    out = stats.end_to_end(_run(recs, window=20.0), 1.0, 60.0)
    inside = sum(sum(t <= 20.0 for t in r.stamps) for r in recs)
    assert out["output_tokens_per_s"] == inside / 20.0


def test_spread_and_the_trimmed_spread():
    from bench.spread import spread, trimmed
    vals = [100.0, 101.0, 102.0, 103.0, 104.0, 150.0]
    q1, q2, q3 = 100.75, 102.5, 115.5                   # statistics.quantiles' quartiles
    assert spread(vals) == pytest.approx((q3 - q1) / q2)
    # the run farthest from the median (150) left out
    assert trimmed(vals) == pytest.approx(spread(vals[:-1]))
