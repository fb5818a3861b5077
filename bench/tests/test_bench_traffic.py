"""The generator: a seed gives one run's requests, every seed the same
sizes and gaps in another order, with its own tokens."""
import numpy as np
import pytest

from bench import spec
from bench.traffic import generator as g

SEEDS = (2**31 + 17, 5, 2**40 + 3)


def _mix():
    return spec.load_traffic("azure-conv-intent")       # the richest mix: labels, an event


def _sizes(s):
    return [(a.prompt_len, a.new_tokens, a.labels) for a in s.arrivals]


def _sets(s):
    """Each size's values, and the gaps between arrivals (the last one to
    the window's end), each sorted."""
    return ([sorted(x) for x in zip(*_sizes(s))]
            + [sorted(np.round(np.diff([a.t for a in s.arrivals] + [51.0]), 9))])


def test_same_seed_same_requests():
    a, b = g.schedule(_mix(), 51.0, SEEDS[0]), g.schedule(_mix(), 51.0, SEEDS[0])
    assert a == b
    pa = g.prompt_tokens(a, 1000, SEEDS[0])
    pb = g.prompt_tokens(b, 1000, SEEDS[0])
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))


def test_every_seed_the_same_work_in_another_order():
    runs = [g.schedule(_mix(), 51.0, s) for s in SEEDS]
    assert all(_sets(r) == _sets(runs[0]) for r in runs)
    assert len({tuple(_sizes(r)) for r in runs}) == len(SEEDS)
    assert len({tuple(a.t for a in r.arrivals) for r in runs}) == len(SEEDS)
    pa, pb = g.prompt_tokens(runs[0], 1000, SEEDS[0]), g.prompt_tokens(runs[1], 1000, SEEDS[1])
    assert not all(np.array_equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_inside_the_window_at_the_rate(seed):
    mix = _mix()
    s = g.schedule(mix, 51.0, seed)
    ts = np.array([x.t for x in s.arrivals])
    n = len(ts)
    assert n == round(mix["rate_per_s"] * 51.0)
    assert np.all(np.diff(ts) > 0) and ts[0] == 0.0 and ts[-1] < 51.0
    gaps = np.diff(np.append(ts, 51.0))
    assert abs(gaps.mean() - 51.0 / n) < 1e-9
    assert abs(gaps.std() * mix["rate_per_s"] - 1.0) < 0.1          # exponential's spread
    labels = [dict(x.labels)["data-type"] for x in s.arrivals]
    assert labels.count("phi") in (n // 2, (n + 1) // 2)
    (t_intent, kind, payload), = s.events
    assert kind == "intent" and "Phi" in payload["text"]
    assert abs(t_intent - mix["events"][0]["at_fraction"] * 51.0) < 1e-9


def test_lengths_follow_the_published_medians_clipped():
    mix = _mix()
    p = g.quantile_lengths(mix["prompt"], 1001)
    o = g.quantile_lengths(mix["output"], 1001)
    assert p[500] == mix["prompt"]["median"] and o[500] == mix["output"]["median"]
    assert p.min() >= mix["prompt"]["min"] and p.max() == mix["prompt"]["max"]
    assert o.min() >= mix["output"]["min"] and o.max() == mix["output"]["max"]
    assert p.max() + o.max() <= 2048                    # a request fits the engine
    assert len(set(p.tolist())) > 500                   # continuous, not a ladder
    geo = g.quantile_lengths({"dist": "geometric", "mean": 128, "min": 1, "max": 10**6}, 20001)
    assert abs(geo.mean() - 128) < 2


def test_open_loop_releases_at_the_due_times():
    proc = g.process(_mix(), 51.0, SEEDS[0])
    assert proc.due(-1.0) == [] and proc.next_due() == 0.0
    first = proc.due(10.0)
    assert [k for k, _ in first] == list(range(len(first)))
    assert all(t <= 10.0 for _, t in first) and proc.next_due() > 10.0
    rest = proc.due(51.0)
    assert len(first) + len(rest) == proc.n and proc.next_due() is None
