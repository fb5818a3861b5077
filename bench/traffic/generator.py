"""The generator every traffic mix goes through.

A mix file (``bench/traffic/<name>.json``) names its arrival process
(``"arrivals"``: a module ``bench/traffic/arrivals/<name>.py``), the length
distributions, the label mix and any operator events (an intent at a fixed
share of the window). The generator turns it and ``--seed`` into one run's
requests:

* The *set* of sizes is the distributions' own: ``n`` prompt and output
  lengths at the mid-quantiles ``(i + 1/2) / n`` of each distribution
  (continuous lognormal or geometric, clipped), labels in the mix's
  shares. The arrival process fixes ``n`` and, in an open loop, the set of
  gaps between arrivals the same way.
* ``--seed`` draws their *order* (which size comes when, which gap follows
  which), every token id, and the benchmark's weights.

So every seed offers the same work and the same gaps, in another order: in
an open loop below its knee the tail of first-token times turns on which
requests bunch, and fresh draws a seed also moved the work (the count of
requests, the longest prompts), which moved a cell's tail far more than one
seed's runs did (PERF.md).

A request is due when its process releases it: the harness times it from
then.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import statistics
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

ARRIVALS = Path(__file__).resolve().parent / "arrivals"


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of the run: its sizes and labels, and ``t``, the seconds
    into the window it is due where the process fixes that in advance (an
    open loop; NaN where it is released as the run goes)."""

    rid: int
    t: float
    prompt_len: int
    new_tokens: int
    labels: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class Schedule:
    arrivals: Tuple[Arrival, ...]
    #: operator events: (seconds into the window, kind, payload)
    events: Tuple[Tuple[float, str, Dict[str, Any]], ...]


def mid_quantiles(n: int) -> np.ndarray:
    """``(i + 1/2) / n`` for ``i < n``."""
    return (np.arange(n) + 0.5) / max(n, 1)


def quantile_lengths(dist: Dict[str, Any], n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of ``dist``, ascending: ``lognormal``
    (``median``, ``sigma``) or ``geometric`` (``mean``, on 1, 2, ...),
    rounded and clipped to [``min``, ``max``]."""
    u = mid_quantiles(n)
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(x)) for x in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "geometric":
        p = min(1.0 / dist["mean"], 1.0)
        x = np.ones(n) if p >= 1.0 else np.ceil(np.log1p(-u) / np.log1p(-p))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def label_counts(weights: Dict[str, float], n: int) -> List[str]:
    """``n`` label values in the shares ``weights`` gives (largest
    remainder), ascending by name."""
    names = sorted(weights)
    p = np.array([weights[v] for v in names], dtype=np.float64)
    exact = n * p / p.sum()
    k = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - k), kind="stable")[: n - int(k.sum())]:
        k[i] += 1
    return [v for v, c in zip(names, k) for _ in range(int(c))]


def seed_key(seed: int) -> int:
    """``--seed`` as numpy's seed: any whole number, negative ones folded."""
    return int(seed) % (1 << 64)


def order_rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of the run's orders (streams 4 and up; 1 draws
    the prompts' tokens, 3 the warm-up's)."""
    return np.random.default_rng([seed_key(seed), stream])


def load_process(name: str, arrivals: Path = ARRIVALS):
    """The module ``bench/traffic/arrivals/<name>.py``: its ``make(mix,
    window_s, rng)`` returns the run's arrival process (see
    ``arrivals/poisson.py`` for what the harness asks of one)."""
    path = arrivals / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_arrivals_{name.replace('.', '_')}",
                                                  path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(f"no arrival process {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process(mix: Dict[str, Any], window_s: float, seed: int):
    """The mix's arrival process for this seed (a fresh one each call: a
    process keeps the run's state)."""
    return load_process(mix["arrivals"]).make(mix, float(window_s), order_rng(seed, 4))


def schedule(mix: Dict[str, Any], window_s: float, seed: int, proc=None) -> Schedule:
    """The run's requests: ``proc.n`` of them (``proc`` defaults to the
    mix's process for ``seed``), the sizes' set from the distributions and
    their order from ``seed`` (module doc)."""
    proc = proc if proc is not None else process(mix, window_s, seed)
    n = int(proc.n)
    prompts = order_rng(seed, 5).permutation(quantile_lengths(mix["prompt"], n))
    outputs = order_rng(seed, 6).permutation(quantile_lengths(mix["output"], n))
    labels: List[Tuple[Tuple[str, str], ...]] = [()] * n
    for j, (key, weights) in enumerate(sorted(mix.get("labels", {}).items())):
        vals = order_rng(seed, 7 + j).permutation(np.array(label_counts(weights, n), dtype=object))
        labels = [lab + ((key, str(v)),) for lab, v in zip(labels, vals)]
    times = getattr(proc, "times", None)
    arrivals = tuple(Arrival(i, float(times[i]) if times is not None else float("nan"),
                             int(prompts[i]), int(outputs[i]), labels[i]) for i in range(n))
    events = tuple((float(e["at_fraction"]) * window_s, e["kind"], dict(e))
                   for e in mix.get("events", []))
    return Schedule(arrivals, events)


def prompt_tokens(sched: Schedule, vocab: int, seed: int) -> List[np.ndarray]:
    """Every request's prompt token ids, uniform over ``[2, vocab)``, from
    ``seed``."""
    rng = np.random.default_rng([seed_key(seed), 1])
    return [rng.integers(2, vocab, size=a.prompt_len).astype(np.int32) for a in sched.arrivals]


def labels_of(a: Arrival) -> Dict[str, str]:
    return dict(a.labels)


def first_event(sched: Schedule, kind: str) -> Optional[Tuple[float, Dict[str, Any]]]:
    for t, k, payload in sched.events:
        if k == kind:
            return t, payload
    return None
