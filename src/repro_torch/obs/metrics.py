"""Metrics registry for the flight recorder: counters / gauges /
histograms with label sets, quantile sketches, and JSON snapshots.

The histogram is a log-bucketed sketch (geometric bucket edges, factor
``growth``): ``observe`` is O(1), memory is O(log(max/min)), and any
quantile is recovered to within ``sqrt(growth) - 1`` relative error
(~5% at the default growth of 1.1) — plenty for TTFT/TPOT p99 tracking,
and the reason `ServingCluster.metrics_by_label` can drop its
O(total-completions) rescans for O(1)-per-completion accounting
(`RequestAggregate`).

Everything here is lock-safe and import-clean (no serving imports), so
the recorder can be threaded through any layer without cycles.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Mapping, Optional, Tuple, Union

Number = Union[int, float]


class Counter:
    """Monotone counter."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, by: Number = 1) -> None:
        if by < 0:
            raise ValueError(f"counters only go up, got {by}")
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: Number) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, by: Number) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed quantile sketch.

    Positive observations land in bucket ``ceil(log(v) / log(growth))``;
    a quantile is reported as the geometric midpoint of its bucket, so
    the relative error is bounded by ``sqrt(growth) - 1``. Non-positive
    and sub-``min_value`` observations share an underflow bucket
    (reported as 0.0); non-finite observations are counted separately so
    an inf-contaminated tail surfaces as inf instead of silently
    vanishing — matching what ``np.percentile`` would have said.
    """

    __slots__ = ("growth", "min_value", "_log_growth", "_buckets",
                 "_under", "_n_inf", "_n_nan", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, growth: float = 1.1, min_value: float = 1e-9):
        if growth <= 1.0:
            raise ValueError(f"growth must exceed 1, got {growth}")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_growth = math.log(self.growth)
        self._buckets: Dict[int, int] = {}
        self._under = 0
        self._n_inf = 0
        self._n_nan = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: Number) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if math.isnan(v):
                self._n_nan += 1
                return
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if math.isinf(v):
                self._n_inf += 1
            elif v < self.min_value:
                self._under += 1
            else:
                idx = math.ceil(math.log(v) / self._log_growth)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]); NaN on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return math.nan
            if self._n_nan:
                return math.nan          # np.percentile propagates NaN too
            rank = q * (self.count - 1) + 1      # 1-based target rank
            seen = self._under
            if seen >= rank:
                return 0.0
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if seen >= rank:
                    # geometric bucket midpoint: (edge/growth, edge]
                    return self.growth ** (idx - 0.5)
            return math.inf if self._n_inf else self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else math.nan,
                "max": self.max if self.count else math.nan,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


def _key(name: str, labels: Mapping[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create instrument families keyed by (name, label set).

    >>> reg = MetricsRegistry()
    >>> reg.counter("requests_completed", label="phi").inc()
    >>> reg.histogram("ttft_s", label="phi").observe(0.012)
    >>> snap = reg.snapshot()
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, **labels: str) -> Counter:
        key = _key(name, labels)
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = self._counters[key] = Counter()
        return inst

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = _key(name, labels)
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = self._gauges[key] = Gauge()
        return inst

    def histogram(self, name: str, growth: float = 1.1,
                  **labels: str) -> Histogram:
        key = _key(name, labels)
        with self._lock:
            inst = self._histograms.get(key)
            if inst is None:
                inst = self._histograms[key] = Histogram(growth=growth)
        return inst

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-able view of every instrument (NaN/inf survive as floats;
        serialize with a NaN-tolerant encoder or scrub downstream)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(histograms.items())},
        }


class RequestAggregate:
    """Incremental `METRIC_KEYS`-shaped accounting for one label.

    The O(1)-per-completion replacement for rescanning every completed
    request on each `ServingCluster.metrics_by_label` call: means are
    exact running sums (non-finite TTFT/TPOT fold in exactly as
    ``np.mean`` would), p99 comes from the log-bucketed sketch (~5%
    relative error).
    """

    __slots__ = ("completed", "_ttft_sum", "_tpot_sum",
                 "_ttft_hist", "_tpot_hist")

    def __init__(self):
        self.completed = 0
        self._ttft_sum = 0.0
        self._tpot_sum = 0.0
        self._ttft_hist = Histogram()
        self._tpot_hist = Histogram()

    def observe(self, ttft_s: float, tpot_s: float) -> None:
        self.completed += 1
        self._ttft_sum += ttft_s
        self._tpot_sum += tpot_s
        self._ttft_hist.observe(ttft_s)
        self._tpot_hist.observe(tpot_s)

    def metrics(self) -> Dict[str, float]:
        """The `repro_torch.serving.engine.METRIC_KEYS` dict (NaN-filled when
        nothing completed, like ``compute_metrics([])``)."""
        if self.completed == 0:
            return {"completed": 0,
                    "ttft_mean_s": math.nan, "ttft_p99_s": math.nan,
                    "tpot_mean_s": math.nan, "tpot_p99_s": math.nan}
        return {"completed": self.completed,
                "ttft_mean_s": self._ttft_sum / self.completed,
                "ttft_p99_s": self._ttft_hist.quantile(0.99),
                "tpot_mean_s": self._tpot_sum / self.completed,
                "tpot_p99_s": self._tpot_hist.quantile(0.99)}
