"""Seeded synthetic traffic generator.

Serverless LLM traffic is bursty and multi-tenant (LLM-Mesh's motivating
observation): arrival rates breathe on a diurnal cycle, flash crowds
multiply them for minutes at a time, tenants mix labels unevenly, and
prompt/decode lengths are heavy-tailed — with the occasional adversarial
flood of near-capacity prompts that stresses KV admission rather than
request count. `generate_trace` composes exactly those ingredients into
one deterministic trace: the same `TrafficPattern` (same seed) yields a
bitwise-identical request list, arrival times are monotone
non-decreasing, and the per-label mix converges to the configured
weights (held to the reference's generator by tests/test_torch_traffic.py).

The generator emits *shape only* — ``(t, label, prompt_len,
new_tokens)`` — so a trace is cheap to hold at 10^6 requests; the caller
materializes token arrays when it submits.

Arrival process: a non-homogeneous Poisson process, realized per
``bin_s`` slice — counts drawn from the rate integral over the slice,
offsets uniform within it. Prompt lengths are drawn from a ranked
bucket distribution with Zipf-like tail weight (mostly short, sometimes
long — buckets, not raw lengths, so a replay compiles a bounded ladder
of prefill shapes instead of one executable per distinct length).
Decode lengths are geometric (the memoryless heavy-ish tail), clipped
to the profile's cap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One generated request (shape only; tokens are materialized at
    replay time).

    Attributes:
        rid: request id, dense in arrival order (0..n-1).
        t: arrival time, seconds from trace start (monotone across the
            trace).
        label: the ``data-type`` label value.
        prompt_len: prompt length, tokens.
        new_tokens: generation budget, tokens.
    """

    rid: int
    t: float
    label: str
    prompt_len: int
    new_tokens: int


@dataclasses.dataclass(frozen=True)
class LabelProfile:
    """One tenant/label's traffic shape.

    Attributes:
        weight: relative share of base arrivals routed to this label.
        prompt_buckets: the prompt lengths this label draws from,
            ascending (a bounded ladder keeps replay compiles bounded).
        prompt_tail: Zipf exponent over the bucket ranks — bucket ``i``
            (0-based, shortest first) has weight ``(i+1) ** -tail``.
            Larger == shorter-dominated; 0 == uniform.
        new_tokens_mean: mean generation length (geometric draw).
        new_tokens_cap: hard cap on the generation budget.
    """

    weight: float = 1.0
    prompt_buckets: Tuple[int, ...] = (4, 6, 8, 12, 16)
    prompt_tail: float = 1.2
    new_tokens_mean: float = 3.0
    new_tokens_cap: int = 8

    def __post_init__(self):
        if self.weight < 0:
            raise ValueError(f"weight must be >= 0, got {self.weight}")
        if not self.prompt_buckets:
            raise ValueError("prompt_buckets must be non-empty")
        if self.new_tokens_mean < 1.0:
            raise ValueError("new_tokens_mean must be >= 1")


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """A transient rate multiplier: arrivals in ``[t_start, t_start +
    duration_s)`` are generated at ``multiplier`` x the ambient rate
    (all labels, or one ``label`` only)."""

    t_start: float
    duration_s: float
    multiplier: float = 4.0
    label: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class LongPromptFlood:
    """An adversarial window of near-capacity prompts: ``rate`` extra
    requests/s for ``label``, every one at ``prompt_len`` tokens — the
    attack that saturates paged-KV admission without moving request
    counts much."""

    t_start: float
    duration_s: float
    rate: float
    label: str
    prompt_len: int = 24
    new_tokens: int = 2


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """The full parameterization of one synthetic trace.

    Attributes:
        duration_s: trace length, simulated seconds.
        base_rate: mean ambient arrival rate, requests/s (before the
            diurnal modulation).
        labels: per-label `LabelProfile`s; label weights are normalized
            to a categorical mix.
        diurnal_amplitude: rate swing in [0, 1): rate(t) = base *
            (1 + A sin(2 pi t / period)).
        diurnal_period_s: one "day" of the diurnal cycle.
        flash_crowds: transient rate multipliers.
        floods: adversarial long-prompt windows.
        seed: the PRNG seed — the ONLY entropy source; a pattern is a
            pure function from seed to trace.
        bin_s: arrival-process slice width (resolution of the rate
            modulation).
    """

    duration_s: float
    base_rate: float
    labels: Mapping[str, LabelProfile]
    diurnal_amplitude: float = 0.4
    diurnal_period_s: float = 240.0
    flash_crowds: Tuple[FlashCrowd, ...] = ()
    floods: Tuple[LongPromptFlood, ...] = ()
    seed: int = 0
    bin_s: float = 1.0

    def __post_init__(self):
        if self.duration_s <= 0 or self.base_rate < 0:
            raise ValueError("duration_s must be > 0 and base_rate >= 0")
        if not self.labels:
            raise ValueError("at least one label profile is required")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.bin_s <= 0:
            raise ValueError("bin_s must be positive")

    def rate_at(self, t: float, label: Optional[str] = None) -> float:
        """The modulated ambient arrival rate at time ``t`` (requests/s
        across all labels; flood arrivals are additive on top). With
        ``label``, the rate seen by crowds pinned to that label."""
        r = self.base_rate * (
            1.0 + self.diurnal_amplitude
            * np.sin(2.0 * np.pi * t / self.diurnal_period_s))
        for c in self.flash_crowds:
            if c.t_start <= t < c.t_start + c.duration_s \
                    and (c.label is None or c.label == label):
                r *= c.multiplier
        return float(max(r, 0.0))


def _bucket_weights(profile: LabelProfile) -> np.ndarray:
    ranks = np.arange(1, len(profile.prompt_buckets) + 1, dtype=np.float64)
    w = ranks ** -profile.prompt_tail
    return w / w.sum()


def _draw_shape(rng: np.random.Generator, profile: LabelProfile,
                weights: np.ndarray) -> Tuple[int, int]:
    prompt = int(profile.prompt_buckets[
        rng.choice(len(profile.prompt_buckets), p=weights)])
    # geometric with the configured mean, clipped to the cap
    p = min(1.0 / profile.new_tokens_mean, 1.0)
    new = int(min(rng.geometric(p), profile.new_tokens_cap))
    return prompt, max(new, 1)


def generate_trace(pattern: TrafficPattern) -> List[TraceRequest]:
    """Generate the deterministic trace for ``pattern``.

    Returns:
        `TraceRequest`s sorted by arrival time (monotone
        non-decreasing), rids dense in that order. Same pattern ->
        bitwise-identical output.
    """
    rng = np.random.default_rng(pattern.seed)
    label_names = sorted(pattern.labels)
    weights = np.array([pattern.labels[v].weight for v in label_names],
                       dtype=np.float64)
    if weights.sum() <= 0:
        raise ValueError("label weights must sum to > 0")
    weights = weights / weights.sum()
    bucket_w = {v: _bucket_weights(pattern.labels[v]) for v in label_names}

    events: List[Tuple[float, str, int, int]] = []
    n_bins = int(np.ceil(pattern.duration_s / pattern.bin_s))
    for b in range(n_bins):
        t0 = b * pattern.bin_s
        width = min(pattern.bin_s, pattern.duration_s - t0)
        mid = t0 + width / 2.0
        # per-label expected counts: ambient share x label-aware crowds
        lam = np.array([pattern.rate_at(mid, v) for v in label_names],
                       dtype=np.float64) * weights * width
        counts = rng.poisson(lam)
        for v, k in zip(label_names, counts):
            if k == 0:
                continue
            offsets = np.sort(rng.uniform(0.0, width, size=int(k)))
            prof = pattern.labels[v]
            for off in offsets:
                prompt, new = _draw_shape(rng, prof, bucket_w[v])
                events.append((float(t0 + off), v, prompt, new))
        # adversarial floods: additive near-capacity prompts
        for f in pattern.floods:
            lo = max(f.t_start, t0)
            hi = min(f.t_start + f.duration_s, t0 + width)
            if hi <= lo:
                continue
            k = int(rng.poisson(f.rate * (hi - lo)))
            if k == 0:
                continue
            for off in np.sort(rng.uniform(lo, hi, size=k)):
                events.append((float(off), f.label, int(f.prompt_len),
                               int(f.new_tokens)))

    events.sort(key=lambda e: e[0])
    return [TraceRequest(rid=i, t=t, label=v, prompt_len=p, new_tokens=n)
            for i, (t, v, p, n) in enumerate(events)]


def label_mix(trace: List[TraceRequest]) -> Dict[str, float]:
    """Empirical per-label request fractions of a trace."""
    counts: Dict[str, int] = {}
    for r in trace:
        counts[r.label] = counts.get(r.label, 0) + 1
    total = max(len(trace), 1)
    return {v: c / total for v, c in sorted(counts.items())}
