"""Configuration search: enumerate candidate cluster configurations and
score them against a demand forecast.

A candidate assigns, per workload label: an `EngineSpec` (plan variant +
slot/pool sizing), a `DeviceProfile` (which hardware class serves it —
this is where heterogeneity enters), and an engine count. The search

  * prunes FAIL-CLOSED: a spec whose plan cannot be made to satisfy the
    label's route constraint (same `merge_restrictions` semantics the
    autoscaler uses for spawns) is never a candidate, and engine counts
    outside the intent-pinned scale bounds are never enumerated;
  * scores each surviving candidate with the `estimator`: service-level
    violations first (TTFT/TPOT targets missed, memory that does not fit,
    utilization above the headroom ceiling), then engine cost
    (count x devices x the profile's ``cost_rate`` — the engine-seconds
    objective), then spare headroom as the tie-break;
  * exploits that the score is separable per label (no cross-label
    resource coupling in the current model), so the joint optimum is the
    per-label optimum — documented, and revisited when a shared device
    pool cap lands.

The demand forecast comes from the `LoadTracker`'s per-label EWMAs
(`demand_from_tracker`): observed arrival rates and live prompt lengths,
converted to requests/second by the control loop's tick duration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.planner.catalog import DeviceProfile
from repro_torch.planner.estimator import (
    CostEstimate,
    CostFeatures,
    TrafficMix,
    estimate,
    estimate_disagg,
    prefill_interference,
)
from repro_torch.sharding.plan import (
    ShardingPlan,
    merge_restrictions,
    plan_satisfies,
)

Bounds = Tuple[int, Optional[int]]

# (label, features, profile, mix, engines) -> CostEstimate. The label
# argument is what lets a `ResidualCalibration`-backed estimator apply
# per-label residual factors inside the search.
EstimateFn = Callable[[str, CostFeatures, DeviceProfile, TrafficMix, int],
                      CostEstimate]

# (label, prefill_features, decode_features, prefill_profile,
#  decode_profile, mix, prefill_engines, decode_engines) -> CostEstimate,
# the disaggregated-configuration scorer (see `estimate_disagg`).
DisaggEstimateFn = Callable[
    [str, CostFeatures, CostFeatures, DeviceProfile, DeviceProfile,
     TrafficMix, int, int], CostEstimate]


def _analytical(label: str, feats: CostFeatures, profile: DeviceProfile,
                mix: TrafficMix, engines: int) -> CostEstimate:
    """The default `EstimateFn`: the pure roofline, label-blind."""
    return estimate(feats, profile, mix, engines=engines)


def _analytical_disagg(label: str, pf_feats: CostFeatures,
                       de_feats: CostFeatures, pf_profile: DeviceProfile,
                       de_profile: DeviceProfile, mix: TrafficMix,
                       n_prefill: int, n_decode: int) -> CostEstimate:
    """The default `DisaggEstimateFn`: `estimate_disagg`, label-blind,
    no handoff surcharge (the measured pause is < 50 ms — negligible
    against second-scale TTFT targets; a calibrated planner can price
    it via its own closure)."""
    return estimate_disagg(pf_feats, de_feats, mix,
                           prefill_profile=pf_profile,
                           decode_profile=de_profile,
                           prefill_engines=n_prefill,
                           decode_engines=n_decode)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One engine shape a candidate may instantiate: a plan variant plus
    the KV-pool sizing and its serving role. Hashable — the planner
    caches its counted decode-step cost features per spec.

    ``role``: ``"unified"`` specs are complete configurations on their
    own; ``"prefill"``/``"decode"`` specs only ever appear PAIRED in a
    disaggregated candidate (one tier each) — the search never proposes
    a bare prefill or decode tier.
    """

    plan: ShardingPlan
    n_slots: int = 4
    s_max: int = 128
    role: str = "unified"

    def __post_init__(self):
        if self.role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown spec role {self.role!r}")


@dataclasses.dataclass(frozen=True)
class LabelDemand:
    """Forecast demand for one label.

    Attributes:
        rate: arrivals per second (the steady inflow).
        prompt_len: mean prompt length, tokens.
        new_tokens: mean generation length, tokens.
        queued: backlog — requests already waiting (queued or resident)
            that the rate forecast cannot see. During a flash crowd the
            EWMA rate converges to the arrival rate only after the burst;
            the backlog is what must ALSO drain through the capacity the
            planner sizes, or it drains at SLO-violating latency.
        drain_s: the horizon over which the planner wants the backlog
            gone; the backlog enters the effective rate as
            ``queued / drain_s`` extra arrivals per second.
    """

    rate: float
    prompt_len: float = 64.0
    new_tokens: float = 16.0
    queued: float = 0.0
    drain_s: float = 10.0

    @property
    def effective_rate(self) -> float:
        """Arrivals/s the capacity must actually absorb: the steady rate
        plus the backlog amortized over the drain horizon."""
        return self.rate + self.queued / max(self.drain_s, 1e-9)

    def mix(self) -> TrafficMix:
        return TrafficMix(prompt_len=self.prompt_len,
                          new_tokens=self.new_tokens,
                          rate=self.effective_rate)


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One (label, role)-slice of a candidate configuration."""

    spec: EngineSpec
    profile: DeviceProfile
    count: int


@dataclasses.dataclass(frozen=True)
class LabelAssignment:
    """One label's full slice of a candidate configuration: one
    `Assignment` for a unified label, one per role (prefill + decode)
    for a disaggregated one.

    Compatibility surface: ``count`` (total engines), ``spec`` /
    ``profile`` (the first — only, when unified — assignment's), so
    every pre-disaggregation consumer of ``config[label].count`` /
    ``.profile.name`` keeps reading the numbers it always did.
    """

    assignments: Tuple[Assignment, ...]

    @property
    def count(self) -> int:
        return sum(a.count for a in self.assignments)

    @property
    def spec(self) -> EngineSpec:
        return self.assignments[0].spec

    @property
    def profile(self) -> DeviceProfile:
        return self.assignments[0].profile

    @property
    def disaggregated(self) -> bool:
        return any(a.spec.role != "unified" for a in self.assignments)

    def by_role(self) -> Dict[str, Assignment]:
        """Role -> assignment (``{"unified": a}`` or
        ``{"prefill": ap, "decode": ad}``)."""
        return {a.spec.role: a for a in self.assignments}


@dataclasses.dataclass
class ScoredCandidate:
    """A fully scored candidate configuration.

    Ordering key (minimize, lexicographic): ``violations`` (graded: SLO
    misses / misfits count 1 each, overload counts 1 + the excess
    utilization — see `_violation`), then ``cost`` (engine-seconds
    weight), then ``-headroom`` (prefer spare capacity among equals).
    """

    config: Dict[str, LabelAssignment]
    violations: float
    cost: float
    headroom: float
    per_label: Dict[str, CostEstimate]
    infeasible: List[str]        # labels no candidate could legally serve

    def sort_key(self) -> Tuple[float, float, float]:
        return (self.violations, self.cost, -self.headroom)


def demand_from_tracker(tracker, cluster, *, tick_s: float = 1.0,
                        new_tokens: float = 16.0,
                        default_prompt_len: float = 64.0,
                        min_rate: float = 0.0,
                        min_depth: float = 0.5,
                        drain_s: float = 10.0
                        ) -> Dict[str, LabelDemand]:
    """Derive the per-label demand forecast from a `LoadTracker`.

    The tracker's EWMAs are per control-loop tick; ``tick_s`` converts
    them to per-second rates (virtual-time loops pass their virtual tick
    duration). Prompt lengths come from the cluster's recently seen
    per-label lengths; generation length is the caller's prior (the
    runtime does not observe a request's budget until it completes).
    The ``"*"`` unlabeled bucket never owns capacity and is excluded,
    matching the autoscaler's convention.

    The forecast is rate AND backlog: the tracker's queue-depth EWMA
    (`LoadTracker.depth` — queued + resident requests) feeds
    ``LabelDemand.queued``, so during a flash crowd the planner sizes
    for the arrival rate PLUS the backlog draining over ``drain_s``
    seconds, instead of sizing for the steady rate while the queue
    drains at whatever latency the old capacity produces.

    ``min_rate``: rates at or below this floor (per second) forecast as
    ZERO demand — an EWMA decays geometrically and never quite reaches
    0, so without a floor a burst's tail would hold its last engine
    forever (the planner's analogue of `ElasticPolicy.retire_rate`).
    ``min_depth`` is the same floor for the backlog EWMA (requests).
    """
    if tick_s <= 0:
        raise ValueError(f"tick_s must be positive, got {tick_s}")
    depth_fn = getattr(tracker, "depth", None)
    out: Dict[str, LabelDemand] = {}
    for label in tracker.labels():
        if label == "*":
            continue
        lengths = cluster.label_prompt_lengths(label)
        prompt = (sum(lengths) / len(lengths)) if lengths \
            else default_prompt_len
        rate = tracker.rate(label) / tick_s
        if rate <= min_rate:
            rate = 0.0
        queued = float(depth_fn(label)) if depth_fn is not None else 0.0
        if queued <= min_depth:
            queued = 0.0
        out[label] = LabelDemand(rate=rate, prompt_len=prompt,
                                 new_tokens=new_tokens,
                                 queued=queued, drain_s=drain_s)
    return out


def eligible_specs(specs: Sequence[EngineSpec],
                   required: Optional[ShardingPlan]
                   ) -> List[EngineSpec]:
    """Fail-closed pruning: keep only specs whose plan, merged with the
    label's route constraint, actually satisfies it (a spec whose device
    pins conflict with the constraint degrades to unroutable under
    `merge_restrictions` — it must never be proposed). The surviving
    specs carry the MERGED plan, so a spawned engine is immediately
    routing-eligible."""
    if required is None:
        return list(specs)
    out = []
    for spec in specs:
        merged = merge_restrictions(spec.plan, required)
        if plan_satisfies(merged, required):
            out.append(dataclasses.replace(spec, plan=merged))
    return out


def _count_range(bounds: Bounds, max_engines: int) -> range:
    """Counts to enumerate: ``max_engines`` caps only UNBOUNDED labels —
    an explicit intent-pinned max is honored as stated."""
    lo, hi = bounds
    if hi is None:
        hi = max_engines
    return range(max(lo, 0), max(hi, lo) + 1)


def _violation(est: CostEstimate,
               targets: Tuple[Optional[float], Optional[float]],
               rho_max: float) -> float:
    """Graded violation score for one label's estimate. Zero when the
    SLO targets hold and utilization stays under the headroom ceiling.
    Overload contributes 1 PLUS the (clipped) excess utilization, so
    when every enumerable count violates, the search still prefers the
    configuration that covers the MOST demand — a binary score would
    tie all violators and let the cost term scale capacity DOWN exactly
    when demand spikes past the ceiling."""
    viol = 0.0
    if not est.meets(*targets):
        viol += 1.0
    if est.utilization > rho_max:
        viol += 1.0 + min(est.utilization - rho_max, 9.0)
    return viol


def best_candidate(
    demand: Mapping[str, LabelDemand],
    targets: Mapping[str, Tuple[Optional[float], Optional[float]]],
    *,
    specs: Sequence[EngineSpec],
    profiles: Sequence[DeviceProfile],
    features_fn: Callable[[EngineSpec], CostFeatures],
    bounds: Optional[Mapping[str, Bounds]] = None,
    default_bounds: Bounds = (0, 4),
    route_required: Optional[Mapping[str, ShardingPlan]] = None,
    rho_max: float = 0.85,
    max_engines_per_label: int = 4,
    estimate_fn: Optional[EstimateFn] = None,
    disagg_estimate_fn: Optional[DisaggEstimateFn] = None,
) -> ScoredCandidate:
    """Pick the best configuration for the forecast demand.

    Args:
        demand: per-label `LabelDemand` (the forecast).
        targets: per-label ``(max_ttft_s, max_tpot_s)`` service-level
            targets (missing label / None entry == no target).
        specs: candidate `EngineSpec` plan/sizing variants. When BOTH a
            ``role="prefill"`` and a ``role="decode"`` spec survive a
            label's route pruning, disaggregated candidates (one tier
            each, every prefill×decode pairing over the profile catalog)
            are enumerated alongside the unified ones — and the unified
            ones are then priced WITH prefill/decode interference
            (`prefill_interference`), since that is exactly the cost
            disaggregation removes. With no role-tagged specs (the
            default catalogs) the enumeration and every number are
            unchanged.
        profiles: candidate `DeviceProfile`s (the heterogeneous pool).
        features_fn: spec -> `CostFeatures` (the planner's cached
            decode-step count; the search itself never runs a model).
        bounds: per-label intent-pinned (min, max) engine counts — a
            disaggregated candidate's TOTAL engine count (both tiers)
            honors them.
        default_bounds: bounds for labels not pinned.
        route_required: per-label route-constraint plans (fail-closed
            spec pruning).
        rho_max: utilization ceiling — demand above it counts as a
            violation even without an explicit SLO, so the search sizes
            capacity to demand like the threshold policy does, but
            model-driven.
        max_engines_per_label: enumeration cap when a label's max bound
            is unbounded.
        estimate_fn: the scoring estimator (default: the analytical
            roofline). A calibrated planner passes a closure applying
            its per-label `ResidualCalibration` factors, so learned
            residuals move the SAME lexicographic objective the
            analytical search uses.
        disagg_estimate_fn: the disaggregated-configuration scorer
            (default: `estimate_disagg`, no handoff surcharge).

    Returns:
        The best `ScoredCandidate`; ``config`` values are
        `LabelAssignment`s (one assignment for a unified label, a
        prefill + decode pair for a disaggregated one). Labels with
        demand but no legally servable spec are listed in
        ``infeasible`` (fail-closed: the planner surfaces them instead
        of proposing a non-compliant engine) and receive no assignment.
    """
    bounds = dict(bounds or {})
    route_required = dict(route_required or {})
    est_fn = estimate_fn or _analytical
    dis_fn = disagg_estimate_fn or _analytical_disagg
    labels = sorted(set(demand) | set(bounds))

    config: Dict[str, LabelAssignment] = {}
    per_label: Dict[str, CostEstimate] = {}
    infeasible: List[str] = []
    violations = 0
    cost = 0.0
    headroom = 0.0

    for label in labels:
        d = demand.get(label, LabelDemand(rate=0.0))
        lo_hi = bounds.get(label, default_bounds)
        cands = eligible_specs(specs, route_required.get(label))
        unified = [s for s in cands if s.role == "unified"]
        prefills = [s for s in cands if s.role == "prefill"]
        decodes = [s for s in cands if s.role == "decode"]
        # disaggregation is only on the table when both tiers survived
        # pruning; only then do unified candidates pay the interference
        # they actually suffer (pricing it in with nothing to compare
        # against would silently shift every legacy number)
        disagg = bool(prefills and decodes)
        if not unified and not disagg:
            if d.effective_rate > 0 or lo_hi[0] > 0:
                infeasible.append(label)
            continue
        ttft_t, tpot_t = targets.get(label, (None, None))
        best: Optional[Tuple[Tuple[float, float, float],
                             LabelAssignment, CostEstimate]] = None
        for spec in unified:
            feats = features_fn(spec)
            for profile in profiles:
                for count in _count_range(lo_hi, max_engines_per_label):
                    if count == 0:
                        # legal only when nothing demands capacity
                        if d.effective_rate > 0:
                            continue
                        a = LabelAssignment(
                            (Assignment(spec, profile, 0),))
                        key = (0.0, 0.0, 0.0)
                        if best is None or key < best[0]:
                            best = (key, a, est_fn(label, feats, profile,
                                                   d.mix(), 1))
                        continue
                    est = est_fn(label, feats, profile, d.mix(), count)
                    if disagg:
                        est = prefill_interference(est, d.mix(),
                                                   engines=count)
                    viol = _violation(est, (ttft_t, tpot_t), rho_max)
                    c = count * profile.cost_rate * profile.n_devices
                    hr = max(0.0, 1.0 - est.utilization)
                    key = (viol, c, -hr)
                    if best is None or key < best[0]:
                        best = (key, LabelAssignment(
                            (Assignment(spec, profile, count),)), est)
        if disagg and d.effective_rate > 0:
            counts = _count_range(lo_hi, max_engines_per_label)
            total_max = max(counts) if len(counts) else 0
            total_min = max(lo_hi[0], 2)   # one engine per tier, minimum
            for sp in prefills:
                pf_feats = features_fn(sp)
                for sd in decodes:
                    de_feats = features_fn(sd)
                    for pp in profiles:
                        for pd in profiles:
                            for n_p in range(1, total_max):
                                for n_d in range(1, total_max - n_p + 1):
                                    if n_p + n_d < total_min:
                                        continue
                                    est = dis_fn(label, pf_feats, de_feats,
                                                 pp, pd, d.mix(), n_p, n_d)
                                    viol = _violation(
                                        est, (ttft_t, tpot_t), rho_max)
                                    c = (n_p * pp.cost_rate * pp.n_devices
                                         + n_d * pd.cost_rate
                                         * pd.n_devices)
                                    hr = max(0.0, 1.0 - est.utilization)
                                    key = (viol, c, -hr)
                                    if best is None or key < best[0]:
                                        best = (key, LabelAssignment((
                                            Assignment(sp, pp, n_p),
                                            Assignment(sd, pd, n_d))), est)
        if best is None:
            infeasible.append(label)
            continue
        key, assignment, est = best
        config[label] = assignment
        per_label[label] = est
        violations += key[0]
        cost += key[1]
        headroom += -key[2]

    return ScoredCandidate(config=config, violations=violations, cost=cost,
                           headroom=headroom, per_label=per_label,
                           infeasible=infeasible)


def score_current(
    current: Mapping[str, object],
    demand: Mapping[str, LabelDemand],
    targets: Mapping[str, Tuple[Optional[float], Optional[float]]],
    *,
    features_fn: Callable[[EngineSpec], CostFeatures],
    rho_max: float = 0.85,
    estimate_fn: Optional[EstimateFn] = None,
    disagg_estimate_fn: Optional[DisaggEstimateFn] = None,
    interference: bool = False,
) -> ScoredCandidate:
    """Score the configuration that is ALREADY deployed, with the same
    objective `best_candidate` uses — the hysteresis comparison's other
    half (pass the same ``estimate_fn`` so both sides see the same
    calibrated costs).

    ``current`` values are either the legacy unified triple
    ``(spec, profile, count)`` or — for a disaggregated deployment — a
    role dict ``{"prefill": (spec, profile, count),
    "decode": (spec, profile, count)}`` (either role may be absent; a
    lone tier is graded like missing capacity since it cannot serve
    alone). Pass ``interference=True`` when the proposal side enumerated
    disaggregated candidates, so unified deployments pay the same
    prefill/decode interference `best_candidate` priced in — the
    hysteresis comparison must not compare an interference-free current
    against an interference-priced proposal.
    """
    est_fn = estimate_fn or _analytical
    dis_fn = disagg_estimate_fn or _analytical_disagg
    config: Dict[str, LabelAssignment] = {}
    per_label: Dict[str, CostEstimate] = {}
    violations = 0.0
    cost = 0.0
    headroom = 0.0
    # labels with demand but NO deployed capacity at all are violations
    # of the deployed config (demand.effective_rate > 0 and nothing
    # serves it); graded like total overload so the comparison scale
    # matches best_candidate's
    for label, d in demand.items():
        if label not in current and d.effective_rate > 0:
            violations += 2.0 + 9.0
    for label, value in current.items():
        d = demand.get(label, LabelDemand(rate=0.0))
        if isinstance(value, Mapping):
            roles = {r: tuple(v) for r, v in value.items()}
            pf = roles.get("prefill")
            de = roles.get("decode")
            config[label] = LabelAssignment(tuple(
                Assignment(s, p, n) for s, p, n in roles.values()))
            if (pf is None or de is None or pf[2] == 0 or de[2] == 0):
                # a lone tier can't serve: prefill-only never decodes,
                # decode-only never admits — missing capacity
                if d.effective_rate > 0:
                    violations += 2.0 + 9.0
                cost += sum(n * p.cost_rate * p.n_devices
                            for _, p, n in roles.values())
                continue
            est = dis_fn(label, features_fn(pf[0]), features_fn(de[0]),
                         pf[1], de[1], d.mix(), pf[2], de[2])
            per_label[label] = est
            violations += _violation(est, targets.get(label, (None, None)),
                                     rho_max)
            cost += (pf[2] * pf[1].cost_rate * pf[1].n_devices
                     + de[2] * de[1].cost_rate * de[1].n_devices)
            headroom += max(0.0, 1.0 - est.utilization)
            continue
        spec, profile, count = value
        a = LabelAssignment((Assignment(spec, profile, count),))
        config[label] = a
        if count == 0:
            if d.effective_rate > 0:
                violations += 2.0 + 9.0
            continue
        est = est_fn(label, features_fn(spec), profile, d.mix(), count)
        if interference:
            est = prefill_interference(est, d.mix(), engines=count)
        per_label[label] = est
        violations += _violation(est, targets.get(label, (None, None)),
                                 rho_max)
        cost += count * profile.cost_rate * profile.n_devices
        headroom += max(0.0, 1.0 - est.utilization)
    return ScoredCandidate(config=config, violations=violations, cost=cost,
                           headroom=headroom, per_label=per_label,
                           infeasible=[])
