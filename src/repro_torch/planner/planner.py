"""`WorkloadPlanner`: demand forecast -> typed `PlanAction` sequence,
executed through the cluster's ticketed async machinery.

This is the piece that makes the repo *choose* configurations instead of
only executing them: the threshold `ElasticPolicy` reacts to queue depth
and is blind to hardware heterogeneity and latency targets; the planner
runs the `search` over (engine count x plan variant x device profile)
candidates, scored by the `estimator` over counted decode-step
features, against the
`LoadTracker`'s demand forecast and the intent-compiled service-level
targets (Φ_L) and scale bounds (Φ_S).

Switching discipline (the planner must not flap):

  * DWELL — after executing any action, no further plan changes for
    ``dwell`` planning rounds (floor violations and infeasibility are
    exempt: a mandatory floor is enforced immediately);
  * AMORTIZATION — a switch that only saves cost (no violation fixed)
    must pay for itself: predicted engine-cost saving over ``horizon_s``
    must exceed the estimated switching cost (observed PREPARE times
    from the cluster's own `DowntimeReport` history, plus a migration
    estimate), times a safety ``switch_margin``;
  * TICKET-AWARENESS — capacity whose background PREPARE is already in
    flight (`ServingCluster.pending_spawn_labels`) counts as existing,
    so a slow PREPARE never triggers duplicate spawns.

Execution maps actions onto the existing state machines — nothing new
runs in a blocking window: spawn -> `spawn_engine_async`, reconfigure ->
`reconfigure_async`, retire -> `retire_engine` (migrate mode when peers
can hold the in-flight work), migrate -> `migrate_requests`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs import events as obs_events
from repro_torch.planner.catalog import DeviceProfile, calibrate_host_profile
from repro_torch.planner.estimator import (
    CostEstimate,
    CostFeatures,
    ResidualCalibration,
    estimate,
    estimate_disagg,
    features_from_engine,
)
from repro_torch.planner.search import (
    Bounds,
    EngineSpec,
    LabelDemand,
    ScoredCandidate,
    best_candidate,
    demand_from_tracker,
    score_current,
)
from repro_torch.serving.clock import SYSTEM_CLOCK
from repro_torch.serving.cluster import ServingCluster
from repro_torch.sharding.plan import plan_satisfies

SLOTargets = Dict[str, Tuple[Optional[float], Optional[float]]]


@dataclasses.dataclass(frozen=True)
class PlanAction:
    """One typed reconfiguration step emitted by the planner.

    Attributes:
        kind: ``"spawn" | "retire" | "reconfigure" | "migrate"``.
        label: the workload label the action serves.
        engine: target engine name (source engine for ``migrate``;
            empty for a spawn — the planner names spawned engines).
        target: destination engine for ``migrate``.
        spec: the `EngineSpec` to instantiate (spawn / reconfigure).
        profile: the device profile the engine is placed on.
        mode: retirement mode (``"drain"`` / ``"migrate"``).
        reason: human-readable justification (telemetry).
        role: the serving role the action targets (``"unified"`` /
            ``"prefill"`` / ``"decode"`` — disaggregated configurations
            spawn and retire per role-tier).
    """

    kind: str
    label: str
    engine: str = ""
    target: str = ""
    spec: Optional[EngineSpec] = None
    profile: Optional[DeviceProfile] = None
    mode: str = "drain"
    reason: str = ""
    role: str = "unified"


class WorkloadPlanner:
    """Cost-model-driven configuration planner over a `ServingCluster`.

    Args:
        cluster: the cluster to plan for.
        engine_factory: ``factory(spec, label) -> ServingEngine`` building
            a fresh engine shaped by ``spec`` (the planner installs the
            label and the spec's merged plan itself).
        specs: candidate `EngineSpec` variants (plan variants from the
            compiler x slot sizings).
        profiles: the heterogeneous device pool (catalog profiles); the
            first entry is the default assumed for engines the planner
            did not place (see `attach_profile`).
        slo_targets: initial per-label ``(max_ttft_s, max_tpot_s)``
            targets; extended by intent application (`apply_policy`).
        tick_s: duration of one control-loop tick in seconds (converts
            the tracker's per-tick EWMA rates into per-second demand).
        new_tokens: generation-length prior for the forecast.
        min_rate: forecast rates at or below this floor (req/s) count as
            zero demand (see `search.demand_from_tracker`).
        rho_max: utilization ceiling (see `search.best_candidate`).
        dwell: planning rounds to hold still after executing actions.
        dwell_s: optional SECONDS-based dwell measured on the injected
            ``clock`` (None == rounds only): after executing actions, no
            non-mandatory plan change until ``dwell_s`` clock seconds
            have elapsed. With a simulated clock this makes the
            hysteresis a property of the replayed trace, not of how
            fast the host runs it.
        horizon_s: amortization horizon for pure cost-saving switches.
        switch_margin: safety multiplier on the switching cost.
        max_engines_per_label: enumeration cap for unbounded labels.
        calibration: an optional `ResidualCalibration` closing the
            predicted-vs-measured loop: fed by `observe_measurement` /
            `ingest_observations`, applied to every estimate the search
            scores. Cold calibration is the identity — wiring it in
            changes nothing until measurements arrive (fail-closed).
        clock: time source for ``dwell_s`` and round timestamps (default
            the real `SYSTEM_CLOCK`; inject a `FakeClock` to make the
            dwell follow simulated time).
    """

    def __init__(self, cluster: ServingCluster,
                 engine_factory: Callable[[EngineSpec, str], object], *,
                 specs: Sequence[EngineSpec],
                 profiles: Sequence[DeviceProfile],
                 slo_targets: Optional[SLOTargets] = None,
                 tick_s: float = 1.0,
                 new_tokens: float = 16.0,
                 min_rate: float = 0.0,
                 rho_max: float = 0.85,
                 dwell: int = 2,
                 dwell_s: Optional[float] = None,
                 horizon_s: float = 60.0,
                 switch_margin: float = 1.5,
                 max_engines_per_label: int = 4,
                 calibration: Optional[ResidualCalibration] = None,
                 clock=None):
        if not specs:
            raise ValueError("WorkloadPlanner needs at least one EngineSpec")
        if not profiles:
            raise ValueError("WorkloadPlanner needs at least one profile")
        self.cluster = cluster
        self.engine_factory = engine_factory
        self.specs = list(specs)
        self.profiles = list(profiles)
        self.slo_targets: SLOTargets = dict(slo_targets or {})
        self.bounds: Dict[str, Bounds] = {}
        self.tick_s = tick_s
        self.new_tokens = new_tokens
        self.min_rate = min_rate
        self.rho_max = rho_max
        self.dwell = max(0, dwell)
        self.dwell_s = dwell_s
        self.horizon_s = horizon_s
        self.switch_margin = switch_margin
        self.max_engines_per_label = max_engines_per_label
        self.calibration = calibration
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        # clock stamp of the last executed action (dwell_s reference);
        # None until something executes
        self._last_exec_t: Optional[float] = None
        # label -> completed count at the last metrics ingest (so
        # cumulative means are only folded when new completions exist)
        self._last_completed: Dict[str, float] = {}
        # engine name -> the profile it runs on (heterogeneity attachment)
        self._engine_profile: Dict[str, DeviceProfile] = {}
        # engine name -> the spec it was spawned/reconfigured with
        self._engine_spec: Dict[str, EngineSpec] = {}
        self._features: Dict[Tuple, CostFeatures] = {}
        self._since_exec = self.dwell       # first plan() may act at once
        self._seq = 0
        # every (action, result) ever executed, in order (telemetry)
        self.log: List[Tuple[PlanAction, object]] = []

    # ------------------------------------------------------------------
    # intent application (Orchestrator.submit(apply_to=planner))
    # ------------------------------------------------------------------
    def set_slo_target(self, label: str, max_ttft_s: Optional[float],
                       max_tpot_s: Optional[float]) -> None:
        """Pin a service-level target; repeated pins INTERSECT (the
        tighter target wins, mirroring scale-bound merge semantics)."""
        from repro_torch.core.intents import tighten_bound
        old_ttft, old_tpot = self.slo_targets.get(label, (None, None))
        self.slo_targets[label] = (
            tighten_bound(old_ttft, max_ttft_s),
            tighten_bound(old_tpot, max_tpot_s))

    def apply_policy(self, policy, components: Sequence = (), *,
                     async_prepare: bool = False) -> Dict[str, object]:
        """Intent hook: `Orchestrator.submit(text, apply_to=planner)`.

        Installs the compiled policy's service-level targets
        (``policy.slo_targets`` — the Φ_L objective) and per-label scale
        bounds (Φ_S), then delegates route-constraint installation and
        engine reconfiguration to the cluster's `apply_policy`.
        """
        for label, (ttft_s, tpot_s) in getattr(policy, "slo_targets",
                                               {}).items():
            self.set_slo_target(label, ttft_s, tpot_s)
        for label, (lo, hi) in getattr(policy, "scale_bounds", {}).items():
            self.bounds[label] = (lo, hi)
        return self.cluster.apply_policy(policy, components=components,
                                         async_prepare=async_prepare)

    def attach_profile(self, engine: str, profile: DeviceProfile) -> None:
        """Declare which device class ``engine`` runs on (engines the
        planner spawns are attached automatically)."""
        self._engine_profile[engine] = profile

    def attach_calibrated_profiles(self,
                                   names: Optional[Sequence[str]] = None
                                   ) -> DeviceProfile:
        """Attach the MEASURED profile of the cluster's device
        (`calibrate_host_profile`) to ``names`` (default: every
        registered engine), so estimates are made against the device
        the engines actually run on instead of a datasheet. Returns the
        profile (process-cached — one probe per device)."""
        profile = calibrate_host_profile(
            device=self.cluster.mesh.devices.reshape(-1)[0])
        for name in (names if names is not None
                     else self.cluster.engines()):
            self._engine_profile[name] = profile
        return profile

    # ------------------------------------------------------------------
    # cost features (cached per spec shape)
    # ------------------------------------------------------------------
    def features_for(self, spec: EngineSpec) -> CostFeatures:
        """Decode-step cost features for a spec (`features_from_engine`),
        cached by its SHAPE (n_slots, s_max, parallelism layout).
        Restriction fields are normalized out of the key: pins move
        tensors, they do not change the one-device probe step the
        features are counted over. The first call per shape builds one
        probe engine."""
        key = (spec.n_slots, spec.s_max,
               spec.plan.with_(device_constraints=(),
                               forbidden_collective_axes=()))
        if key not in self._features:
            probe = self.engine_factory(spec, "*")
            self._features[key] = features_from_engine(probe,
                                                       self.cluster.mesh)
        return self._features[key]

    # ------------------------------------------------------------------
    # calibration (predicted-vs-measured feedback)
    # ------------------------------------------------------------------
    def _estimate_fn(self, label: str, feats: CostFeatures,
                     profile: DeviceProfile, mix, engines: int
                     ) -> CostEstimate:
        """The search's scoring estimator: analytical roofline, with the
        label's learned residual factors applied when a calibration is
        installed (identity while cold — fail-closed)."""
        est = estimate(feats, profile, mix, engines=engines)
        if self.calibration is not None:
            est = self.calibration.apply(label, est)
        return est

    def _disagg_estimate_fn(self, label: str, pf_feats: CostFeatures,
                            de_feats: CostFeatures,
                            pf_profile: DeviceProfile,
                            de_profile: DeviceProfile, mix,
                            n_prefill: int, n_decode: int) -> CostEstimate:
        """The search's scorer for disaggregated (prefill-tier +
        decode-tier) candidates — same calibration hook as the unified
        estimator so both candidate families see corrected costs."""
        est = estimate_disagg(pf_feats, de_feats, mix,
                              prefill_profile=pf_profile,
                              decode_profile=de_profile,
                              prefill_engines=n_prefill,
                              decode_engines=n_decode)
        if self.calibration is not None:
            est = self.calibration.apply(label, est)
        return est

    @property
    def _disagg_specs(self) -> bool:
        """True when the catalog can express disaggregation (at least
        one prefill-role AND one decode-role spec) — gates the unified
        interference pricing in the hysteresis comparison so legacy
        catalogs score exactly as before."""
        roles = {s.role for s in self.specs}
        return "prefill" in roles and "decode" in roles

    def predicted_for(self, label: str, demand: LabelDemand, *,
                      calibrated: bool = True) -> Optional[CostEstimate]:
        """The planner's prediction for ``label``'s CURRENTLY deployed
        configuration under ``demand`` — the number the calibration loop
        compares against measurements. ``calibrated=False`` gives the
        raw analytical roofline (the baseline the calibrated estimator
        must beat). None when nothing serves the label."""
        spec_prof_n = self.current_config().get(label)
        if spec_prof_n is None or spec_prof_n[2] == 0:
            return None
        spec, profile, count = spec_prof_n
        est = estimate(self.features_for(spec), profile, demand.mix(),
                       engines=count)
        if calibrated and self.calibration is not None:
            est = self.calibration.apply(label, est)
        return est

    def observe_measurement(self, label: str, demand: LabelDemand, *,
                            measured_ttft_s: float,
                            measured_tpot_s: float) -> None:
        """Fold one measured TTFT/TPOT window into the calibration,
        paired with the ANALYTICAL prediction for the label's deployed
        configuration under ``demand`` (the residual is always learned
        against the uncorrected roofline, so repeated folding does not
        compound the correction). No-op without a calibration or when
        nothing serves the label."""
        if self.calibration is None:
            return
        predicted = self.predicted_for(label, demand, calibrated=False)
        if predicted is None:
            return
        self.calibration.observe(
            label, predicted_ttft_s=predicted.ttft_s,
            predicted_tpot_s=predicted.tpot_s,
            measured_ttft_s=measured_ttft_s,
            measured_tpot_s=measured_tpot_s)

    def ingest_observations(self, demand: Mapping[str, LabelDemand]
                            ) -> int:
        """Pull the cluster's cumulative per-label metrics and fold
        every label that COMPLETED NEW REQUESTS since the last ingest
        into the calibration. Returns the number of labels folded.
        (A replay harness with windowed metrics should prefer
        `observe_measurement` — cumulative means lag shifts in load.)"""
        if self.calibration is None:
            return 0
        folded = 0
        for label, m in self.cluster.metrics_by_label().items():
            if label == "*" or label not in demand:
                continue
            done = m.get("completed", 0)
            if done <= self._last_completed.get(label, 0):
                continue
            self._last_completed[label] = done
            self.observe_measurement(
                label, demand[label],
                measured_ttft_s=m.get("ttft_mean_s", 0.0),
                measured_tpot_s=m.get("tpot_mean_s", 0.0))
            folded += 1
        return folded

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------
    def forecast(self, tracker) -> Dict[str, LabelDemand]:
        """The demand forecast from a `LoadTracker` (see
        `search.demand_from_tracker`)."""
        return demand_from_tracker(tracker, self.cluster,
                                   tick_s=self.tick_s,
                                   new_tokens=self.new_tokens,
                                   min_rate=self.min_rate)

    def _dedicated(self, label: str) -> List[str]:
        """Non-draining engines dedicated to ``label``."""
        out = []
        for name in self.cluster.engines():
            try:
                eng = self.cluster.engine(name)
            except KeyError:
                continue
            if (eng.labels.get(self.cluster.ROUTE_KEY) == label
                    and name not in self.cluster.draining()):
                out.append(name)
        return out

    def _spec_of(self, name: str) -> EngineSpec:
        if name in self._engine_spec:
            return self._engine_spec[name]
        eng = self.cluster.engine(name)
        return EngineSpec(plan=eng.plan, n_slots=eng.n_slots,
                          s_max=eng.s_max,
                          role=getattr(eng, "role", "unified"))

    def _profile_of(self, name: str) -> DeviceProfile:
        return self._engine_profile.get(name, self.profiles[0])

    def current_config(self) -> Dict[str, Tuple[EngineSpec, DeviceProfile,
                                                int]]:
        """The deployed per-label configuration: (spec, profile, count)
        over dedicated engines, with capacity whose background PREPARE is
        in flight COUNTED AS DEPLOYED (ticket-awareness: a preparing
        spawn must suppress duplicate spawns)."""
        pending = self.cluster.pending_spawn_labels()
        out: Dict[str, Tuple[EngineSpec, DeviceProfile, int]] = {}
        labels = set(pending)
        for name in self.cluster.engines():
            lbl = self.cluster.engine(name).labels.get(
                self.cluster.ROUTE_KEY)
            if lbl:
                labels.add(lbl)
        for label in labels:
            names = self._dedicated(label)
            count = len(names) + pending.get(label, 0)
            spec = self._spec_of(names[0]) if names else self.specs[0]
            profile = self._profile_of(names[0]) if names \
                else self.profiles[0]
            out[label] = (spec, profile, count)
        return out

    def current_role_config(self) -> Dict[str, object]:
        """The deployed configuration in `score_current`'s role-aware
        shape: the legacy ``(spec, profile, count)`` triple for a label
        whose engines are all unified, a role dict
        ``{role: (spec, profile, count)}`` otherwise — with in-flight
        spawn tickets counted per role (`pending_spawn_roles`)."""
        pending = getattr(self.cluster, "pending_spawn_roles",
                          lambda: {})()
        out: Dict[str, object] = {}
        labels = set(pending)
        for name in self.cluster.engines():
            lbl = self.cluster.engine(name).labels.get(
                self.cluster.ROUTE_KEY)
            if lbl:
                labels.add(lbl)
        for label in labels:
            by_role: Dict[str, List[str]] = {}
            for name in self._dedicated(label):
                role = getattr(self.cluster.engine(name), "role",
                               "unified")
                by_role.setdefault(role, []).append(name)
            counts: Dict[str, int] = {
                r: len(names) for r, names in by_role.items()}
            for role, n in pending.get(label, {}).items():
                counts[role] = counts.get(role, 0) + n
            if set(counts) <= {"unified"}:
                names = by_role.get("unified", [])
                spec = self._spec_of(names[0]) if names else self.specs[0]
                profile = self._profile_of(names[0]) if names \
                    else self.profiles[0]
                out[label] = (spec, profile, counts.get("unified", 0))
                continue
            roles: Dict[str, Tuple[EngineSpec, DeviceProfile, int]] = {}
            for role, n in counts.items():
                names = by_role.get(role, [])
                spec = self._spec_of(names[0]) if names else next(
                    (s for s in self.specs if s.role == role),
                    self.specs[0])
                profile = self._profile_of(names[0]) if names \
                    else self.profiles[0]
                roles[role] = (spec, profile, n)
            out[label] = roles
        return out

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def propose(self, demand: Mapping[str, LabelDemand],
                bounds: Optional[Mapping[str, Bounds]] = None
                ) -> ScoredCandidate:
        """Run the configuration search for ``demand`` (no hysteresis —
        the raw optimum; `plan` wraps this with the switching
        discipline)."""
        merged_bounds = dict(self.bounds)
        merged_bounds.update(bounds or {})
        route_required = {
            label: self.cluster.required_for(
                {self.cluster.ROUTE_KEY: label})
            for label in set(demand) | set(merged_bounds)}
        return best_candidate(
            demand, self.slo_targets, specs=self.specs,
            profiles=self.profiles, features_fn=self.features_for,
            bounds=merged_bounds, route_required=route_required,
            rho_max=self.rho_max,
            max_engines_per_label=self.max_engines_per_label,
            estimate_fn=self._estimate_fn,
            disagg_estimate_fn=self._disagg_estimate_fn)

    def _switch_cost_s(self, n_events: int) -> float:
        """Estimated cost of executing ``n_events`` reconfigurations:
        the cluster's own observed PREPARE times (mean over history,
        1 s prior when none observed yet) per event."""
        prepares = [r.prepare_s for r in self.cluster.history
                    if r.prepare_s > 0]
        per = (sum(prepares) / len(prepares)) if prepares else 1.0
        return per * n_events

    def plan(self, demand: Mapping[str, LabelDemand],
             bounds: Optional[Mapping[str, Bounds]] = None
             ) -> List[PlanAction]:
        """Turn a demand forecast into the action sequence that moves the
        cluster to the best configuration — or an empty list when
        hysteresis says hold still.

        Pure decision logic: nothing is executed (see `execute`).
        """
        self._since_exec += 1
        merged_bounds = dict(self.bounds)
        merged_bounds.update(bounds or {})
        best = self.propose(demand, merged_bounds)
        current = self.current_role_config()
        cur_score = score_current(
            current, demand, self.slo_targets,
            features_fn=self.features_for, rho_max=self.rho_max,
            estimate_fn=self._estimate_fn,
            disagg_estimate_fn=self._disagg_estimate_fn,
            interference=self._disagg_specs)
        actions = self._diff(best, current, demand, merged_bounds)
        if not actions:
            self._emit_decision(demand, best, cur_score, [], "no-op")
            return []

        mandatory = best.violations < cur_score.violations \
            or any("floor" in a.reason or "infeasible" in a.reason
                   or "constraint" in a.reason for a in actions)
        if not mandatory:
            if self._since_exec <= self.dwell:
                # dwell: recently acted
                self._emit_decision(demand, best, cur_score, actions,
                                    "dwell-rounds")
                return []
            if (self.dwell_s is not None and self._last_exec_t is not None
                    and self.clock.time() - self._last_exec_t
                    < self.dwell_s):
                # dwell: clock says too soon
                self._emit_decision(demand, best, cur_score, actions,
                                    "dwell-clock")
                return []
            # pure cost-saving switch must amortize its switching cost
            saving = (cur_score.cost - best.cost) * self.horizon_s
            if saving <= self._switch_cost_s(len(actions)) \
                    * self.switch_margin:
                self._emit_decision(demand, best, cur_score, actions,
                                    "not-amortized")
                return []
        self._emit_decision(demand, best, cur_score, actions, "")
        return actions

    def _emit_decision(self, demand: Mapping[str, LabelDemand],
                       best: ScoredCandidate, cur_score: ScoredCandidate,
                       actions: Sequence[PlanAction], held: str) -> None:
        """Flight-recorder hook: one ``planner.decision`` record per
        planning round — the winning candidate's scores vs the current
        configuration's, the learned calibration residuals, and either
        the chosen actions or the hysteresis reason they were held."""
        rec = obs_events.RECORDER
        if rec is None:
            return
        residuals = {}
        if self.calibration is not None:
            residuals = {label: list(self.calibration.factors(label))
                         for label in sorted(demand)}
        rec.emit(
            "planner.decision",
            demand={lb: d.rate for lb, d in sorted(demand.items())},
            best_score=[best.violations, best.cost, best.headroom],
            best_config={lb: [a.count, a.profile.name]
                         for lb, a in sorted(best.config.items())},
            current_score=[cur_score.violations, cur_score.cost,
                           cur_score.headroom],
            residuals=residuals,
            infeasible=list(best.infeasible),
            held=held,
            actions=[{"kind": a.kind, "label": a.label, "engine": a.engine,
                      "mode": a.mode, "reason": a.reason}
                     for a in actions])

    def _diff(self, best: ScoredCandidate,
              current: Mapping[str, object],
              demand: Mapping[str, LabelDemand],
              bounds: Optional[Mapping[str, Bounds]] = None
              ) -> List[PlanAction]:
        """Per-(label, role) diff between the winning candidate and the
        deployed configuration. ``current`` values are either the legacy
        unified triple or a role dict (see `current_role_config`); a
        unified -> disaggregated transition therefore diffs as: spawn
        the prefill tier, spawn the decode tier, retire the unified
        engines — with spawns emitted BEFORE retires so new capacity is
        in flight before old capacity starts draining."""
        bounds = dict(self.bounds if bounds is None else bounds)
        spawns: List[PlanAction] = []
        others: List[PlanAction] = []
        pending = self.cluster.pending_spawn_labels()
        labels = sorted(set(best.config) | set(current))
        for label in labels:
            want = best.config.get(label)
            want_roles = want.by_role() if want is not None else {}
            cur_value = current.get(label)
            if cur_value is None:
                cur_roles: Dict[str, Tuple] = {}
            elif isinstance(cur_value, Mapping):
                cur_roles = {r: tuple(v) for r, v in cur_value.items()}
            else:
                cur_roles = {"unified": tuple(cur_value)}
            live_by_role: Dict[str, List[str]] = {}
            live_all = self._dedicated(label)
            for name in live_all:
                r = getattr(self.cluster.engine(name), "role", "unified")
                live_by_role.setdefault(r, []).append(name)
            cur_total = sum(v[2] for v in cur_roles.values())
            # counts include pending spawns; only live engines can be
            # retired or reconfigured
            for role in sorted(set(want_roles) | set(cur_roles)):
                wa = want_roles.get(role)
                want_n = wa.count if wa is not None else 0
                cur_n = cur_roles[role][2] if role in cur_roles else 0
                live = live_by_role.get(role, [])
                if want_n > cur_n:
                    lo, _ = bounds.get(label, (0, None))
                    for _ in range(want_n - cur_n):
                        why = (f"below floor: {cur_total} < min {lo}"
                               if cur_total < lo else
                               f"demand {demand.get(label, LabelDemand(0.0)).rate:.2f} req/s "
                               f"needs {want_n} x {wa.profile.name}"
                               + ("" if role == "unified"
                                  else f" ({role} tier)"))
                        spawns.append(PlanAction(
                            "spawn", label, spec=wa.spec,
                            profile=wa.profile, reason=why, role=role))
                elif want_n < cur_n:
                    # retire live engines only (pending tickets expire
                    # into capacity the next round re-evaluates), and keep
                    # ``want_n`` of them live: a spawn still in PREPARE is
                    # not capacity yet, so retiring a live engine in its
                    # place would leave the label unserved (fail-closed
                    # rejections) until it commits. The reference retires
                    # ``cur_n - want_n``; with nothing pending the two agree.
                    excess = max(len(live) - want_n, 0)
                    for name in self._retire_order(live)[:excess]:
                        mode = "migrate" \
                            if self._can_migrate(name, live_all) \
                            else "drain"
                        others.append(PlanAction(
                            "retire", label, engine=name, mode=mode,
                            role=role,
                            reason=f"demand needs only {want_n} "
                                   f"{role} engine(s)"))
                elif wa is not None and live \
                        and pending.get(label, 0) == 0:
                    # same count: reconfigure engines whose plan no
                    # longer matches the chosen spec. An engine whose
                    # DEPLOYED plan fails the label's route constraint
                    # is unroutable (fail-closed) — that reconfigure is
                    # mandatory, not a cost optimization.
                    required = self.cluster.required_for(
                        {self.cluster.ROUTE_KEY: label})
                    for name in live:
                        deployed = self.cluster.engine(name).plan
                        if self._spec_of(name).plan == wa.spec.plan \
                                and (required is None
                                     or plan_satisfies(deployed,
                                                       required)):
                            continue
                        stale = required is not None \
                            and not plan_satisfies(deployed, required)
                        others.append(PlanAction(
                            "reconfigure", label, engine=name,
                            spec=wa.spec, profile=wa.profile, role=role,
                            reason="route constraint no longer satisfied"
                                   if stale else "plan variant changed"))
        actions = spawns + others
        for label in best.infeasible:
            actions.append(PlanAction(
                "hold", label,
                reason="infeasible: no spec satisfies the route "
                       "constraint (fail-closed)"))
        return actions

    def _retire_order(self, names: List[str]) -> List[str]:
        """Retire the least-loaded engines first (cheapest to move)."""
        return sorted(names, key=lambda n: self.cluster.engine(n).load)

    def _can_migrate(self, name: str, peers: List[str]) -> bool:
        """Can ``name``'s in-flight work fit its peers' free slots?  If
        yes, a migrate-mode retirement reaps immediately instead of
        waiting out the longest decode."""
        eng = self.cluster.engine(name)
        resident = sum(r is not None for r in eng.slot_req)
        if resident == 0 and not eng.queue:
            return False               # drain is already instant
        free = sum(self.cluster.engine(p).free_slots
                   for p in peers if p != name
                   and not self.cluster.engine(p).paused)
        return free >= resident

    # ------------------------------------------------------------------
    # execution (through the ticketed async machinery)
    # ------------------------------------------------------------------
    def _spawn_name(self, label: str) -> str:
        taken = set(self.cluster.engines()) \
            | set(self.cluster.pending_spawns())
        name = f"{label}-pl{self._seq}"
        while name in taken:
            self._seq += 1
            name = f"{label}-pl{self._seq}"
        self._seq += 1
        return name

    def execute(self, actions: Sequence[PlanAction], *,
                async_spawn: bool = True) -> List[Tuple[PlanAction, object]]:
        """Execute a `plan` through the cluster's existing machinery.

        spawn -> `spawn_engine_async` (sync `spawn_engine` when
        ``async_spawn=False``), reconfigure -> `reconfigure_async`,
        retire -> `retire_engine`, migrate -> `migrate_requests`;
        ``"hold"`` actions (fail-closed infeasibility surfacing) execute
        nothing.

        Returns:
            ``[(action, result), ...]`` where result is a
            `PrepareTicket` for async spawns/reconfigures, a
            `DowntimeReport` for sync events, or ``None`` for holds.
            Also appended to ``self.log``.
        """
        out: List[Tuple[PlanAction, object]] = []
        for a in actions:
            if a.kind == "spawn":
                engine = self.engine_factory(a.spec, a.label)
                name = self._spawn_name(a.label)
                kw = dict(
                    plan=a.spec.plan,
                    labels={self.cluster.ROUTE_KEY: a.label},
                    # decode-role engines never prefill a prompt — no
                    # point warming prefill lengths for them
                    prefill_lengths=(
                        () if a.spec.role == "decode"
                        else self.cluster.label_prompt_lengths(a.label)))
                if a.spec.role != "unified":
                    kw["role"] = a.spec.role
                if async_spawn:
                    res = self.cluster.spawn_engine_async(name, engine,
                                                          **kw)
                else:
                    res = self.cluster.spawn_engine(name, engine, **kw)
                self._engine_spec[name] = a.spec
                if a.profile is not None:
                    self._engine_profile[name] = a.profile
            elif a.kind == "retire":
                res = self.cluster.retire_engine(a.engine, mode=a.mode)
                self._engine_spec.pop(a.engine, None)
                self._engine_profile.pop(a.engine, None)
            elif a.kind == "reconfigure":
                res = self.cluster.reconfigure_async(a.engine, a.spec.plan)
                self._engine_spec[a.engine] = a.spec
                if a.profile is not None:
                    self._engine_profile[a.engine] = a.profile
            elif a.kind == "migrate":
                res = self.cluster.migrate_requests(a.engine, a.target)
            elif a.kind == "hold":
                res = None
            else:
                raise ValueError(f"unknown PlanAction kind {a.kind!r}")
            out.append((a, res))
            self.log.append((a, res))
            rec = obs_events.RECORDER
            if rec is not None:
                rec.emit("planner.execute", engine=a.engine, label=a.label,
                         action=a.kind, mode=a.mode, reason=a.reason,
                         role=a.role)
        if any(a.kind != "hold" for a in actions):
            self._since_exec = 0
            self._last_exec_t = self.clock.time()
        return out

    def step(self, tracker, *, async_spawn: bool = True
             ) -> List[Tuple[PlanAction, object]]:
        """One standalone planning round: forecast -> plan -> execute.
        (The `Autoscaler`'s planner mode drives the same three calls from
        its tick loop so events/trajectory are recorded uniformly.)"""
        return self.execute(self.plan(self.forecast(tracker)),
                            async_spawn=async_spawn)

    def mandatory_fix(self, label: str, reason: str = "") -> None:
        """Watchtower hook: a fired alert (SLO burn, estimator drift,
        starvation) overrides hold-still hysteresis so the NEXT planning
        round may act immediately — the dwell-round and dwell-clock
        gates are cleared. The plan itself is unchanged: if the search
        already considers the current configuration best, nothing
        executes (an alert is evidence the envelope broke, not an order
        to thrash)."""
        self._since_exec = max(self._since_exec, self.dwell + 1)
        self._last_exec_t = None
        rec = obs_events.RECORDER
        if rec is not None:
            rec.emit("planner.mandatory_fix", label=label, reason=reason)
