"""Elastic autoscaling for `ServingCluster`: per-label load tracking,
spawn/retire/rebalance decisions, and intent-pinned scaling bounds.

The paper's online-reconfiguration machinery (PREPARE-phase warm-up and
decode-graph capture + blocking swap, <50 ms downtime) only pays off when
the system can *add and remove* capacity per workload class, not just
reconfigure one resident engine. This module closes that loop (LLM-Mesh-style elastic sharing):

    LoadTracker     per-label EWMA arrival rate + queue depth, fed from the
                    cluster's demand counters and `metrics()` aggregation;
    ElasticPolicy   hysteresis policy turning tracked load + scaling bounds
                    into `ScaleDecision`s (spawn a dedicated engine for a
                    hot label, retire a drained idle one, or REBALANCE an
                    idle engine onto the hot label when a resize beats a
                    cold spawn);
    Autoscaler      executes decisions through the cluster's elastic
                    lifecycle (`spawn_engine` / `retire_engine` /
                    `rebalance` — all built on pause/drain/swap/resume, so
                    scaling never captures on the serving path) and accepts
                    intent-compiled scaling bounds via `apply_policy`, i.e.
                    ``Orchestrator.submit(text, apply_to=autoscaler)``.

The control loop is tick-driven and uses virtual time (``dt``), so tests
and benchmarks are deterministic:

    scaler = Autoscaler(cluster, factory)
    while serving:
        ... submit requests, cluster.step() ...
        scaler.tick()          # observe -> decide -> scale

The reference's docs/architecture.md (autoscaler loop) and
docs/reconfiguration.md (worked example) tell the full story.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import events as obs_events
from repro_torch.serving.clock import SYSTEM_CLOCK
from repro_torch.serving.cluster import DowntimeReport, ServingCluster
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.prepare import FAILED, SWAPPED, PrepareTicket
from repro_torch.sharding.plan import (
    ShardingPlan,
    merge_restrictions,
    plan_satisfies,
)

# (min_engines, max_engines); max None == unbounded
Bounds = Tuple[int, Optional[int]]


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One autoscaling action, as emitted by `ElasticPolicy.decide`.

    Attributes:
        kind: ``"spawn"`` | ``"retire"`` | ``"rebalance"``.
        label: the ``data-type`` label value the decision serves.
        engine: target engine name (the engine to retire or retarget;
            empty for a spawn — the `Autoscaler` names spawned engines).
        reason: human-readable justification (telemetry / benchmark CSV).
        mode: retirement mode — ``"drain"`` (serve out the queue first)
            or ``"migrate"`` (live-migrate in-flight work to peers and
            reap immediately). Ignored for spawn/rebalance.
    """

    kind: str
    label: str
    engine: str = ""
    reason: str = ""
    mode: str = "drain"


class LoadTracker:
    """Per-label EWMA arrival rate and queue depth.

    Fed from `ServingCluster.arrivals()` (cumulative per-label submission
    counts, including fail-closed rejections — rejected demand is still
    demand) and `ServingCluster.queue_depth_by_label()`. Labels with no
    traffic are zero-filled by the cluster's per-label views, so every
    known label is always observable.

    Args:
        alpha: EWMA smoothing factor in (0, 1]; 1.0 == no smoothing.
    """

    def __init__(self, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._rate: Dict[str, float] = {}
        self._depth: Dict[str, float] = {}
        self._depth_tokens: Dict[str, float] = {}
        self._last_arrivals: Dict[str, int] = {}

    def observe(self, cluster: ServingCluster, dt: float = 1.0) -> None:
        """Fold one tick of cluster state into the EWMAs.

        Args:
            cluster: the cluster to sample.
            dt: virtual seconds since the previous observation (rates are
                per-``dt`` unit; keep it constant for deterministic runs).

        Raises:
            ValueError: if ``dt`` is not positive.
        """
        if dt <= 0:
            raise ValueError(f"dt must be positive, got {dt}")
        arrivals = cluster.arrivals()
        depths = cluster.queue_depth_by_label(extra_labels=self.labels())
        tok_depths = cluster.queued_tokens_by_label(
            extra_labels=self.labels())
        for label in set(arrivals) | set(depths) | set(self._rate):
            inst_rate = (arrivals.get(label, 0)
                         - self._last_arrivals.get(label, 0)) / dt
            self._rate[label] = (self._rate.get(label, 0.0)
                                 + self.alpha
                                 * (inst_rate - self._rate.get(label, 0.0)))
            d = float(depths.get(label, 0))
            self._depth[label] = (self._depth.get(label, 0.0)
                                  + self.alpha
                                  * (d - self._depth.get(label, 0.0)))
            t = float(tok_depths.get(label, 0))
            self._depth_tokens[label] = (
                self._depth_tokens.get(label, 0.0)
                + self.alpha * (t - self._depth_tokens.get(label, 0.0)))
        self._last_arrivals = arrivals

    def rate(self, label: str) -> float:
        """EWMA arrival rate (requests per ``dt`` unit) for ``label``;
        0.0 for labels never observed."""
        return self._rate.get(label, 0.0)

    def depth(self, label: str) -> float:
        """EWMA queued+resident request count for ``label``; 0.0 for
        labels never observed."""
        return self._depth.get(label, 0.0)

    def depth_tokens(self, label: str) -> float:
        """EWMA outstanding KV-token demand for ``label`` (the
        token-granular sibling of `depth` — what a paged pool's
        admission actually meters); 0.0 for labels never observed."""
        return self._depth_tokens.get(label, 0.0)

    def labels(self) -> List[str]:
        """All labels ever observed (including the ``"*"`` unlabeled
        bucket), sorted."""
        return sorted(set(self._rate) | set(self._depth))


class ElasticPolicy:
    """Hysteresis scaling policy: sustained overload spawns, sustained
    idleness retires, and a cooldown after every action prevents flapping.

    Decision rules, per label (the ``"*"`` unlabeled bucket is exempt —
    unlabeled traffic may land on any engine, so it never owns capacity):

      * below ``min``: spawn immediately (a pinned floor is mandatory,
        bypassing the sustain window) — but if the previous floor spawn
        added a dedicated engine without raising the eligible count, the
        floor is blocked by a constraint conflict that more spawns cannot
        fix, and the policy stops rather than accumulate never-eligible
        engines;
      * hot — EWMA queue depth per serving engine > ``spawn_depth`` (any
        demand at all counts as hot when NO engine serves the label) — for
        ``sustain`` consecutive ticks, and under ``max``: spawn, or
        rebalance an idle donor engine dedicated to a cold label when one
        exists above that label's floor (a resize beats a cold spawn);
      * cold — EWMA rate <= ``retire_rate`` and depth <= ``retire_depth``
        — for ``sustain`` ticks, and above ``min``: retire one engine
        DEDICATED to the label (never a shared engine) whose load is
        already zero — retirement strictly follows drain. With
        ``prefer_migrate`` and no drained candidate, a dedicated engine
        whose in-flight work FITS its peers' free slots is retired in
        ``"migrate"`` mode instead: its requests are live-migrated and
        the engine reaps immediately, bounding scale-down latency by the
        per-request migration pause rather than the longest decode;
      * after any action on a label (including the donor of a rebalance):
        no further action on it for ``cooldown`` ticks.

    The policy is stateful (per-label streaks and cooldowns); use one
    instance per control loop.
    """

    def __init__(self, *, spawn_depth: float = 4.0, retire_rate: float = 0.25,
                 retire_depth: float = 0.5, sustain: int = 2,
                 cooldown: int = 3, default_bounds: Bounds = (0, 4),
                 prefer_rebalance: bool = True,
                 prefer_migrate: bool = False):
        self.spawn_depth = spawn_depth
        self.retire_rate = retire_rate
        self.retire_depth = retire_depth
        self.sustain = max(1, sustain)
        self.cooldown = cooldown
        self.default_bounds = default_bounds
        self.prefer_rebalance = prefer_rebalance
        # opt-in fast scale-down (live migration); the default preserves
        # strict retire-follows-drain semantics
        self.prefer_migrate = prefer_migrate
        self._hot: Dict[str, int] = {}       # label -> consecutive hot ticks
        self._cold: Dict[str, int] = {}      # label -> consecutive cold ticks
        self._cooldown: Dict[str, int] = {}  # label -> ticks remaining
        # label -> (eligible n, dedicated total) snapshot at the last
        # floor-enforcement spawn: if the spawn added a dedicated engine
        # but n did not grow, the floor is blocked by a constraint
        # conflict and further spawns cannot help
        self._floor_probe: Dict[str, Tuple[int, int]] = {}

    def clear_cooldown(self, label: str) -> None:
        """Watchtower hook: drop ``label``'s post-action cooldown (and
        its sustain counters' inertia) so the next `decide` may act
        immediately. The decision rules themselves are unchanged —
        clearing hysteresis never forces an action, it only stops the
        policy from sitting out a confirmed incident."""
        self._cooldown.pop(label, None)

    # -- helpers -------------------------------------------------------
    def _dedicated_idle(self, cluster: ServingCluster, label: str,
                        claimed: set) -> List[str]:
        """Engines dedicated to ``label`` (engine label == label) with no
        queued or resident work and not already claimed by another
        decision this tick — the only legal retire/donor targets."""
        out = []
        for name in cluster.engines_for_label(label):
            eng = cluster.engine(name)
            if (name not in claimed
                    and eng.labels.get(cluster.ROUTE_KEY) == label
                    and eng.load == 0):
                out.append(name)
        return out

    def _dedicated_migratable(self, cluster: ServingCluster, label: str,
                              claimed: set) -> Optional[str]:
        """The least-loaded engine dedicated to ``label`` whose in-flight
        work fits into its peers' free capacity — a migrate-mode
        retirement can relocate everything and reap it immediately.
        Capacity is checked token-granularly as well as by decode lane:
        a paged peer admits by pages, so its free KV tokens (not its
        lane count) decide whether the resident extents fit. ``None``
        when no peer exists or capacity doesn't fit (fall back to
        waiting for a drain)."""
        names = cluster.engines_for_label(label)
        dedicated = [
            n for n in names
            if n not in claimed
            and cluster.engine(n).labels.get(cluster.ROUTE_KEY) == label]
        for name in sorted(dedicated, key=lambda n: cluster.engine(n).load):
            eng = cluster.engine(name)
            resident = sum(r is not None for r in eng.slot_req)
            resident_tok = sum(
                min(len(r.prompt) + r.max_new_tokens, eng.s_max)
                for r in eng.slot_req if r is not None)
            # only RUNNING peers count: the relocation refuses to strand
            # a decoding request on a paused engine
            peers = [p for p in names if p != name and p not in claimed
                     and not cluster.engine(p).paused]
            peers_free = sum(cluster.engine(p).free_slots for p in peers)
            peers_tok = sum(cluster.engine(p).free_tokens for p in peers)
            if peers and peers_free >= resident \
                    and peers_tok >= resident_tok:
                return name
        return None

    def _dedicated_total(self, cluster: ServingCluster, label: str) -> int:
        """Engines dedicated to ``label`` regardless of routing
        eligibility — the floor-enforcement backstop: capacity that exists
        but fails the route constraint means spawning MORE engines cannot
        help (a constraint conflict, not a capacity shortfall)."""
        return sum(
            1 for name in cluster.engines()
            if cluster.engine(name).labels.get(cluster.ROUTE_KEY) == label
            and name not in cluster.draining())

    def _donor(self, tracker: LoadTracker, cluster: ServingCluster,
               hot_label: str, bounds: Dict[str, Bounds],
               claimed: set) -> Optional[str]:
        """An idle engine dedicated to a cold label, above that label's
        floor, that can be retargeted at ``hot_label`` — and whose plan,
        once merged with the hot label's route constraint, would actually
        satisfy it (a donor whose device pins conflict with the
        constraint would come out of the swap unroutable for every
        label: worse than a cold spawn, not better)."""
        required = cluster.required_for({cluster.ROUTE_KEY: hot_label})
        for other in tracker.labels():
            if other in (hot_label, "*"):
                continue
            if (tracker.rate(other) > self.retire_rate
                    or tracker.depth(other) > self.retire_depth):
                continue
            lo, _ = bounds.get(other, self.default_bounds)
            if len(cluster.engines_for_label(other)) <= lo:
                continue
            for name in self._dedicated_idle(cluster, other, claimed):
                base = cluster.engine(name).plan
                if required is None or plan_satisfies(
                        merge_restrictions(base, required), required):
                    return name
        return None

    # -- the decision function -----------------------------------------
    def decide(self, tracker: LoadTracker, cluster: ServingCluster,
               bounds: Dict[str, Bounds]) -> List[ScaleDecision]:
        """Turn tracked load into scale decisions (at most one per label
        per tick). Pure decision logic — execution is the `Autoscaler`'s
        job.

        TICKET-AWARE: capacity whose background PREPARE is still in
        flight (`ServingCluster.pending_spawn_labels`) counts toward a
        label's engine count, so bursty load during a slow PREPARE sizes
        further scale-ups against what is already being built instead of
        re-requesting it every tick.

        Args:
            tracker: the observed per-label load.
            cluster: the live cluster (capacity + idleness queries only).
            bounds: per-label (min, max) engine counts; labels absent fall
                back to ``default_bounds``.

        Returns:
            The decisions for this tick, in label order.
        """
        decisions: List[ScaleDecision] = []
        claimed: set = set()          # engines already targeted this tick
        pending = cluster.pending_spawn_labels()
        labels = [v for v in set(tracker.labels()) | set(bounds) if v != "*"]
        for label in sorted(labels):
            lo, hi = bounds.get(label, self.default_bounds)
            n = len(cluster.engines_for_label(label)) \
                + pending.get(label, 0)

            # a pinned floor is mandatory — enforce before anything else.
            # Backstop: if the PREVIOUS floor spawn added a dedicated
            # engine without raising n, spawns are not becoming eligible
            # (constraint conflict) and repeating them cannot help — stop
            # until eligibility actually changes.
            if n < lo:
                dedicated = self._dedicated_total(cluster, label)
                probe = self._floor_probe.get(label)
                blocked = (probe is not None and n <= probe[0]
                           and dedicated > probe[1])
                if not blocked:
                    decisions.append(ScaleDecision(
                        "spawn", label,
                        reason=f"below floor: {n} < min {lo}"))
                    self._floor_probe[label] = (n, dedicated)
                    self._cooldown[label] = self.cooldown
                    self._hot[label] = self._cold[label] = 0
                continue
            self._floor_probe.pop(label, None)

            depth, rate = tracker.depth(label), tracker.rate(label)
            # with no engine at all, any real demand is hot (EWMAs decay
            # geometrically and never reach exactly 0 — compare against
            # the retire thresholds, not strict positivity)
            hot = (depth > self.retire_depth or rate > self.retire_rate) \
                if n == 0 else (depth / n > self.spawn_depth)
            cold = rate <= self.retire_rate and depth <= self.retire_depth
            self._hot[label] = self._hot.get(label, 0) + 1 if hot else 0
            self._cold[label] = self._cold.get(label, 0) + 1 if cold else 0

            if self._cooldown.get(label, 0) > 0:
                self._cooldown[label] -= 1
                continue

            if self._hot[label] >= self.sustain and (hi is None or n < hi):
                donor = self._donor(tracker, cluster, label, bounds,
                                    claimed) if self.prefer_rebalance \
                    else None
                if donor is not None:
                    decisions.append(ScaleDecision(
                        "rebalance", label, engine=donor,
                        reason=f"hot (depth/engine {depth/max(n,1):.1f} > "
                               f"{self.spawn_depth}); idle donor beats "
                               "cold spawn"))
                    claimed.add(donor)
                    donor_label = cluster.engine(donor).labels.get(
                        cluster.ROUTE_KEY, "*")
                    self._cooldown[donor_label] = self.cooldown
                else:
                    decisions.append(ScaleDecision(
                        "spawn", label,
                        reason=f"hot for {self._hot[label]} ticks "
                               f"(depth/engine {depth/max(n,1):.1f} > "
                               f"{self.spawn_depth})"))
                self._cooldown[label] = self.cooldown
                self._hot[label] = 0
            elif self._cold[label] >= self.sustain and n > lo:
                idle = self._dedicated_idle(cluster, label, claimed)
                if idle:               # retire strictly follows drain
                    decisions.append(ScaleDecision(
                        "retire", label, engine=idle[0],
                        reason=f"cold for {self._cold[label]} ticks "
                               f"(rate {rate:.2f} <= {self.retire_rate})"))
                    claimed.add(idle[0])
                    self._cooldown[label] = self.cooldown
                    self._cold[label] = 0
                elif self.prefer_migrate:
                    cand = self._dedicated_migratable(cluster, label,
                                                      claimed)
                    if cand is not None:   # relocate-and-reap immediately
                        decisions.append(ScaleDecision(
                            "retire", label, engine=cand, mode="migrate",
                            reason=f"cold for {self._cold[label]} ticks; "
                                   "peers have free slots — migrate "
                                   "in-flight work instead of draining"))
                        claimed.add(cand)
                        self._cooldown[label] = self.cooldown
                        self._cold[label] = 0
        return decisions


class Autoscaler:
    """Drives a `ServingCluster`'s elastic lifecycle from per-label load.

    Args:
        cluster: the cluster to scale.
        factory: ``factory(label) -> ServingEngine`` building a fresh
            engine for a label (model/params/slot sizing is the caller's
            policy). The autoscaler installs the label and a route-
            constraint-satisfying plan itself.
        policy: decision policy (default `ElasticPolicy()`).
        tracker: load tracker (default `LoadTracker()`).
        bounds: initial per-label (min, max) engine counts; extended by
            `set_bounds` or intent application (`apply_policy`).
        async_spawn: issue spawns through `spawn_engine_async`, so a
            scale-up's PREPARE never stalls the tick loop — the new
            engine joins the pool at a later step boundary. While a
            label's spawn is in flight, further spawn decisions for it
            are suppressed (capacity that is already being built is not
            re-requested every tick). Retire/rebalance stay synchronous:
            they move no PREPARE work.
        planner: a `repro_torch.planner.WorkloadPlanner` — PLANNER MODE: the
            threshold `policy` is replaced by cost-model-driven
            configuration planning (forecast -> search -> PlanAction
            diff), executed through the same machinery so ``events`` /
            ``trajectory`` / ``failures`` record uniformly. The
            tracker/bounds plumbing (and intent application via
            `apply_policy`) is shared; ``policy`` is ignored while a
            planner is installed.
        clock: the time source tick timestamps are read from (default
            the real `repro_torch.serving.clock.SYSTEM_CLOCK`). The decision
            path itself performs NO clock reads — sustain/cooldown
            hysteresis is counted in ticks, each worth ``dt`` virtual
            seconds — so injecting a simulated `FakeClock` makes the
            whole control loop wall-clock-free: a 10^6-request replay's
            scaling decisions depend only on the trace, never on how
            fast the host happens to run it.

    Attributes:
        events: ``[(ScaleDecision, DowntimeReport), ...]`` for every
            executed scale event, in order. With ``async_spawn``, a
            spawn's entry is appended at the tick that observes its
            commit.
        trajectory: per-tick ``{label: engine count, "total": n}``
            snapshots (the benchmark's engine-count trajectory).
        tick_times: per-tick timestamps on the injected ``clock``
            (parallel to ``trajectory``).
    """

    def __init__(self, cluster: ServingCluster,
                 factory: Callable[[str], ServingEngine], *,
                 policy: Optional[ElasticPolicy] = None,
                 tracker: Optional[LoadTracker] = None,
                 bounds: Optional[Dict[str, Bounds]] = None,
                 async_spawn: bool = False,
                 planner: Optional[object] = None,
                 clock=None):
        self.cluster = cluster
        self.factory = factory
        self.policy = policy or ElasticPolicy()
        self.tracker = tracker or LoadTracker()
        self.bounds: Dict[str, Bounds] = dict(bounds or {})
        self.async_spawn = async_spawn
        self.planner = planner
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.tick_times: List[float] = []
        self.events: List[Tuple[ScaleDecision, DowntimeReport]] = []
        # async spawns whose background PREPARE failed: (decision, error)
        # — surfaced here instead of silently vanishing from the loop
        self.failures: List[Tuple[ScaleDecision, BaseException]] = []
        self.trajectory: List[Dict[str, int]] = []
        # spawn decisions whose background PREPARE is still in flight
        self._pending: List[Tuple[ScaleDecision, PrepareTicket]] = []
        # label -> ticks to hold off respawning after a FAILED async
        # spawn (a deterministic PREPARE failure must not become one
        # expensive failing background PREPARE per tick, forever)
        self._spawn_backoff: Dict[str, int] = {}
        self._spawn_seq = 0

    # ------------------------------------------------------------------
    def set_bounds(self, label: str, lo: int, hi: Optional[int] = None
                   ) -> None:
        """Pin scaling bounds for a label: keep at least ``lo`` and at
        most ``hi`` (None == unbounded) engines able to serve it.

        Raises:
            ValueError: if ``lo`` is negative or exceeds ``hi``.
        """
        if lo < 0 or (hi is not None and lo > hi):
            raise ValueError(f"invalid bounds for {label!r}: ({lo}, {hi})")
        self.bounds[label] = (lo, hi)

    def apply_policy(self, policy, components: Sequence = (), *,
                     async_prepare: bool = False
                     ) -> Dict[str, DowntimeReport]:
        """Intent hook: `Orchestrator.submit(text, apply_to=autoscaler)`.

        Installs the compiled policy's per-label scaling bounds
        (``policy.scale_bounds``), then delegates route-constraint
        installation + engine reconfiguration to the underlying cluster's
        `apply_policy` (``async_prepare`` rides the concurrent-PREPARE
        path there). Bounds take effect on the next `tick()` — a pinned
        floor spawns immediately there.

        Returns:
            {engine name: DowntimeReport} for engines the cluster swapped
            (`PrepareTicket`s when ``async_prepare``).
        """
        for label, (lo, hi) in getattr(policy, "scale_bounds", {}).items():
            self.set_bounds(label, lo, hi)
        if self.planner is not None:
            # planner mode: Φ_L service-level targets + bounds flow into
            # the planner objective; route-constraint installation and
            # engine reconfiguration delegate to the cluster through it
            return self.planner.apply_policy(policy, components=components,
                                             async_prepare=async_prepare)
        return self.cluster.apply_policy(policy, components=components,
                                         async_prepare=async_prepare)

    # ------------------------------------------------------------------
    def _plan_for(self, label: str, base: ShardingPlan) -> ShardingPlan:
        """Merge the label's route constraint (if any — data-type AND
        matching selector constraints) into ``base`` so a spawned/
        rebalanced engine is immediately routing-eligible (same
        fail-closed merge semantics as cluster `apply_policy` swaps)."""
        required = self.cluster.required_for(
            {self.cluster.ROUTE_KEY: label})
        if required is None:
            return base
        return merge_restrictions(base, required)

    def _spawn_name(self, label: str) -> str:
        """A fresh engine name: skip names already live in the cluster OR
        reserved by an in-flight async spawn (a previous scaler instance
        or a manual registration may own them)."""
        taken = set(self.cluster.engines()) | set(self.cluster.pending_spawns())
        name = f"{label}-as{self._spawn_seq}"
        while name in taken:
            self._spawn_seq += 1
            name = f"{label}-as{self._spawn_seq}"
        self._spawn_seq += 1
        return name

    def _execute(self, d: ScaleDecision) -> DowntimeReport:
        if d.kind == "spawn":
            engine = self.factory(d.label)
            report = self.cluster.spawn_engine(
                self._spawn_name(d.label), engine,
                plan=self._plan_for(d.label, engine.plan),
                labels={self.cluster.ROUTE_KEY: d.label},
                prefill_lengths=self.cluster.label_prompt_lengths(d.label))
        elif d.kind == "retire":
            report = self.cluster.retire_engine(d.engine, mode=d.mode)
        elif d.kind == "rebalance":
            base = self.cluster.engine(d.engine).plan
            report = self.cluster.rebalance(
                d.engine, self._plan_for(d.label, base),
                labels={self.cluster.ROUTE_KEY: d.label},
                prefill_lengths=self.cluster.label_prompt_lengths(d.label))
        else:
            raise ValueError(f"unknown decision kind {d.kind!r}")
        return report

    def _spawn_async(self, d: ScaleDecision) -> PrepareTicket:
        """Issue one spawn through the concurrent-PREPARE path: the warm-up
        and capture run on the `PrepareWorker`; the tick loop never waits."""
        engine = self.factory(d.label)
        return self.cluster.spawn_engine_async(
            self._spawn_name(d.label), engine,
            plan=self._plan_for(d.label, engine.plan),
            labels={self.cluster.ROUTE_KEY: d.label},
            prefill_lengths=self.cluster.label_prompt_lengths(d.label))

    def _reap_pending(self) -> None:
        """Fold committed async spawns into ``events``; a FAILED spawn is
        recorded in ``failures`` and its label backs off for ``cooldown``
        ticks (cancelled tickets just drop — no capacity was promised)."""
        if not self._pending:
            return
        self.cluster.commit_ready()        # tick == a safe step boundary
        keep: List[Tuple[ScaleDecision, PrepareTicket]] = []
        for d, t in self._pending:
            if t.state == SWAPPED:
                self.events.append((d, t.report))
            elif t.state == FAILED:
                self.failures.append((d, t.error))
                self._spawn_backoff[d.label] = max(self.policy.cooldown, 1)
            elif not t.done():
                keep.append((d, t))
        self._pending = keep

    def pending_spawns(self) -> List[ScaleDecision]:
        """Spawn decisions whose background PREPARE is still in flight."""
        return [d for d, t in self._pending if not t.done()]

    def tick(self, dt: float = 1.0) -> List[ScaleDecision]:
        """One control-loop iteration: observe load, decide, execute.

        Args:
            dt: virtual seconds since the last tick (see
                `LoadTracker.observe`).

        Returns:
            The decisions executed this tick (empty most ticks). Every
            executed decision's `DowntimeReport` is appended to
            ``self.events`` (for async spawns: at the tick observing the
            commit); a per-label engine-count snapshot is appended to
            ``self.trajectory``.
        """
        self.tick_times.append(self.clock.time())
        for label in list(self._spawn_backoff):
            self._spawn_backoff[label] -= 1
            if self._spawn_backoff[label] <= 0:
                del self._spawn_backoff[label]
        self._reap_pending()
        self.tracker.observe(self.cluster, dt)
        if self.planner is not None:
            executed = self._tick_planner()
        else:
            decisions = self.policy.decide(self.tracker, self.cluster,
                                           self.bounds)
            inflight = {d.label for d, t in self._pending if not t.done()}
            inflight |= set(self._spawn_backoff)
            executed = []
            for d in decisions:
                if d.kind == "spawn" and d.label in inflight:
                    continue  # that capacity is already being prepared
                if d.kind == "spawn" and self.async_spawn:
                    self._pending.append((d, self._spawn_async(d)))
                    inflight.add(d.label)
                else:
                    self.events.append((d, self._execute(d)))
                executed.append(d)
        snap = {label: len(self.cluster.engines_for_label(label))
                for label in self.tracker.labels() if label != "*"}
        snap["total"] = len(self.cluster.engines())
        self.trajectory.append(snap)
        rec = obs_events.RECORDER
        if rec is not None:
            for d in executed:
                rec.emit("scale.decision", engine=d.engine, label=d.label,
                         action=d.kind, mode=d.mode, reason=d.reason,
                         mode_planner=self.planner is not None)
        return executed

    def mandatory_fix(self, label: str, reason: str = "") -> None:
        """Watchtower hook: a fired alert clears ``label``'s scaling
        hysteresis — the policy cooldown and any spawn backoff — so the
        next tick may react at once instead of waiting out timers meant
        for steady-state flap damping. In planner mode the planner's own
        dwell gates are cleared too (`WorkloadPlanner.mandatory_fix`)."""
        if hasattr(self.policy, "clear_cooldown"):
            self.policy.clear_cooldown(label)
        self._spawn_backoff.pop(label, None)
        if self.planner is not None:
            self.planner.mandatory_fix(label, reason=reason)
        rec = obs_events.RECORDER
        if rec is not None:
            rec.emit("scale.mandatory_fix", label=label, reason=reason)

    def _tick_planner(self) -> List[ScaleDecision]:
        """One planner-mode iteration: forecast -> plan -> execute, with
        the executed `PlanAction`s recorded as `ScaleDecision`-shaped
        events (async tickets fold into ``events`` at the tick observing
        their commit, exactly like threshold-mode spawns)."""
        demand = self.planner.forecast(self.tracker)
        backoff = set(self._spawn_backoff)
        actions = [a for a in self.planner.plan(demand, bounds=self.bounds)
                   if not (a.kind == "spawn" and a.label in backoff)]
        executed: List[ScaleDecision] = []
        for a, res in self.planner.execute(actions,
                                           async_spawn=self.async_spawn):
            d = ScaleDecision(a.kind, a.label, engine=a.engine,
                              reason=a.reason, mode=a.mode)
            if isinstance(res, PrepareTicket):
                if not res.done():
                    self._pending.append((d, res))
                elif res.state == SWAPPED:
                    self.events.append((d, res.report))
                elif res.state == FAILED:
                    self.failures.append((d, res.error))
                    self._spawn_backoff[a.label] = max(
                        getattr(self.policy, "cooldown", 1), 1)
            elif res is not None:          # sync DowntimeReport
                self.events.append((d, res))
            executed.append(d)
        return executed
