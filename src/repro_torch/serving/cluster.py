"""`ServingCluster`: the intent-driven serving control plane (the
reference's `repro.serving.cluster`, over the port's engines).

  * engines register with tenancy labels and a `ShardingPlan`;
  * labeled `Request`s are routed only to engines whose plan satisfies the
    route constraint compiled from the matching intent (phi -> pod-local
    engines); routing is FAIL-CLOSED — with no compliant engine the request
    is rejected, never silently served on a non-compliant one;
  * `reconfigure()` swaps a live engine onto a new plan with the
    prepare-ahead + blocking-swap protocol:

      PREPARE (serving continues): place the plan on the mesh
          (`plan_to_placement`) and warm prefill/decode on scratch state
          (`ServingEngine.prepare_executables`);
      SWAP (the downtime window):  pause -> drain -> place params + KV
          pool -> install what PREPARE warmed;
      RESUME.

    PREPARE is CONCURRENT with serving: `reconfigure_async` /
    `spawn_engine_async` return a `PrepareTicket` at once, the warm-up runs
    on the background `PrepareWorker` (repro_torch.serving.prepare) while
    requests keep flowing, and the swap commits at the next safe step
    boundary. A newer plan for the same engine supersedes (cancels) the
    older pending ticket. The sync `reconfigure`/`spawn_engine` run the
    SAME state machine inline.

    The returned `DowntimeReport` is finalized automatically: metrics_after
    snapshots at resume and is refreshed with the post-swap completion
    window by the next `run()`/`step()` that retires requests.

  * the cluster is ELASTIC: `spawn_engine` brings a new engine online
    through the same PREPARE path, `retire_engine` puts an engine into a
    DRAINING state (it stops receiving new requests, serves out its queue,
    and is deregistered once empty; its completions are retained for
    cluster metrics) or live-migrates its work away, and `rebalance`
    retargets an idle engine at a different label via the swap protocol.

A mesh here is a `repro_torch.sharding.Mesh` of ``torch.device``s with the
production axis names; one card is a 1×1×1 mesh. The compiled-artifact
check of the reference (collectives in the compiled HLO) reads the
collectives a traced decode step issues (`verify_engine_collectives`).

Typical flow (three lines of control plane):

    cluster.register("edge0", engine, plan=default_plan())
    orch.submit("Phi traffic must remain inside the pod.", apply_to=cluster)
    cluster.run()          # keep serving; routing now enforces the intent
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.obs import events as obs_events
from repro_torch.obs.metrics import RequestAggregate
from repro_torch.serving.engine import (
    Request,
    ServingEngine,
    compute_metrics,
)
from repro_torch.serving.migration import (
    MigrationError,
    MigrationRecord,
    migrate_many,
    needed_capacity,
)
from repro_torch.serving.prepare import (
    CANCELLED,
    FAILED,
    READY,
    PrepareTicket,
    PrepareWorker,
    default_worker,
)
from repro_torch.models.common import resolve_device
from repro_torch.sharding.plan import (
    Mesh,
    ShardingPlan,
    merge_restrictions,
    plan_satisfies,
    plan_to_placement,
    single_device_mesh,
)


class RoutingError(RuntimeError):
    """No registered engine satisfies the request's route constraint."""


@dataclasses.dataclass
class DowntimeReport:
    """Cost of one online scale/reconfiguration event (paper metrics:
    downtime + the TTFT/TPOT band before vs after the swap).

    Attributes:
        prepare_s: background PREPARE (warm-up) time; serving continues
            throughout.
        downtime_s: the blocking window. For a reconfigure/rebalance:
            drain + migrate + install. For a retirement the HONEST
            blocking cost: 0 for drain-mode (draining never blocks other
            engines), the measured relocation window for migrate-mode.
        migrate_bytes: bytes moved in the blocking window — params + KV
            pool for a swap, the migrated requests' KV state for a
            migrate-mode retirement.
        metrics_before: `compute_metrics` over the traffic window since the
            engine's previous scale event (empty-window NaNs for a spawn).
        metrics_after: `compute_metrics` over traffic served *after* the
            event. Auto-finalized: seeded with the empty window and
            refreshed by the next `ServingCluster.run()` that retires
            post-event completions (or at reap time for a retirement).
        engine: name of the affected engine.
        compiled_in_prepare: shapes PREPARE warmed ahead of the swap
            (decode + prompt lengths + buckets, the reference's count of
            executables compiled ahead).
        event: "reconfigure" | "spawn" | "retire" | "rebalance".
        migrations: per-request `MigrationRecord`s for migrate-mode
            retirements / explicit `migrate_requests` events — each
            carries the request's own pause (the paper's <50 ms budget).
    """

    prepare_s: float          # background warm-up time (serving continues)
    downtime_s: float         # blocking window (drain + migrate + install)
    migrate_bytes: int
    metrics_before: Dict[str, float]
    metrics_after: Dict[str, float]
    engine: str = ""
    compiled_in_prepare: int = 0   # shapes warmed ahead of the swap
    event: str = "reconfigure"
    migrations: Tuple[MigrationRecord, ...] = ()

    def summary(self) -> str:
        """One-line human-readable digest of the event cost."""
        s = (f"engine={self.engine or '?'} event={self.event} "
             f"prepare={self.prepare_s:.3f}s (warm x{self.compiled_in_prepare}) "
             f"downtime={self.downtime_s*1e3:.1f}ms "
             f"migrated={self.migrate_bytes/2**20:.1f}MiB")
        if self.migrations:
            s += (f" moved={len(self.migrations)}req "
                  f"pause_max={max(m.pause_s for m in self.migrations)*1e3:.1f}ms")
        return s


@dataclasses.dataclass
class _EngineEntry:
    name: str
    engine: ServingEngine
    pending_report: Optional[DowntimeReport] = None
    swap_t: float = 0.0
    draining: bool = False    # retiring: serves out its queue, gets no new work
    # collective validation failed after registration (e.g. a constraint
    # was installed later): the engine is unroutable until a reconfigure
    # passes verification — fail-closed beats serving on a disproven claim
    quarantined: bool = False
    # the pending-swap state machine (one ticket per engine; a newer plan
    # supersedes — i.e. cancels — the old ticket before it is applied)
    pending_ticket: Optional[PrepareTicket] = None
    # True only inside the blocking SWAP window of a commit; the router
    # must never choose a mid-swap engine (asserted by the stress tests)
    swapping: bool = False
    # completions already folded into the cluster's incremental per-label
    # aggregates (a consumed prefix of ``engine.done``)
    metrics_seen: int = 0

    # plan and labels read the live engine — one source of truth, so
    # updates after registration are visible to the router
    @property
    def plan(self) -> ShardingPlan:
        return self.engine.plan

    @property
    def labels(self) -> Dict[str, str]:
        return self.engine.labels

    def serves(self, labels: Dict[str, str]) -> bool:
        """Tenancy check: an engine label that contradicts a request label
        disqualifies; absent engine labels mean 'serves all'."""
        for k, v in labels.items():
            if k in self.labels and self.labels[k] != v:
                return False
        return True


class ServingCluster:
    """Multi-engine serving runtime with label-based fail-closed routing,
    online per-engine reconfiguration, and elastic spawn/retire lifecycle.

    The unlabeled-traffic bucket is tracked under the label value ``"*"``
    in the per-label views (`metrics_by_label`, `queue_depth_by_label`,
    `arrivals`).

    Args:
        mesh: the devices plans are placed on; a 1×1×1 mesh on ``device``
            when omitted.
        prepare_worker: the PREPARE thread pool (the process default when
            omitted).
        device: the card the default mesh holds; ``"cuda"`` unless the
            caller names the CPU.

    Raises:
        RuntimeError: no mesh is given, ``device`` is CUDA and no card is
            available.
    """

    ROUTE_KEY = "data-type"   # the label routing constraints key on
    #: pseudo-label under which `metrics_by_label` surfaces the flight
    #: recorder's ring health (drop counters) when recording is active
    OBS_LABEL = "obs:recorder"
    # retention cap on completions of retired engines: under continuous
    # spawn/retire churn the raw request list would otherwise grow with
    # total traffic ever served; beyond the cap the oldest completions
    # age out and cluster-level aggregates become windowed approximations
    RETIRED_DONE_CAP = 10_000

    def __init__(self, mesh: Optional[Mesh] = None, *,
                 prepare_worker: Optional[PrepareWorker] = None,
                 device: Union[str, torch.device] = "cuda"):
        # one card: a 1×1×1 mesh with the production axis names, so every
        # plan's pins resolve (by the modulo rule of `restrict_mesh`)
        self.mesh = mesh or single_device_mesh(resolve_device(device))
        self._entries: Dict[str, _EngineEntry] = {}
        self._routes: Dict[str, ShardingPlan] = {}   # label value -> required
        # route constraints beyond the single ROUTE_KEY value: each entry
        # is (selector, required) where selector is a multi-key label
        # mapping (ALL keys must match the request's labels) or an
        # arbitrary predicate callable(labels) -> bool. Matching
        # constraints MERGE with the data-type constraint (fail-closed:
        # conflicting pins degrade to unroutable axes).
        self._selector_routes: List[Tuple[Any, ShardingPlan]] = []
        self.history: List[DowntimeReport] = []
        self.rejected: List[Request] = []
        # serializes the control plane (routing decisions, swap commits,
        # registry mutation) against request threads: a submit observes
        # the cluster strictly before or strictly after a swap, never
        # mid-window. Reentrant: commits call back into routing helpers.
        self._lock = threading.RLock()
        # serializes engine-state surgery (swap commits, KV migration,
        # queue redistribution) against in-flight decode steps: any of
        # these may be driven from a control thread (e.g. a control
        # loop calling `commit_ready()`/`retire_engine`) while another
        # thread is inside `step()` — surgery landing mid-decode would
        # let the step's output clobber freshly migrated state.
        # Reentrant: a spawn commit redistributes queues under the lock
        # it already holds. Ordering: _lock is always taken BEFORE
        # _step_lock, never the reverse.
        self._step_lock = threading.RLock()
        # fast-path flag for the per-step commit hook: False until an
        # async PREPARE is staged, so pure-sync serving never pays the
        # pending-ticket scan on its hot path
        self._prepare_dirty = False
        # background-PREPARE machinery: worker pool (lazily the process
        # default) + spawn tickets for engines not yet in the registry
        self._prepare_worker = prepare_worker
        self._pending_spawns: Dict[str, PrepareTicket] = {}
        # routing decisions that picked an engine inside its blocking swap
        # window; structurally 0 (the lock serializes) — the concurrency
        # stress tests assert it stays that way
        self.midswap_routes = 0
        # completions of engines that have since been retired — retained so
        # cluster-level metrics never lose traffic to a scale-down
        self._retired_done: List[Request] = []
        # per-label demand counters (submissions, INCLUDING fail-closed
        # rejections — rejected demand is still demand a scaler may
        # fix by spawning a compliant engine)
        self._arrivals: Dict[str, int] = {}
        # per-label recently seen prompt lengths (length -> last-seen seq),
        # so a spawn can warm exactly the live traffic shapes
        self._label_lengths: Dict[str, Dict[int, int]] = {}
        self._length_seq = 0
        # incremental per-label completion aggregates: each engine's done
        # list is folded in once (entry.metrics_seen marks the consumed
        # prefix), so `metrics_by_label` is O(new completions) per call
        # instead of O(all completions ever)
        self._label_folds: Dict[str, RequestAggregate] = {}

    # ------------------------------------------------------------------
    # registration / introspection
    # ------------------------------------------------------------------
    def register(self, name: str, engine: ServingEngine, *,
                 plan: Optional[ShardingPlan] = None,
                 labels: Optional[Dict[str, str]] = None,
                 role: Optional[str] = None,
                 verify_collectives: bool = True) -> None:
        """Add an engine to the routing pool (no PREPARE warm-up — see
        `spawn_engine` for the elastic path that warms before serving).

        Args:
            name: unique engine name.
            engine: the `ServingEngine` to serve through.
            plan: if given, installed as ``engine.plan`` (routing reads the
                live engine, so this is the plan the router checks).
            labels: merged into ``engine.labels`` (tenancy restriction).
            role: if given, installed as ``engine.role`` —
                ``"prefill"``/``"decode"`` engines participate in the
                cluster's disaggregated first-token handoff (see `step`):
                new requests route only to prefill-capable engines
                (``role != "decode"``), and every request resident on a
                prefill-role engine is handed to a decode-role engine at
                its first-token boundary via the batched migration path.
                Non-unified engines get their migration ops pre-warmed
                here so the first handoff pays no first use.
            verify_collectives: check the collectives the engine's decode
                step issues against any already-installed route constraint
                it would serve under (see `verify_engine_collectives`) —
                the declared plan alone is a claim; the traced step is the
                proof. Skipped automatically when no constraint applies
                (the common register-then-constrain order pays nothing).

        Raises:
            ValueError: if ``name`` is already registered (or reserved by
                an in-flight `spawn_engine_async`), ``role`` is unknown,
                or (fail-closed) a recorded collective violates an applicable
                route constraint — the engine is NOT registered then.
        """
        with self._lock:
            self._drop_dead_spawns()
            if name in self._entries or name in self._pending_spawns:
                raise ValueError(f"engine {name!r} already registered")
            if plan is not None:
                engine.plan = plan
            if labels:
                engine.labels.update(labels)
            if role is not None:
                engine.role = role         # validates fail-closed
            # insert + verify atomically: the router must never observe
            # (and queue onto) an engine whose registration is about to
            # be rolled back fail-closed
            engine.obs_name = name
            self._entries[name] = _EngineEntry(name, engine)
            if verify_collectives:
                try:
                    self.verify_engine_collectives(name)
                except ValueError:
                    del self._entries[name]
                    raise
        if engine.role != "unified":
            # PREPARE-equivalent for the handoff path: warm the pool
            # surgery ops now, off the serving path, so the first
            # first-token handoff pays no first use inside its pause
            engine.warm_migration()

    def verify_engine_collectives(
            self, name: str, *, collectives: Optional[Sequence[Any]] = None,
            mesh_shape: Optional[Sequence[int]] = None,
            axis_names: Optional[Sequence[str]] = None) -> Optional[str]:
        """Validate the collectives an engine's decode step issues against
        the forbidden collective axes of every route constraint it could
        serve under (the reference checks compiled HLO: a plan's
        restriction fields are a declaration — the traced step's
        collectives are the artifact-level proof).

        Only constraints whose label the engine serves AND whose plan the
        engine claims to satisfy are checked (a non-eligible engine never
        receives that traffic — the router already fails closed).

        Args:
            name: the registered engine to check.
            collectives: override the recorded collectives (defaults to
                the engine's `decode_collectives`).
            mesh_shape / axis_names: topology to attribute each
                collective's ranks to mesh axes (defaults to the cluster
                mesh; one card is 1×1×1, where no collective can cross an
                axis).

        Returns:
            The check detail string, or ``None`` when no constraint
            applied (nothing to prove).

        Raises:
            KeyError: ``name`` is not registered.
            ValueError: fail-closed — a recorded collective crosses a
                forbidden axis, or the decode step could not be traced.
        """
        from repro_torch.core.validator import check_collective_axes   # no cycle
        entry = self._entries[name]
        axes: set = set()
        for value, required in self._routes.items():
            if entry.serves({self.ROUTE_KEY: value}) \
                    and plan_satisfies(entry.plan, required):
                axes |= set(required.forbidden_collective_axes)
        for sel, required in self._selector_routes:
            if not plan_satisfies(entry.plan, required):
                continue
            # mapping selectors scope by engine tenancy; a predicate's
            # label space cannot be enumerated — check conservatively
            # (more proof, never less: fail-closed)
            if callable(sel) or entry.serves(dict(sel)):
                axes |= set(required.forbidden_collective_axes)
        if not axes:
            return None
        if collectives is None:
            try:
                collectives = entry.engine.decode_collectives()
            except RuntimeError as err:
                raise ValueError(
                    f"engine {name!r} failed collective validation against "
                    f"route constraints (fail-closed): {err}") from err
        ok, msg = check_collective_axes(
            collectives, sorted(axes),
            tuple(mesh_shape) if mesh_shape else self.mesh.devices.shape,
            tuple(axis_names) if axis_names else self.mesh.axis_names)
        if not ok:
            raise ValueError(
                f"engine {name!r} failed collective validation against "
                f"route constraints (fail-closed): {msg}")
        return msg

    def engine(self, name: str) -> ServingEngine:
        """Return the registered engine ``name``.

        Raises:
            KeyError: if no engine of that name is registered (it may have
                been retired).
        """
        return self._entries[name].engine

    def engines(self) -> List[str]:
        """Names of all registered engines (including draining ones)."""
        with self._lock:
            return list(self._entries)

    def draining(self) -> List[str]:
        """Names of engines currently draining toward retirement."""
        with self._lock:
            return [n for n, e in self._entries.items() if e.draining]

    def route_constraints(self) -> Dict[str, ShardingPlan]:
        """Installed ``data-type`` route constraints: label value ->
        required plan (see `route_predicates` for the selector-based
        ones)."""
        return dict(self._routes)

    def route_predicates(self) -> List[Tuple[Any, ShardingPlan]]:
        """Installed selector-based route constraints: ``(selector,
        required plan)`` pairs, where selector is a multi-key label
        mapping or a predicate callable."""
        with self._lock:
            return list(self._selector_routes)

    @staticmethod
    def _selector_matches(selector: Any, labels: Dict[str, str]) -> bool:
        """Does a request's label set fall under a selector?  Mapping
        selectors require EVERY key to be present with the exact value
        (plain subset semantics — no ontology expansion on request
        labels); callables are arbitrary predicates over the label
        dict."""
        if callable(selector):
            return bool(selector(dict(labels)))
        return all(labels.get(k) == v for k, v in dict(selector).items())

    def required_for(self, labels: Dict[str, str]
                     ) -> Optional[ShardingPlan]:
        """THE route-constraint lookup: the merged required plan for a
        request carrying ``labels`` — its ``data-type`` constraint plus
        every matching selector constraint, merged with the fail-closed
        `merge_restrictions` semantics (conflicting pins degrade to
        unroutable axis forbids). ``None`` when nothing applies."""
        with self._lock:
            reqs: List[ShardingPlan] = []
            value = labels.get(self.ROUTE_KEY)
            if value is not None and value in self._routes:
                reqs.append(self._routes[value])
            for sel, required in self._selector_routes:
                if self._selector_matches(sel, labels):
                    reqs.append(required)
        if not reqs:
            return None
        if len(reqs) == 1:
            return reqs[0]
        return merge_restrictions(ShardingPlan(), *reqs)

    def set_route_constraint(self, value: str,
                             required: ShardingPlan, *,
                             verify_collectives: bool = True) -> None:
        """Require that requests labeled ``data-type=value`` be served only
        by engines whose plan satisfies `required` (see `plan_satisfies`).

        The register-then-constrain order is as fail-closed as the
        reverse: installing a constraint re-validates the collectives of
        every registered engine that would serve it and claims to satisfy
        it. An engine whose traced step disproves its declared plan
        is QUARANTINED (unroutable until a reconfigure passes
        verification) and a ValueError is raised — the constraint stays
        installed either way.

        Raises:
            ValueError: an engine failed collective validation (it has
                been quarantined; other engines were still checked).
        """
        self._routes[value] = required
        if not (verify_collectives and required.forbidden_collective_axes):
            return
        self._reverify_engines({self.ROUTE_KEY: value}, required)

    def set_route_predicate(self, selector, required: ShardingPlan, *,
                            verify_collectives: bool = True) -> None:
        """Install a route constraint scoped by a SELECTOR instead of a
        single ``data-type`` value: requests whose labels fall under
        ``selector`` may only be served by engines whose plan satisfies
        ``required`` — fail-closed exactly like `set_route_constraint`
        (no compliant engine means the request is rejected, never
        silently served).

        Args:
            selector: a multi-key label mapping (every key must match
                the request's labels, e.g. ``{"data-type": "phi",
                "app": "patient"}``) or an arbitrary predicate
                ``callable(labels) -> bool``.
            required: the constraint plan (restriction fields only).
            verify_collectives: re-validate the collectives of registered
                engines that would serve under the selector (mapping
                selectors only — a predicate's label space cannot be
                enumerated, so its engines are checked conservatively:
                every engine whose plan claims satisfaction).

        Raises:
            ValueError: an engine failed collective validation (it has
                been quarantined; the constraint stays installed).
        """
        with self._lock:
            self._selector_routes.append((selector, required))
        if not (verify_collectives and required.forbidden_collective_axes):
            return
        probe = dict(selector) if not callable(selector) else None
        self._reverify_engines(probe, required)

    def _reverify_engines(self, serve_labels: Optional[Dict[str, str]],
                          required: ShardingPlan) -> None:
        """Re-validate the collectives of engines affected by a newly
        installed constraint (``serve_labels=None`` == cannot scope by
        labels; check every plan-satisfying engine, fail-closed)."""
        errors = []
        for e in list(self._entries.values()):
            if e.quarantined or not plan_satisfies(e.plan, required):
                continue
            if serve_labels is not None and not e.serves(serve_labels):
                continue
            try:
                self.verify_engine_collectives(e.name)
            except ValueError as err:
                e.quarantined = True
                errors.append(str(err))
        if errors:
            raise ValueError("; ".join(errors))

    # ------------------------------------------------------------------
    # routing (fail-closed)
    # ------------------------------------------------------------------
    def _entry_eligible(self, e: _EngineEntry, labels: Dict[str, str],
                        required: Optional[ShardingPlan]) -> bool:
        """THE routing-eligibility predicate (one copy, shared by request
        routing, migration, and the per-label capacity view): not
        draining, not quarantined, tenancy labels don't contradict,
        plan satisfies the route constraint."""
        return (not e.draining and not e.quarantined and e.serves(labels)
                and (required is None or plan_satisfies(e.plan, required)))

    def eligible(self, req: Request) -> List[str]:
        """Engines allowed to serve ``req``: tenancy labels must not
        contradict, the engine's plan must satisfy every route
        constraint matching the request's labels (the ``data-type``
        constraint AND any selector/predicate constraints, merged), and
        the engine must not be draining. A ``role="decode"`` engine is
        never eligible for a NEW request — it has no routed prefill
        duty; it receives in-flight work only through the first-token
        handoff / migration paths (fail-closed: with only decode
        engines for a label, routing rejects rather than mis-placing)."""
        required = self.required_for(dict(req.labels))
        with self._lock:
            return [e.name for e in self._entries.values()
                    if self._entry_eligible(e, req.labels, required)
                    and e.engine.role != "decode"]

    def engines_for_label(self, value: str) -> List[str]:
        """Non-draining engines that could serve traffic labeled
        ``data-type=value`` under the current route constraints (the
        per-label capacity view a scaler reads)."""
        required = self.required_for({self.ROUTE_KEY: value})
        with self._lock:
            return [e.name for e in self._entries.values()
                    if self._entry_eligible(e, {self.ROUTE_KEY: value},
                                            required)]

    def route(self, req: Request) -> str:
        """Pick the least-loaded eligible engine for ``req``.

        Returns:
            The chosen engine name. Running engines are preferred; a paused
            engine still queues (documented lifecycle) but only when no
            running engine qualifies. Draining engines are never chosen.

        Raises:
            RoutingError: if no engine qualifies (fail-closed); the request
                is recorded in ``self.rejected``.
        """
        with self._lock:
            rec = obs_events.RECORDER
            if rec is None:
                return self._route_locked(req)
            # the span opens AFTER the cluster lock is held: routing and
            # swap commits serialize on the same lock, so a route span can
            # never overlap a swap-commit span (the trace PROVES the
            # no-mid-swap-routing invariant; stress tests check it)
            with rec.span("route", track="cluster", rid=req.rid) as args:
                name = self._route_locked(req)
                args["engine"] = name
                return name

    def _route_locked(self, req: Request) -> str:
        names = self.eligible(req)
        if not names:
            self.rejected.append(req)
            raise RoutingError(
                f"no compliant engine for request {req.rid} "
                f"(labels={req.labels}, constraint="
                f"{self._routes.get(req.labels.get(self.ROUTE_KEY))!r}) "
                "— failing closed")
        # an engine inside its blocking swap window is avoided while
        # any alternative exists (queueing on it is still legal — a
        # paused engine queues — but the lock means this is unreachable
        # in practice; the counter proves it to the stress tests)
        avail = [n for n in names if not self._entries[n].swapping]
        running = [n for n in (avail or names)
                   if not self._entries[n].engine.paused]
        chosen = min(running or avail or names,
                     key=lambda n: self._entries[n].engine.load)
        if self._entries[chosen].swapping:
            self.midswap_routes += 1
        return chosen

    def submit(self, req: Request) -> str:
        """Route + enqueue; returns the chosen engine name.

        Demand accounting happens BEFORE routing: per-label arrival counts
        and prompt lengths are recorded even when routing fails closed, so
        a scaler can see (and fix) rejected demand.

        Raises:
            RoutingError: if no engine qualifies (fail-closed).
        """
        with self._lock:
            value = req.labels.get(self.ROUTE_KEY, "*")
            self._arrivals[value] = self._arrivals.get(value, 0) + 1
            self._length_seq += 1
            self._label_lengths.setdefault(value, {})[len(req.prompt)] = \
                self._length_seq
            try:
                name = self.route(req)
            except RoutingError:
                rec = obs_events.RECORDER
                if rec is not None:
                    rec.emit("request.reject", rid=req.rid,
                             label="" if value == "*" else value)
                raise
            self._entries[name].engine.submit(req)
            return name

    def arrivals(self) -> Dict[str, int]:
        """Cumulative per-label submission counts (``"*"`` = unlabeled),
        including fail-closed rejections. The `LoadTracker` differences
        these to form arrival rates."""
        with self._lock:
            return dict(self._arrivals)

    def label_prompt_lengths(self, value: str,
                             cap: int = ServingEngine.MAX_AOT_PREFILL
                             ) -> List[int]:
        """Most recently seen distinct prompt lengths for a label (at most
        ``cap``), for warming a spawned engine at live shapes."""
        with self._lock:
            seen = dict(self._label_lengths.get(value, {}))
        recent = sorted(seen, key=seen.get)[-cap:]
        return sorted(recent)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def step(self) -> int:
        """One decode step across all running engines (draining engines
        keep stepping — they must serve out their queues). Returns the
        number of active engine-steps; reaps any engine that finished
        draining.

        A step is the SAFE BOUNDARY of the concurrent-PREPARE state
        machine: any pending swap whose background warm-up has finished
        (ticket READY) is committed here, before the engines step. It is
        also the handoff boundary of disaggregated serving: after the
        engines step, every request resident on a ``role="prefill"``
        engine (all are past their first token — prefill emits it at
        admission) is handed to a decode-role engine through the batched
        migration path (`_handoff_ready`)."""
        self._commit_ready()
        n = 0
        with self._step_lock:     # a commit never lands mid-decode
            for e in list(self._entries.values()):
                if not e.engine.paused:
                    n += e.engine.step()
        self._handoff_ready()
        with self._lock:
            self._reap_drained()
        return n

    def handoff_ready(self) -> List[MigrationRecord]:
        """Public handoff hook: move every handoff-eligible request from
        prefill-role engines onto decode-role engines now (``step()``
        already does this each step — call directly only when driving
        engines without the cluster step loop). Returns the per-request
        `MigrationRecord`s (``reason="handoff"``)."""
        return self._handoff_ready()

    def _handoff_ready(self) -> List[MigrationRecord]:
        """First-token handoff sweep (disaggregated serving): collect
        decoding residents of every ``role="prefill"`` engine — each
        already holds its first token, stamped by prefill at admission —
        pick the least-loaded eligible ``role="decode"`` destination per
        request, and move each (src, dst) cohort with ONE batched
        migration (`migrate_many` semantics via `_migrate_locked`, so
        the pre-warmed pool surgery keeps first use out of the pause and
        streams stay bitwise identical).

        Never lossy, never truncating: a request no decode engine can
        legally hold (route constraints, lanes, KV memory, or a
        sequence extent beyond the destination's ``s_max``) simply
        stays and finishes decoding on the prefill engine — fail-closed
        placement beats a truncated stream. Draining prefill engines
        still hand off (it accelerates their drain)."""
        with self._lock:
            sources = [e for e in self._entries.values()
                       if e.engine.role == "prefill"
                       and any(r is not None for r in e.engine.slot_req)]
            if not sources:
                return []
            decodes = [e for e in self._entries.values()
                       if e.engine.role == "decode"
                       and not e.draining and not e.quarantined
                       and not e.engine.paused]
            if not decodes:
                return []
            # capacity bookkeeping mirrors `_relocate_for_retirement`:
            # lanes AND token-granular memory per destination, debited
            # as requests are assigned (imports may spend the paged
            # watermark, so budget the full free page list)
            free = {e.name: e.engine.free_slots for e in decodes}
            free_tok = {e.name: (e.engine.pool.free_pages
                                 * e.engine.page_size
                                 if e.engine.paged else e.engine.free_tokens)
                        for e in decodes}
            extra = {e.name: 0 for e in decodes}
            cohorts: Dict[Tuple[str, str], List[int]] = {}
            for se in sources:
                eng = se.engine
                for i, req in enumerate(eng.slot_req):
                    if req is None:
                        continue
                    pos = int(eng.slot_pos[i])
                    need = needed_capacity(req, "decoding", pos, eng.s_max)
                    required = self.required_for(dict(req.labels))
                    cands = [e for e in decodes
                             if self._entry_eligible(e, req.labels,
                                                     required)
                             and need <= e.engine.s_max
                             and free[e.name] > 0
                             and free_tok[e.name]
                             >= e.engine.admission_tokens(need)]
                    if not cands:
                        continue           # decodes in place, fail-closed
                    dst = min(cands,
                              key=lambda e: e.engine.load + extra[e.name])
                    cohorts.setdefault((se.name, dst.name),
                                       []).append(req.rid)
                    extra[dst.name] += 1
                    free[dst.name] -= 1
                    free_tok[dst.name] -= dst.engine.admission_tokens(need)
            records: List[MigrationRecord] = []
            for (src, dst), rids in cohorts.items():
                try:
                    records.extend(self._migrate_locked(src, dst, rids,
                                                        reason="handoff"))
                except (MigrationError, RoutingError):
                    continue       # kept/restored on the prefill engine
            if records:
                rec = obs_events.RECORDER
                if rec is not None:
                    rec.emit("cluster.handoff", moved=len(records),
                             pause_max_s=max(m.pause_s for m in records),
                             bytes_moved=sum(m.bytes_moved
                                             for m in records))
            return records

    def run(self, max_steps: int = 10_000, *,
            wait_pending: bool = False) -> None:
        """Serve until every *running* engine's queue and slots are empty.

        Work queued on a paused engine stays queued (nothing is dropped)
        and is served by the `run()` after that engine's `resume()`.
        Draining engines are stepped until empty, then reaped. Pending
        `DowntimeReport`s are re-finalized with the post-swap window.

        Args:
            max_steps: decode-step budget (idle waiting does not count).
            wait_pending: also wait for in-flight background PREPAREs —
                the loop keeps serving while the worker warms and only
                returns once every pending ticket reached a terminal
                state (its swap committed at a step boundary)."""
        steps = 0
        while steps < max_steps:
            with self._lock:   # registry may be mutated by a commit
                entries = list(self._entries.values())
            busy = any(
                e.engine.queue or any(r is not None
                                      for r in e.engine.slot_req)
                for e in entries if not e.engine.paused)
            if busy:
                self.step()                # commits READY swaps itself
                steps += 1
            elif wait_pending and self.prepare_pending():
                time.sleep(0.001)          # idle but a warm-up is in flight
                self._commit_ready()
            else:
                break
        with self._lock:
            self._reap_drained()
            self._refresh_reports()

    def metrics(self, name: Optional[str] = None) -> Dict[str, float]:
        """TTFT/TPOT summary (full `METRIC_KEYS` set, NaN when undefined).

        Args:
            name: a specific engine's metrics; with ``None``, the
                cluster-wide aggregate over every registered engine —
                including engines registered after traffic started — plus
                the retained completions of retired engines.

        Raises:
            KeyError: if ``name`` is given but not registered.
        """
        if name is not None:
            return self._entries[name].engine.metrics()
        with self._lock:
            done: List[Request] = list(self._retired_done)
            for e in self._entries.values():
                done.extend(e.engine.done)
        return compute_metrics(done)

    def _known_labels(self, extra: Sequence[str] = ()) -> set:
        with self._lock:
            vals = set(extra) | set(self._routes) | set(self._arrivals)
            for sel, _ in self._selector_routes:
                if not callable(sel):
                    v = dict(sel).get(self.ROUTE_KEY)
                    if v:
                        vals.add(v)
            for e in self._entries.values():
                v = e.labels.get(self.ROUTE_KEY)
                if v:
                    vals.add(v)
            return vals

    def _fold_completions_locked(self) -> None:
        """Fold each engine's not-yet-consumed completions (the
        ``done[metrics_seen:]`` suffix) into the per-label incremental
        aggregates. Called under ``self._lock``."""
        for e in self._entries.values():
            done = e.engine.done
            if e.metrics_seen >= len(done):
                continue
            role = e.engine.role
            for r in done[e.metrics_seen:]:
                v = r.labels.get(self.ROUTE_KEY, "*")
                agg = self._label_folds.get(v)
                if agg is None:
                    agg = self._label_folds[v] = RequestAggregate()
                agg.observe(r.ttft, r.tpot)
                # disaggregated serving: completions on role-tagged
                # engines additionally aggregate under a "role:<role>"
                # pseudo-label so `metrics_by_label` surfaces per-role
                # TTFT/TPOT (unified engines add no extra keys — the
                # legacy label universe is unchanged)
                if role != "unified":
                    rv = f"role:{role}"
                    ragg = self._label_folds.get(rv)
                    if ragg is None:
                        ragg = self._label_folds[rv] = RequestAggregate()
                    ragg.observe(r.ttft, r.tpot)
            e.metrics_seen = len(done)

    def metrics_by_label(self, extra_labels: Sequence[str] = ()
                         ) -> Dict[str, Dict[str, float]]:
        """Per-label TTFT/TPOT aggregation over live + retired completions.

        Every known label (route constraints, engine labels, observed
        arrivals, plus ``extra_labels``) is present in the result —
        zero-filled (``completed=0``, NaN stats) when it has no traffic —
        so the `LoadTracker` can index unconditionally. Unlabeled traffic
        aggregates under ``"*"``.

        Incremental: each completion is folded into a per-label
        `repro_torch.obs.metrics.RequestAggregate` exactly once, so a call
        costs O(completions since the previous call), not O(every
        completion ever) — means are exact, p99 comes from the log-
        bucketed sketch (~5% relative error vs the old full rescan).
        """
        with self._lock:
            self._fold_completions_locked()
            labels = self._known_labels(extra_labels) | set(self._label_folds)
            out = {v: (self._label_folds[v].metrics()
                       if v in self._label_folds else compute_metrics([]))
                   for v in labels}
        # recorder ring health rides along under a pseudo-label (same
        # pattern as the "role:<role>" keys): silent event/span drops
        # would corrupt attribution and the SLO ledger, so they must be
        # visible wherever per-label metrics are consumed
        rec = obs_events.RECORDER
        if rec is not None:
            out[self.OBS_LABEL] = dict(
                compute_metrics([]),
                events_emitted=float(rec.bus.emitted),
                events_dropped=float(rec.bus.dropped),
                spans_added=float(rec.trace.added),
                spans_dropped=float(rec.trace.dropped))
        return out

    def drain_completed(self) -> List[Request]:
        """Pop and return every retained completed request (live engines'
        done lists + the retired-engine retention buffer), in no
        particular order.

        The scale-replay harness consumes completions incrementally
        through this method: at 10^5+ requests the cumulative
        `metrics_by_label` scan is O(total completions) per call, while
        draining is O(completions since the last drain) and keeps
        resident memory bounded. After a drain, the cumulative
        ``metrics*`` views only see completions retired later — callers
        own the popped requests and any windowed aggregation over them
        (pending `DowntimeReport`s are unaffected: they auto-finalize
        with the empty window at commit time)."""
        with self._step_lock:      # same order as step(): step -> registry
            with self._lock:
                out: List[Request] = list(self._retired_done)
                self._retired_done.clear()
                for e in self._entries.values():
                    if e.engine.done:
                        out.extend(e.engine.done)
                        e.engine.done.clear()
                    e.metrics_seen = 0
                # drained completions leave the cumulative views entirely
                # (documented semantics) — the incremental folds restart
                self._label_folds.clear()
        return out

    def queue_depth_by_label(self, extra_labels: Sequence[str] = ()
                             ) -> Dict[str, int]:
        """Queued + resident request counts per label across all engines
        (zero-filled over the same label universe as `metrics_by_label`)."""
        out: Dict[str, int] = {v: 0 for v in self._known_labels(extra_labels)}
        with self._lock:
            for e in self._entries.values():
                live = list(e.engine.queue) + [r for r in e.engine.slot_req
                                               if r is not None]
                for r in live:
                    v = r.labels.get(self.ROUTE_KEY, "*")
                    out[v] = out.get(v, 0) + 1
        return out

    def queued_tokens_by_label(self, extra_labels: Sequence[str] = ()
                               ) -> Dict[str, int]:
        """Token-granular queue depth: outstanding KV tokens per label —
        a queued request demands its full clamped extent (prompt +
        generation budget, capped at the engine's ``s_max``), a resident
        one its remaining extent. Same zero-filled label universe as
        `queue_depth_by_label`; this is the demand signal a paged pool's
        admission actually meters (two short requests are half the load
        of one long one, which request counts cannot see)."""
        out: Dict[str, int] = {v: 0 for v in self._known_labels(extra_labels)}
        with self._lock:
            for e in self._entries.values():
                s_max = e.engine.s_max
                for r in e.engine.queue:
                    v = r.labels.get(self.ROUTE_KEY, "*")
                    out[v] = out.get(v, 0) + min(
                        len(r.prompt) + r.max_new_tokens, s_max)
                for i, r in enumerate(e.engine.slot_req):
                    if r is None:
                        continue
                    v = r.labels.get(self.ROUTE_KEY, "*")
                    need = min(len(r.prompt) + r.max_new_tokens, s_max)
                    out[v] = out.get(v, 0) + max(
                        need - int(e.engine.slot_pos[i]), 0)
        return out

    def kv_utilization(self) -> Dict[str, float]:
        """Per-engine KV utilization (used / allocated tokens) plus the
        allocation-weighted cluster aggregate under ``"*"`` — the
        slot-padding-waste signal (a slot-granular engine full of short
        requests reads low; a paged engine's right-sized reservations
        read high). Engines with nothing resident report 0.0 and weigh
        nothing in the aggregate.

        Only ROUTABLE capacity is reported: draining (retired-but-
        unreaped) and quarantined engines are excluded from the map and
        the aggregate — their residual allocations are not capacity the
        a scaler can rebalance onto, and a stale entry here would
        poison the rebalance-over-spawn decision."""
        with self._lock:
            entries = [e for e in self._entries.values()
                       if not e.draining and not e.quarantined]
        out: Dict[str, float] = {}
        used = alloc = 0
        for e in entries:
            out[e.name] = e.engine.kv_utilization
            used += e.engine.kv_used_tokens
            alloc += e.engine.kv_allocated_tokens
        out["*"] = used / alloc if alloc else 0.0
        return out

    # ------------------------------------------------------------------
    # online reconfiguration (prepare-ahead + blocking swap)
    #
    # One pending-swap state machine serves every caller: the sync paths
    # (`reconfigure`, `spawn_engine`, `rebalance`, `apply_policy`) stage
    # a ticket, run PREPARE inline and commit immediately; the async
    # paths (`reconfigure_async`, `spawn_engine_async`) hand PREPARE to
    # the `PrepareWorker` and the swap commits at the next safe step
    # boundary (`step()` / `run()` / `commit_ready()`).
    # ------------------------------------------------------------------
    def _worker(self) -> PrepareWorker:
        if self._prepare_worker is None:
            self._prepare_worker = default_worker()
        return self._prepare_worker

    def _prepare_closure(self, engine: ServingEngine, plan: ShardingPlan,
                         lengths: Sequence[int], prefill_buckets: bool,
                         placement: Optional[Dict[str, Any]] = None,
                         warm: Optional[Any] = None):
        """THE PREPARE body (one copy for reconfigure and spawn): run the
        optional extra warmer, place the plan on the mesh, warm prefill and
        decode — returns the payload dict `_commit_ticket` installs."""
        def _prepare() -> Dict[str, Any]:
            if warm is not None:
                warm()
            pl = placement if placement is not None \
                else plan_to_placement(plan, self.mesh)
            executables, n_compiled = engine.prepare_executables(
                pl, prefill_lengths=lengths, prefill_buckets=prefill_buckets)
            return {"placement": pl, "executables": executables,
                    "n_compiled": n_compiled}
        return _prepare

    def _stage_reconfigure(self, name: str, plan: ShardingPlan, *,
                           placement: Optional[Dict[str, Any]],
                           prefill_lengths: Sequence[int],
                           prefill_buckets: bool,
                           inline: bool,
                           warm: Optional[Any] = None) -> PrepareTicket:
        """Create the pending-swap ticket for an engine (superseding any
        older pending ticket) and start its PREPARE."""
        with self._lock:
            entry = self._entries[name]
            if entry.draining:
                raise ValueError(f"engine {name!r} is draining — a "
                                 "retiring engine cannot be reconfigured")
            eng = entry.engine
            # snapshot on THIS thread: the worker must never iterate the
            # live seen-lengths dict while request threads mutate it
            lengths = tuple(prefill_lengths) or eng.recent_prompt_lengths()
            ticket = PrepareTicket(name, "reconfigure", plan)
            if entry.pending_ticket is not None:
                # a newer plan supersedes the old pending swap — its
                # executables (finished or not) are never installed
                entry.pending_ticket.cancel(superseded_by=ticket)
            entry.pending_ticket = ticket
            self._prepare_dirty = True
        prepare = self._prepare_closure(eng, plan, lengths, prefill_buckets,
                                        placement=placement, warm=warm)
        if inline:
            PrepareWorker.run_inline(ticket, prepare)
        else:
            self._worker().submit(ticket, prepare)
        return ticket

    def reconfigure_async(self, name: str, plan: ShardingPlan, *,
                          placement: Optional[Dict[str, Any]] = None,
                          prefill_lengths: Sequence[int] = (),
                          prefill_buckets: bool = False,
                          warm: Optional[Any] = None,
                          ) -> PrepareTicket:
        """Swap a live engine onto ``plan`` WITHOUT blocking the caller:
        PREPARE runs on the background `PrepareWorker` while serving
        continues, and the blocking SWAP commits at the next safe step
        boundary after the warm-up finishes.

        If the engine already has a pending (uncommitted) swap, the older
        ticket is CANCELLED — superseded by this one — and its payload is
        never installed.

        Args: as `reconfigure`, plus:
            warm: optional zero-arg callable the worker runs BEFORE the
                engine's own warm-up.

        Returns:
            The `PrepareTicket`; poll ``ticket.done()`` while stepping
            (or ``cluster.run(wait_pending=True)``), then
            ``ticket.result()`` for the `DowntimeReport`.

        Raises:
            KeyError: if ``name`` is not registered.
            ValueError: if the engine is draining toward retirement.
        """
        return self._stage_reconfigure(
            name, plan, placement=placement,
            prefill_lengths=prefill_lengths,
            prefill_buckets=prefill_buckets, inline=False, warm=warm)

    def reconfigure(self, name: str, plan: ShardingPlan, *,
                    placement: Optional[Dict[str, Any]] = None,
                    prefill_lengths: Sequence[int] = (),
                    prefill_buckets: bool = False,
                    ) -> DowntimeReport:
        """Swap a live engine onto ``plan`` (PREPARE / SWAP / RESUME),
        blocking until the swap committed (the async path is
        `reconfigure_async`; both run the same state machine).

        Args:
            name: the engine to reconfigure.
            plan: the target `ShardingPlan`.
            placement: a ready placement; derived from the plan via
                `plan_to_placement` when omitted.
            prefill_lengths: prompt lengths to warm; defaults to the
                engine's recently seen lengths.
            prefill_buckets: also warm the padded-bucket prefill ladder,
                which the swap installs, so prompt lengths never seen
                before are padded to a warmed bucket (see
                `ServingEngine.prepare_executables`).

        Returns:
            The (auto-finalizing) `DowntimeReport` for this swap.

        Raises:
            KeyError: if ``name`` is not registered.
            ValueError: if the engine is draining toward retirement — a
                retiring engine never pays a swap window — or the
                post-swap collective verification failed (the engine
                is quarantined, fail-closed).
            PrepareCancelled: a concurrent caller superseded this swap
                (issued a newer plan) or retired the engine before the
                commit — nothing was installed.
        """
        ticket = self._stage_reconfigure(
            name, plan, placement=placement,
            prefill_lengths=prefill_lengths,
            prefill_buckets=prefill_buckets, inline=True)
        if ticket.state == FAILED:         # PREPARE raised: propagate as-is
            with self._lock:
                entry = self._entries.get(name)
                if entry is not None and entry.pending_ticket is ticket:
                    entry.pending_ticket = None
            raise ticket.error
        report = self._commit_ticket(ticket)
        if report is None:
            # superseded/cancelled (result() raises PrepareCancelled), or
            # a concurrently stepping thread won the commit race — then
            # result() returns that thread's report, re-raising any
            # post-swap verification failure it recorded (fail-closed,
            # same contract as the direct-commit path above)
            report = ticket.result()
        return report

    def _commit_ticket(self, ticket: PrepareTicket
                       ) -> Optional[DowntimeReport]:
        """Commit one READY ticket's blocking swap; returns None when the
        ticket is not READY (or its target vanished, abandoning it).

        Raises:
            ValueError: the post-swap collective verification failed —
                the swap WAS paid and its report recorded, but the engine
                is quarantined (fail-closed routing). For a spawn the
                engine is rolled back out of the pool instead and the
                ticket marked FAILED.
        """
        payload = ticket._take_for_commit()
        if payload is None:
            return None
        if ticket.kind == "spawn":
            return self._commit_spawn(ticket, payload)
        with self._lock:
            entry = self._entries.get(ticket.engine)
            if (entry is None or entry.draining
                    or entry.pending_ticket is not ticket):
                ticket._abandon()          # retired/superseded meanwhile
                return None
            eng = entry.engine
            # a still-pending previous report gets its honest final window
            # now (possibly empty) rather than being silently dropped
            self._finalize_pending(entry)
            # window since the previous swap (everything, on the first),
            # so repeated reconfigurations compare like-for-like windows
            metrics_before = compute_metrics(
                [r for r in eng.done if r.t_done >= entry.swap_t])

            # ---- SWAP (blocking window — no warm-up here) ----
            entry.swapping = True
            t0 = time.time()
            try:
                with self._step_lock:   # never lands mid-decode-step
                    eng.pause()
                    try:
                        eng.drain()
                        migrate_bytes = eng.swap_plan(
                            ticket.plan, placement=payload["placement"],
                            executables=payload["executables"])
                    finally:
                        # a failed swap must never strand the engine
                        # paused — traffic routed to it would otherwise
                        # sit queued forever
                        eng.resume()
            except BaseException as err:
                # a failed install must never wedge the state machine:
                # the ticket fails (result() re-raises this), the engine
                # keeps serving under its old plan/executables
                entry.pending_ticket = None
                ticket._commit_failed(err)
                raise
            finally:
                entry.swapping = False
            downtime_s = time.time() - t0
            rec = obs_events.RECORDER
            if rec is not None:
                # recorded under the SAME cluster lock as routing: a
                # swap-commit span can never interleave a route span
                rec.span_at("swap.commit", t0, downtime_s,
                            track=ticket.engine, cat="reconfig",
                            engine=ticket.engine)
                rec.emit("cluster.swap", engine=ticket.engine,
                         downtime_s=downtime_s, prepare_s=ticket.prepare_s,
                         compiled_in_prepare=payload["n_compiled"])

            # ---- RESUME + auto-finalized report ----
            report = DowntimeReport(
                prepare_s=ticket.prepare_s, downtime_s=downtime_s,
                migrate_bytes=migrate_bytes,
                metrics_before=metrics_before,
                # auto-finalized to the empty post-swap window (full key
                # set); _refresh_reports swaps in real post-swap traffic
                metrics_after=compute_metrics([]),
                engine=ticket.engine, compiled_in_prepare=payload["n_compiled"])
            entry.pending_report = report
            entry.swap_t = time.time()
            entry.pending_ticket = None
            self.history.append(report)

            # the freshly installed executable must prove whatever route
            # constraints the new plan claims (clears a quarantine on
            # pass; quarantines on failure — fail-closed, the plan stays
            # installed but the router skips the engine). The report is
            # recorded either way: the blocking window was really paid.
            # Verified BEFORE the ticket wakes its waiters, so a racing
            # caller can never observe SWAPPED with the error still unset.
            verify_error: Optional[ValueError] = None
            try:
                self.verify_engine_collectives(ticket.engine)
                entry.quarantined = False
            except ValueError as err:
                entry.quarantined = True
                ticket.error = err
                verify_error = err
            ticket._committed(report)
            if verify_error is not None:
                raise verify_error
            return report

    def _commit_ready(self) -> List[DowntimeReport]:
        """Commit every READY pending swap (the safe-step-boundary hook
        `step()`/`run()` call). Terminal leftovers (cancelled/failed
        tickets) are unlinked. Verification failures quarantine the
        engine and are recorded on the ticket, never raised here — the
        serving loop must keep turning."""
        if not self._prepare_dirty:        # pure-sync serving: free
            return []
        out: List[DowntimeReport] = []
        with self._lock:
            pending = [(e, e.pending_ticket)
                       for e in list(self._entries.values())
                       if e.pending_ticket is not None]
            spawns = list(self._pending_spawns.items())
            if not pending and not spawns:
                self._prepare_dirty = False
                return []
        for entry, t in pending:
            if t.state in (CANCELLED, FAILED):
                with self._lock:
                    if entry.pending_ticket is t:
                        entry.pending_ticket = None
            elif t.state == READY:
                try:
                    report = self._commit_ticket(t)
                except Exception:
                    # recorded on the ticket: either FAILED (install
                    # error — report stays None) or SWAPPED + quarantined
                    # (verify failure after a really-paid window)
                    report = t.report
                if report is not None:
                    out.append(report)
        for name, t in spawns:
            if t.state in (CANCELLED, FAILED):
                with self._lock:
                    if self._pending_spawns.get(name) is t:
                        del self._pending_spawns[name]
            elif t.state == READY:
                try:
                    report = self._commit_ticket(t)
                except Exception:
                    report = None          # rolled back; ticket FAILED
                if report is not None:
                    out.append(report)
        return out

    def commit_ready(self) -> List[DowntimeReport]:
        """Public step-boundary hook: commit every pending swap whose
        background PREPARE has finished. Returns the committed reports
        (usually empty — `step()`/`run()` already call this)."""
        return self._commit_ready()

    def prepare_pending(self) -> List[PrepareTicket]:
        """Tickets still in flight (PREPARING or READY-but-uncommitted),
        reconfigures and spawns alike. Empty == nothing pending."""
        with self._lock:
            out = [e.pending_ticket for e in self._entries.values()
                   if e.pending_ticket is not None
                   and not e.pending_ticket.done()]
            out.extend(t for t in self._pending_spawns.values()
                       if not t.done())
            return out

    # ------------------------------------------------------------------
    # elastic lifecycle (spawn / retire / rebalance) — scaling hooks
    # ------------------------------------------------------------------
    def _stage_spawn(self, name: str, engine: ServingEngine, *,
                     plan: Optional[ShardingPlan],
                     labels: Optional[Dict[str, str]],
                     prefill_lengths: Sequence[int],
                     prefill_buckets: bool,
                     inline: bool,
                     warm: Optional[Any] = None,
                     role: Optional[str] = None) -> PrepareTicket:
        with self._lock:
            self._drop_dead_spawns()
            if name in self._entries or name in self._pending_spawns:
                raise ValueError(f"engine {name!r} already registered")
            if plan is not None:
                engine.plan = plan
            if labels:
                engine.labels.update(labels)
            if role is not None:
                engine.role = role         # validates fail-closed
            ticket = PrepareTicket(name, "spawn", engine.plan,
                                   engine_obj=engine)
            self._pending_spawns[name] = ticket
            self._prepare_dirty = True
        prepare = self._prepare_closure(engine, engine.plan,
                                        tuple(prefill_lengths),
                                        prefill_buckets, warm=warm)
        if inline:
            PrepareWorker.run_inline(ticket, prepare)
        else:
            self._worker().submit(ticket, prepare)
        return ticket

    def _commit_spawn(self, ticket: PrepareTicket,
                      payload: Dict[str, Any]) -> Optional[DowntimeReport]:
        """Install a READY spawn and join it to the routing pool."""
        with self._lock:
            name = ticket.engine
            if self._pending_spawns.get(name) is not ticket \
                    or name in self._entries:
                ticket._abandon()          # cancelled/replaced meanwhile
                return None
            engine: ServingEngine = ticket._engine_obj

            # ---- install + join the routing pool ----
            # under the step lock: joining the pool redistributes queued
            # work across live engines, which must not interleave with a
            # decode step admitting from those same queues
            t0 = time.time()
            with self._step_lock:
                engine.pause()
                try:
                    migrate_bytes = engine.swap_plan(
                        engine.plan, placement=payload["placement"],
                        executables=payload["executables"])
                except BaseException as err:
                    # never wedge the state machine on a failed install:
                    # the spawn fails (result() re-raises), nothing
                    # joined the pool
                    del self._pending_spawns[name]
                    ticket._commit_failed(err)
                    raise
                finally:
                    engine.resume()
                engine.obs_name = name
                entry = _EngineEntry(name, engine)
                self._entries[name] = entry
                try:
                    # the traced decode step must prove the route
                    # constraints its plan claims
                    self.verify_engine_collectives(name)
                except ValueError as err:
                    del self._entries[name]
                    del self._pending_spawns[name]
                    ticket._commit_failed(err)
                    raise
                downtime_s = time.time() - t0
                rec = obs_events.RECORDER
                if rec is not None:
                    rec.span_at("spawn.commit", t0, downtime_s,
                                track=name, cat="reconfig", engine=name)
                    rec.emit("cluster.spawn", engine=name,
                             downtime_s=downtime_s,
                             prepare_s=ticket.prepare_s,
                             compiled_in_prepare=payload["n_compiled"])

                report = DowntimeReport(
                    prepare_s=ticket.prepare_s, downtime_s=downtime_s,
                    migrate_bytes=migrate_bytes,
                    metrics_before=compute_metrics([]),
                    metrics_after=compute_metrics([]),
                    engine=name, compiled_in_prepare=payload["n_compiled"],
                    event="spawn")
                entry.pending_report = report
                entry.swap_t = time.time()
                del self._pending_spawns[name]
                self.history.append(report)
                ticket._committed(report)
                # disaggregated roles: warm the pool-surgery ops now
                # (AFTER swap_plan, which invalidates the warm flag),
                # outside the measured downtime, so the engine's first
                # handoff pays no first use
                if engine.role != "unified":
                    engine.warm_migration()
                # new capacity takes its share of the backlog at once
                if engine.labels.get(self.ROUTE_KEY):
                    self.redistribute_queued(engine.labels[self.ROUTE_KEY])
                else:
                    for value in self._known_labels():
                        self.redistribute_queued(value)
            return report

    def spawn_engine_async(self, name: str, engine: ServingEngine, *,
                           plan: Optional[ShardingPlan] = None,
                           labels: Optional[Dict[str, str]] = None,
                           prefill_lengths: Sequence[int] = (),
                           prefill_buckets: bool = False,
                           warm: Optional[Any] = None,
                           role: Optional[str] = None,
                           ) -> PrepareTicket:
        """Bring a NEW engine online WITHOUT blocking the caller: its
        PREPARE warm-up runs on the background `PrepareWorker` and the
        engine joins the routing pool at the next safe step boundary after
        the warm-up finishes. Until then the engine is invisible to
        routing; the reserved name is listed by `pending_spawns`.

        Args: as `spawn_engine`; ``warm`` as in `reconfigure_async`;
        ``role`` as in `register`.

        Returns:
            The `PrepareTicket` (``kind="spawn"``); ``ticket.result()``
            is the spawn's `DowntimeReport` once committed.

        Raises:
            ValueError: ``name`` is registered or already pending.
        """
        return self._stage_spawn(
            name, engine, plan=plan, labels=labels,
            prefill_lengths=prefill_lengths,
            prefill_buckets=prefill_buckets, inline=False, warm=warm,
            role=role)

    def spawn_engine(self, name: str, engine: ServingEngine, *,
                     plan: Optional[ShardingPlan] = None,
                     labels: Optional[Dict[str, str]] = None,
                     prefill_lengths: Sequence[int] = (),
                     prefill_buckets: bool = False,
                     role: Optional[str] = None,
                     ) -> DowntimeReport:
        """Bring a NEW engine online through the PREPARE path.

        The engine's params/cache are placed by its plan and its prefill
        and decode are warmed BEFORE it joins the routing pool. Existing
        engines keep serving throughout; the
        report's ``downtime_s`` only covers the spawn's own install window.
        (`spawn_engine_async` is the non-blocking variant; both run the
        same pending-swap state machine.)

        Args:
            name: unique engine name.
            engine: a freshly built `ServingEngine`.
            plan: installed as the engine's plan before materialization.
            labels: merged into the engine's labels (e.g. dedicate it to
                one ``data-type``).
            prefill_lengths: prompt lengths to warm (typically
                `label_prompt_lengths` of the label being scaled).
            prefill_buckets: also warm and install the padded-bucket
                prefill ladder.
            role: if given, installed as ``engine.role`` before the
                engine joins the pool (see `register` — a non-unified
                engine joins with its handoff migration ops pre-warmed).

        Returns:
            A `DowntimeReport` with ``event="spawn"`` (``metrics_before``
            is the empty window; ``metrics_after`` finalizes once the
            engine serves traffic).

        Raises:
            ValueError: if ``name`` is already registered, or (fail-closed)
                the traced decode step's collectives violate an applicable
                route constraint (`verify_engine_collectives` — the spawn is
                rolled back).
        """
        ticket = self._stage_spawn(
            name, engine, plan=plan, labels=labels,
            prefill_lengths=prefill_lengths,
            prefill_buckets=prefill_buckets, inline=True, role=role)
        if ticket.state == FAILED:         # PREPARE raised: propagate as-is
            with self._lock:
                if self._pending_spawns.get(name) is ticket:
                    del self._pending_spawns[name]
            raise ticket.error
        report = self._commit_ticket(ticket)
        if report is None:                 # cancelled before our commit
            return ticket.result()         # raises PrepareCancelled
        return report

    def _drop_dead_spawns(self) -> None:
        """Unlink CANCELLED/FAILED spawn reservations (requires _lock):
        a failed spawn must not squat on its name until the next step
        boundary happens to sweep it."""
        for n, t in list(self._pending_spawns.items()):
            if t.state in (CANCELLED, FAILED):
                del self._pending_spawns[n]

    def pending_spawns(self) -> List[str]:
        """Names reserved by in-flight `spawn_engine_async` tickets (the
        engines are NOT yet in the routing pool)."""
        with self._lock:
            self._drop_dead_spawns()
            return list(self._pending_spawns)

    def pending_spawn_labels(self) -> Dict[str, int]:
        """In-flight spawn capacity per ``data-type`` label: how many
        `spawn_engine_async` tickets are still warming toward each
        label (unlabeled spawns count under ``"*"``). Capacity that is
        already being built — a ticket-aware scaler counts it as
        existing so bursty load cannot
        trigger duplicate spawns beyond the suppression window."""
        with self._lock:
            self._drop_dead_spawns()
            out: Dict[str, int] = {}
            for t in self._pending_spawns.values():
                if t.done():
                    continue
                labels = getattr(t._engine_obj, "labels", {}) or {}
                v = labels.get(self.ROUTE_KEY, "*")
                out[v] = out.get(v, 0) + 1
            return out

    def pending_spawn_roles(self) -> Dict[str, Dict[str, int]]:
        """In-flight spawn capacity per label, split by engine role:
        ``{label: {role: count}}`` over `spawn_engine_async` tickets
        still warming. A role-aware scaler counts a pending prefill
        spawn as existing prefill capacity (and so on), so a slow
        warm-up cannot trigger duplicate role spawns."""
        with self._lock:
            self._drop_dead_spawns()
            out: Dict[str, Dict[str, int]] = {}
            for t in self._pending_spawns.values():
                if t.done():
                    continue
                eng = t._engine_obj
                labels = getattr(eng, "labels", {}) or {}
                v = labels.get(self.ROUTE_KEY, "*")
                role = getattr(eng, "role", "unified")
                by_role = out.setdefault(v, {})
                by_role[role] = by_role.get(role, 0) + 1
            return out

    def migrate_requests(self, src: str, dst: str,
                         rids: Optional[Sequence[int]] = None, *,
                         reason: str = ""
                         ) -> List[MigrationRecord]:
        """Live-migrate in-flight requests from ``src`` to ``dst``:
        export each request's per-slot state (KV slices, decode position,
        generated tokens, metric stamps), refit it onto the
        destination pool's layout, and resume decode there — no
        re-run of prefill, token streams bitwise
        identical to an unmigrated run.

        Fail-closed, and ATOMIC with respect to validation: every request
        is pre-flighted — destination eligibility (the same predicate the
        router uses: tenancy labels + route-constraint `plan_satisfies`),
        pool capacity, and free decode slots — BEFORE any state moves, so
        a rejected batch leaves the cluster exactly as it was. A transfer
        failure mid-batch (exceptional after pre-flight) restores that
        request to ``src``; earlier requests of the batch remain moved.

        Args:
            src: source engine (may be draining — that is the retire
                fast path).
            dst: destination engine (must not be draining).
            rids: requests to move; every resident + queued request on
                ``src`` when omitted. An explicitly empty batch is a
                no-op: no pause span, no downtime, no engine touched.
            reason: stamped on each `MigrationRecord` and its
                ``migration.pause`` event (``"handoff"`` for the
                first-token prefill→decode handoff — the SLO ledger
                buckets pause time by it).

        Returns:
            One `MigrationRecord` per moved request (pause measured
            export→import).

        Raises:
            KeyError: unknown engine or ``rids`` entry not on ``src``
                (nothing moved).
            ValueError: ``src == dst``, ``dst`` is draining, or ``rids``
                contains duplicates (nothing moved).
            RoutingError: ``dst`` is not eligible for a request's labels
                (fail-closed; nothing moved).
            MigrationError: ``dst`` cannot hold the batch — a request's
                sequence capacity or the free-slot count (nothing moved);
                or a transfer failed mid-batch (that request restored).
        """
        if src == dst:
            raise ValueError("source and destination are the same engine")
        with self._lock:
            return self._migrate_locked(src, dst, rids, reason=reason)

    def _migrate_locked(self, src: str, dst: str,
                        rids: Optional[Sequence[int]], *,
                        reason: str = ""
                        ) -> List[MigrationRecord]:
        se, de = self._entries[src], self._entries[dst]
        if de.draining:
            raise ValueError(f"destination {dst!r} is draining — a "
                             "retiring engine cannot receive migrations")
        if rids is None:
            rids = [r.rid for r in se.engine.slot_req if r is not None] \
                + [r.rid for r in se.engine.queue]
        if not rids:
            # empty cohort (nothing in flight, or every candidate was
            # filtered upstream): a migration that moves nothing must
            # cost nothing — no warm-up, no drain barrier, no pause
            # span, downtime identically 0
            return []
        if len(set(rids)) != len(rids):
            raise ValueError(f"duplicate rids in migration batch: {rids}")
        # ---- pre-flight: validate the WHOLE batch before moving anything
        resident = {r.rid: i for i, r in enumerate(se.engine.slot_req)
                    if r is not None}
        queued = {r.rid: r for r in se.engine.queue}
        decode_needs: List[int] = []   # per decoding request, in tokens
        for rid in rids:
            if rid in resident:
                slot = resident[rid]
                req = se.engine.slot_req[slot]
                phase, pos = "decoding", int(se.engine.slot_pos[slot])
            elif rid in queued:
                req, phase = queued[rid], "queued"
                pos = len(req.prompt)
            else:
                raise KeyError(f"request {rid} is not on engine {src!r}")
            required = self.required_for(dict(req.labels))
            if not self._entry_eligible(de, req.labels, required):
                raise RoutingError(
                    f"engine {dst!r} may not serve request {rid} "
                    f"(labels={req.labels}, constraint={required!r}) — "
                    "failing closed, nothing moved")
            # role discipline: a decode-role engine cannot prefill, so a
            # queued (not-yet-prefilled) request may never land on one;
            # a decoding request on a prefill-role engine would only be
            # handed straight off again — both refused, nothing moved
            if phase == "queued" and de.engine.role == "decode":
                raise RoutingError(
                    f"request {rid} is still queued (needs prefill) but "
                    f"{dst!r} has role='decode' — failing closed, "
                    "nothing moved")
            if phase == "decoding" and de.engine.role == "prefill":
                raise RoutingError(
                    f"request {rid} is decoding but {dst!r} has "
                    "role='prefill' (it would be handed off again) — "
                    "failing closed, nothing moved")
            need = needed_capacity(req, phase, pos, se.engine.s_max)
            if need > de.engine.s_max:
                raise MigrationError(
                    f"request {rid} needs sequence capacity {need} but "
                    f"{dst!r} has s_max={de.engine.s_max} — failing "
                    "closed, nothing moved")
            if phase == "decoding":
                decode_needs.append(need)
        # token-granular admission: lanes AND KV memory (a paged pool
        # counts the batch's page reservations; a slot pool only lanes)
        if not de.engine.fits_inflight(decode_needs):
            raise MigrationError(
                f"batch needs {len(decode_needs)} decode lanes / "
                f"{sum(decode_needs)} KV tokens but {dst!r} has "
                f"{de.engine.free_slots} lanes / {de.engine.free_tokens} "
                "tokens free — failing closed, nothing moved")
        # ---- transfer
        # under the step lock: KV surgery must never interleave with a
        # decode step writing the same pools from the serving thread
        with self._step_lock:
            # prepare-ahead: the pool-surgery ops must already be warm
            # when the per-request pause clock starts
            se.engine.warm_migration()
            de.engine.warm_migration()
            # device barrier: pending decode work on either side must
            # retire before export — waiting for it is drain cost
            # (counted by the caller's blocking window), not per-request
            # transfer cost
            se.engine.drain()
            de.engine.drain()
            # one batched transfer for the whole pair (per-request
            # pauses amortize the shared transfer; see migrate_many)
            return migrate_many(se.engine, de.engine, rids, src=src,
                                dst=dst, reason=reason)

    def _relocate_for_retirement(self, entry: _EngineEntry
                                 ) -> List[MigrationRecord]:
        """Move a retiring engine's in-flight work onto eligible peers,
        batched per destination (one warm + drain barrier per engine
        pair, not per request). A resident request resumes decode, so it
        needs a RUNNING peer with a free slot and enough sequence
        capacity — a paused one would strand it; a queued request only
        needs routing (running peers preferred, router parity). Requests
        no peer may legally hold (the route-constraint merge semantics of
        `merge_restrictions` keep conflicting placements unroutable) stay
        behind and drain — fail-closed beats mis-placement."""
        eng = entry.engine
        work = [(r, "decoding", int(eng.slot_pos[i]))
                for i, r in enumerate(eng.slot_req) if r is not None] \
            + [(r, "queued", len(r.prompt)) for r in eng.queue]
        free = {e.name: e.engine.free_slots for e in self._entries.values()}
        # token-granular capacity alongside lanes: a paged destination
        # admits by pages, so short requests pack in where whole slots
        # would not fit (imports may spend the watermark — mirror
        # `fits_inflight` by budgeting the full free page list)
        free_tok = {e.name: (e.engine.pool.free_pages * e.engine.page_size
                             if e.engine.paged else e.engine.free_tokens)
                    for e in self._entries.values()}
        extra = {e.name: 0 for e in self._entries.values()}
        assignments: Dict[str, List[int]] = {}
        for req, phase, pos in work:
            required = self.required_for(dict(req.labels))
            need = needed_capacity(req, phase, pos, eng.s_max)
            cands = [e for e in self._entries.values()
                     if e.name != entry.name
                     and self._entry_eligible(e, req.labels, required)
                     and need <= e.engine.s_max]
            if phase == "decoding":
                # role discipline mirrors `_migrate_locked`'s preflight:
                # a decoding request never relocates onto a prefill-role
                # engine (it would only be handed off again)
                cands = [e for e in cands
                         if e.engine.role != "prefill"
                         and not e.engine.paused and free[e.name] > 0
                         and free_tok[e.name]
                         >= e.engine.admission_tokens(need)]
            else:
                # a queued request still needs prefill — never a
                # decode-role destination
                cands = [e for e in cands if e.engine.role != "decode"]
                running = [e for e in cands if not e.engine.paused]
                cands = running or cands
            if not cands:
                continue                   # stays behind; drains in place
            dst = min(cands, key=lambda e: e.engine.load + extra[e.name])
            assignments.setdefault(dst.name, []).append(req.rid)
            extra[dst.name] += 1
            if phase == "decoding":
                free[dst.name] -= 1
                free_tok[dst.name] -= dst.engine.admission_tokens(need)
        records: List[MigrationRecord] = []
        for dst, rids in assignments.items():
            try:
                records.extend(self.migrate_requests(entry.name, dst,
                                                     rids=rids))
            except (MigrationError, RoutingError):
                continue                   # kept/restored on source; drains
        return records

    def retire_engine(self, name: str, mode: str = "drain"
                      ) -> DowntimeReport:
        """Begin retirement: the engine stops receiving new requests
        immediately (the router skips draining engines) and is
        deregistered once empty; its completions are retained for
        cluster-level metrics.

        Modes:
          * ``"drain"`` (default): the engine serves out its queue and
            resident slots first — retirement latency is bounded by the
            longest in-flight decode, but nothing ever blocks
            (``downtime_s`` is honestly 0).
          * ``"migrate"``: in-flight work is live-migrated to eligible
            peers (`migrate_requests` semantics — fail-closed on route
            constraints) and the engine is reaped IMMEDIATELY when
            everything moved. ``downtime_s`` reports the measured
            relocation window; per-request pauses are in
            ``report.migrations``. Requests no peer can legally hold
            stay behind and drain in place (the engine then retires the
            drain way for them).

        A paused engine is resumed so it can actually drain.

        Returns:
            A `DowntimeReport` with ``event="retire"``; ``metrics_after``
            finalizes at reap time with the drain-window traffic (empty if
            the engine was already idle).

        Raises:
            KeyError: if ``name`` is not registered.
            ValueError: if the engine is already draining, or ``mode`` is
                unknown.
        """
        if mode not in ("drain", "migrate"):
            raise ValueError(f"unknown retirement mode {mode!r} "
                             "(expected 'drain' or 'migrate')")
        with self._lock:
            return self._retire_locked(name, mode)

    def _retire_locked(self, name: str, mode: str) -> DowntimeReport:
        entry = self._entries[name]
        if entry.draining:
            raise ValueError(f"engine {name!r} is already draining")
        if entry.pending_ticket is not None:
            # a retiring engine never swaps: the pending background
            # PREPARE is cancelled and its executables never installed
            entry.pending_ticket.cancel()
            entry.pending_ticket = None
        if entry.engine.paused:
            entry.engine.resume()
        self._finalize_pending(entry)
        metrics_before = compute_metrics(
            [r for r in entry.engine.done if r.t_done >= entry.swap_t])
        entry.draining = True              # router skips it from here on
        downtime_s = 0.0
        records: List[MigrationRecord] = []
        if mode == "migrate":
            # PREPARE-equivalent: warm the pool-surgery ops on the source
            # and every peer that could actually receive one of its
            # in-flight requests, BEFORE the blocking window
            entry.engine.warm_migration()
            inflight = [r for r in entry.engine.slot_req
                        if r is not None] + list(entry.engine.queue)
            for e in self._entries.values():
                if e is entry or e.draining:
                    continue
                if any(self._entry_eligible(
                        e, r.labels, self.required_for(dict(r.labels)))
                       for r in inflight):
                    e.engine.warm_migration()
            t0 = time.perf_counter()
            records = self._relocate_for_retirement(entry)
            # honest accounting: when nothing could legally move (zero
            # eligible peers) the retirement falls back to pure draining,
            # which never blocks anyone — downtime is 0, not the cost of
            # discovering there was nowhere to go
            downtime_s = time.perf_counter() - t0 if records else 0.0
        report = DowntimeReport(
            prepare_s=0.0, downtime_s=downtime_s,
            migrate_bytes=sum(m.bytes_moved for m in records),
            metrics_before=metrics_before,
            metrics_after=compute_metrics([]),
            engine=name, event="retire", migrations=tuple(records))
        entry.pending_report = report
        entry.swap_t = time.time()
        self.history.append(report)
        rec = obs_events.RECORDER
        if rec is not None:
            rec.emit("cluster.retire", engine=name, mode=mode,
                     downtime_s=downtime_s, migrated=len(records))
        self._reap_drained()           # emptied/idle engines retire at once
        return report

    def rebalance(self, name: str, plan: ShardingPlan, *,
                  labels: Optional[Dict[str, str]] = None,
                  prefill_lengths: Sequence[int] = ()) -> DowntimeReport:
        """Retarget a live engine at a different workload class: update its
        tenancy labels and swap it onto ``plan`` via `reconfigure`. The
        scaler uses this when resizing an idle engine beats a cold
        spawn (no new params to initialize, one swap window).

        Args / Raises: as `reconfigure`; ``labels`` as in `register`.

        Returns:
            The swap's `DowntimeReport` with ``event="rebalance"``.
        """
        entry = self._entries[name]
        if labels:
            entry.engine.labels.update(labels)
        report = self.reconfigure(name, plan, prefill_lengths=prefill_lengths)
        report.event = "rebalance"
        value = entry.labels.get(self.ROUTE_KEY)
        if value:
            self.redistribute_queued(value)
        return report

    def redistribute_queued(self, value: str) -> int:
        """Re-route queued (not yet prefilled) requests labeled
        ``data-type=value`` across the currently eligible engines, so new
        capacity immediately shares the backlog instead of only absorbing
        future arrivals. Requests already resident in decode slots stay
        where they are (their KV state lives on that engine).

        Submission timestamps are preserved — a moved request's TTFT still
        measures from its original submit. A request that no engine can
        serve anymore stays on its current engine (never dropped).

        Returns:
            The number of requests moved through the router.
        """
        # both locks: queue surgery must not race request threads'
        # submits (_lock) nor a decode step admitting from the same
        # queues on the serving thread (_step_lock)
        with self._lock, self._step_lock:
            moved: List[Tuple[_EngineEntry, Request]] = []
            for e in self._entries.values():
                keep: List[Request] = []
                for r in e.engine.queue:
                    if r.labels.get(self.ROUTE_KEY, "*") == value:
                        moved.append((e, r))
                    else:
                        keep.append(r)
                e.engine.queue[:] = keep
            for src, r in moved:
                try:
                    name = self.route(r)
                except RoutingError:
                    self.rejected.pop()  # a requeue miss is no rejection
                    src.engine.queue.append(r)
                    continue
                dest = self._entries[name].engine
                # the destination must learn the prompt length, or a
                # later default-lengths reconfigure would omit it from
                # the lengths PREPARE warms
                dest.note_prompt_length(len(r.prompt))
                dest.queue.append(r)
            return len(moved)

    def pending_reports(self) -> List[str]:
        """Engine names whose latest `DowntimeReport` still awaits its
        post-event traffic window (empty list == all reports finalized)."""
        with self._lock:
            return [n for n, e in self._entries.items()
                    if e.pending_report is not None]

    def _finalize_pending(self, entry: _EngineEntry) -> None:
        """Close an entry's pending report with its honest final window
        (possibly empty) before a new scale event overwrites it."""
        if entry.pending_report is not None:
            entry.pending_report.metrics_after = compute_metrics(
                [r for r in entry.engine.done if r.t_done >= entry.swap_t])
            entry.pending_report = None

    def _reap_drained(self) -> None:
        """Deregister draining engines that have gone empty, finalizing
        their retire reports with the drain-window traffic and retaining
        their completions for cluster metrics."""
        for name in [n for n, e in self._entries.items() if e.draining]:
            entry = self._entries[name]
            eng = entry.engine
            if eng.queue or any(r is not None for r in eng.slot_req):
                continue               # still draining
            self._finalize_pending(entry)
            # consume the retiring engine's tail into the per-label folds
            # BEFORE its entry (and metrics_seen cursor) disappears
            self._fold_completions_locked()
            self._retired_done.extend(eng.done)
            if len(self._retired_done) > self.RETIRED_DONE_CAP:
                del self._retired_done[:-self.RETIRED_DONE_CAP]
            del self._entries[name]

    def _refresh_reports(self) -> None:
        """Re-finalize pending reports once post-swap completions exist, so
        metrics_after reflects traffic served *under the new plan*. Runs
        when `run()` drains (not per step, so the window isn't cut short
        while requests are still in flight)."""
        for e in self._entries.values():
            if e.pending_report is None:
                continue
            window = [r for r in e.engine.done if r.t_done >= e.swap_t]
            if window:
                e.pending_report.metrics_after = compute_metrics(window)
                e.pending_report = None

    # ------------------------------------------------------------------
    # intent application (called by Orchestrator.submit(apply_to=...))
    # ------------------------------------------------------------------
    def apply_policy(self, policy, components: Sequence = (), *,
                     async_prepare: bool = False
                     ) -> Dict[str, DowntimeReport]:
        """Program the cluster from a validated `CompiledPolicy`:

        1. translate the policy's plan updates into per-label route
           constraints (`flows/<data-type>` entries and component plans
           merge on the component's data-type label);
        2. reconfigure every engine that could serve a constrained label
           but whose current plan does not satisfy the constraint.

        With ``async_prepare`` the swaps ride the concurrent-PREPARE path
        (`reconfigure_async`): serving continues while the worker
        warms and each swap commits at the next step boundary.

        Returns {engine name: DowntimeReport} for engines that were
        swapped — or {engine name: PrepareTicket} when ``async_prepare``
        (each ticket's ``report`` finalizes on commit).
        """
        by_name = {c.name: c for c in components}
        merged: Dict[str, Dict[str, set]] = {}
        for key, p in policy.plan_updates.items():
            if key.startswith("flows/"):
                value = key[len("flows/"):]
            else:
                comp = by_name.get(key)
                value = comp.labels.get(self.ROUTE_KEY) if comp else None
            if not value or value == "*":
                continue
            m = merged.setdefault(value, {"axes": set(), "pins": set()})
            m["axes"].update(p.forbidden_collective_axes)
            if p.device_constraints:
                m["pins"].add(tuple(p.device_constraints))

        for value, m in merged.items():
            # a single consistent pin becomes a placement requirement;
            # conflicting pins (components load-balanced over several pods)
            # degrade to confinement on the pinned axes — still fail-closed:
            # an engine must be pinned *somewhere* on those axes to qualify
            pins = next(iter(m["pins"])) if len(m["pins"]) == 1 else ()
            axes = set(m["axes"])
            if len(m["pins"]) > 1:
                axes |= {axis for pin in m["pins"] for axis, _ in pin}
            if not pins and not axes:
                continue      # nothing enforceable — never install a
                              # vacuous constraint every engine satisfies
            self.set_route_constraint(value, ShardingPlan(
                device_constraints=pins,
                forbidden_collective_axes=tuple(sorted(axes))))

        # one swap per engine: merge ALL unsatisfied constraints into a
        # single target plan (per-constraint swaps would let a later pin
        # overwrite an earlier one and churn the engine through repeated
        # migrations); `merge_restrictions` degrades conflicting pins to
        # axis confinement, which stays fail-closed at routing time
        reports: Dict[str, DowntimeReport] = {}
        for e in list(self._entries.values()):
            if e.draining:
                continue               # a retiring engine never swaps
            unsatisfied = [
                required for value, required in self._routes.items()
                if e.serves({self.ROUTE_KEY: value})
                and not plan_satisfies(e.plan, required)]
            if not unsatisfied:
                continue
            new_plan = merge_restrictions(e.plan, *unsatisfied)
            if async_prepare:
                reports[e.name] = self.reconfigure_async(e.name, new_plan)
            else:
                reports[e.name] = self.reconfigure(e.name, new_plan)
        return reports
