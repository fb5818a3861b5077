"""Intent IR: constraints Φ_C / Φ_N and the satisfaction relation C ⊨_λ I.

Mirrors the paper's formal model (§3.3):
  * configuration C = ⟨σ, ρ⟩ — σ places workload components on sites/pods,
    ρ is the set of routing constraints realized as explicit paths;
  * C ⊨_λ I  iff  every placement constraint holds for σ under λ_N and
    every routing constraint holds for the realized paths under λ_V.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.labels import Fabric, match_labels

Labels = Mapping[str, str]


# ---------------------------------------------------------------------------
# workload model (the paper's microservice inventory, Table 3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Component:
    """A deployable workload component (the paper's pod/service)."""

    name: str                     # "patient", "phi-db", ...
    labels: Dict[str, str]        # {"app": "patient", "data-type": "phi"}

    def matches(self, selector: Labels) -> bool:
        return match_labels(self.labels, selector)


DEFAULT_WORKLOAD = (
    Component("appointment", {"app": "appointment", "data-type": "general"}),
    Component("doctor", {"app": "doctor", "data-type": "general"}),
    Component("patient", {"app": "patient", "data-type": "phi"}),
    Component("vital-sign-monitor", {"app": "vital-sign-monitor", "data-type": "phi"}),
    Component("phi-db", {"app": "phi-db", "data-type": "phi"}),
    Component("general-db", {"app": "general-db", "data-type": "general"}),
    Component("image-preprocessor", {"app": "image-preprocessor", "data-type": "general"}),
)


@dataclasses.dataclass(frozen=True)
class Flow:
    """A traffic flow between endpoints (the paper's host pairs)."""

    src: str                      # component name or "host<N>" or "*"
    dst: str


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlacementConstraint:
    """Φ_C: components matching `selector` must sit on sites whose labels
    satisfy `require` and none of `forbid`."""

    selector: Tuple[Tuple[str, str], ...]           # component-label predicate
    require: Tuple[Tuple[str, str], ...] = ()       # node labels that must hold
    forbid: Tuple[Tuple[str, str], ...] = ()        # node labels that must not

    def sel(self) -> Dict[str, str]:
        return dict(self.selector)

    def holds_for_site(self, site_labels: Labels) -> bool:
        if self.require and not match_labels(site_labels, dict(self.require)):
            return False
        for k, v in self.forbid:
            if match_labels(site_labels, {k: v}):
                return False
        return True


@dataclasses.dataclass(frozen=True)
class RoutingConstraint:
    """Φ_N: paths for `flow` must avoid forbidden vertices, include the
    required waypoints, and (mesh realization) never cross forbidden mesh
    axes with the selected tensors' collectives."""

    flow: Flow
    forbid_vertex: Tuple[Tuple[str, str], ...] = ()   # λ_V predicates to avoid
    waypoints: Tuple[str, ...] = ()                   # vertex ids that must appear
    forbidden_axes: Tuple[str, ...] = ()              # mesh axes (e.g. ("pod",))
    selector: Tuple[Tuple[str, str], ...] = ()        # data selector (phi flows)


@dataclasses.dataclass(frozen=True)
class ScalingConstraint:
    """Φ_S (runtime extension): the serving fabric must keep between
    `min_engines` and `max_engines` engines able to serve the workload
    class matching `selector` ("keep at least two engines for phi
    traffic"). Compiled into per-label autoscaler bounds
    (`CompiledPolicy.scale_bounds`) and enforced by
    `repro_torch.serving.autoscaler.Autoscaler`."""

    selector: Tuple[Tuple[str, str], ...]     # component-label predicate
    min_engines: int = 0
    max_engines: Optional[int] = None         # None == unbounded

    def sel(self) -> Dict[str, str]:
        return dict(self.selector)


def tighten_bound(old: Optional[float], new: Optional[float]
                  ) -> Optional[float]:
    """Intersection of two optional upper bounds (the tighter wins) —
    the merge rule for repeated service-level targets on one label,
    shared by the compiler and the planner."""
    if old is None:
        return new
    if new is None:
        return old
    return min(old, new)


@dataclasses.dataclass(frozen=True)
class ServiceLevelConstraint:
    """Φ_L (runtime extension): the serving fabric must keep the latency
    of the workload class matching `selector` within the given targets
    ("keep TTFT under 200 ms for phi traffic"). Compiled into per-label
    planner objectives (`CompiledPolicy.slo_targets`) and enforced by
    `repro_torch.planner.WorkloadPlanner`, which sizes and places capacity
    so the cost-model-predicted TTFT/TPOT stay inside the targets."""

    selector: Tuple[Tuple[str, str], ...]     # component-label predicate
    max_ttft_s: Optional[float] = None        # time-to-first-token target
    max_tpot_s: Optional[float] = None        # per-output-token target

    def sel(self) -> Dict[str, str]:
        return dict(self.selector)


@dataclasses.dataclass(frozen=True)
class Intent:
    text: str
    domain: str                   # computing | networking | hybrid
    complexity: str               # simple | complex
    placement: Tuple[PlacementConstraint, ...] = ()
    routing: Tuple[RoutingConstraint, ...] = ()
    scaling: Tuple[ScalingConstraint, ...] = ()
    service: Tuple[ServiceLevelConstraint, ...] = ()
    # intents referencing labels absent from the fabric are *unenforceable*
    # and must fail closed (paper Table 6, row 1)
    expect_unenforceable: bool = False


# ---------------------------------------------------------------------------
# configuration (C = ⟨σ, ρ⟩) and satisfaction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Configuration:
    """A deployed configuration: placement map + realized flow paths."""

    placement: Dict[str, int]                 # component name -> pod index
    paths: Dict[Tuple[str, str], List[str]]   # (src, dst) -> vertex-id path
    plans: Dict[str, object] = dataclasses.field(default_factory=dict)
    # executables etc. attached by the orchestrator


def placement_satisfied(c: PlacementConstraint, config: Configuration,
                        fabric: Fabric, components: Sequence[Component]
                        ) -> Tuple[bool, str]:
    matched = [comp for comp in components if comp.matches(c.sel())]
    if not matched:
        return False, f"no component matches selector {c.sel()} (unenforceable)"
    for comp in matched:
        pod = config.placement.get(comp.name)
        if pod is None:
            return False, f"component {comp.name} not placed"
        labels = fabric.pod_labels(pod)
        if not c.holds_for_site(labels):
            return False, (f"{comp.name} on pod{pod} {labels} violates "
                           f"require={dict(c.require)} forbid={dict(c.forbid)}")
    return True, f"{len(matched)} component(s) compliant"


def routing_satisfied(c: RoutingConstraint, config: Configuration,
                      fabric: Fabric) -> Tuple[bool, str]:
    from repro_torch.core import pathfinder  # local import (no cycle at module load)

    flows = [(s, d) for (s, d) in config.paths
             if _flow_matches(c.flow, s, d)]
    if not flows:
        return False, f"no realized flow matches {c.flow} (no-op policy)"
    for key in flows:
        path = config.paths[key]
        exempt = pathfinder.exempt_set(fabric, path[0], path[-1])
        # explicitly named waypoints override avoidance predicates
        for wp in c.waypoints:
            wp_v = pathfinder.resolve_endpoint(fabric, wp, config.placement)
            if wp_v:
                exempt.add(wp_v)
        for vid in path:
            if vid in exempt:
                continue
            labels = fabric.vertex_labels(vid)
            for k, v in c.forbid_vertex:
                if match_labels(labels, {k: v}):
                    return False, f"path {key} traverses forbidden {vid} ({k}={v})"
        for wp in c.waypoints:
            wp_v = pathfinder.resolve_endpoint(fabric, wp, config.placement)
            if wp_v is None or wp_v not in path:
                return False, f"path {key} misses waypoint {wp}"
        if "pod" in c.forbidden_axes:
            pods = {fabric.vertex_labels(v).get("pod") for v in path}
            if len(pods) > 1:
                return False, f"path {key} crosses pods {sorted(pods)}"
    return True, f"{len(flows)} flow(s) compliant"


def _flow_matches(flow: Flow, src: str, dst: str) -> bool:
    return (flow.src in ("*", src)) and (flow.dst in ("*", dst))


def satisfies(intent: Intent, config: Configuration, fabric: Fabric,
              components: Sequence[Component]) -> Tuple[bool, List[str]]:
    """C ⊨_λ I — returns (ok, list of per-constraint messages)."""
    msgs: List[str] = []
    ok = True
    for pc in intent.placement:
        good, msg = placement_satisfied(pc, config, fabric, components)
        ok &= good
        msgs.append(("PASS " if good else "FAIL ") + msg)
    for rc in intent.routing:
        good, msg = routing_satisfied(rc, config, fabric)
        ok &= good
        msgs.append(("PASS " if good else "FAIL ") + msg)
    return ok, msgs
