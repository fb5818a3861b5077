"""Intent compiler: structured constraints -> enforcement-ready configs.

The two outputs mirror the paper's orchestration plane:
  * placement directives -> a pod assignment per component + a restricted
    `ShardingPlan` (device constraints / forbidden collective axes) — the
    accelerator analogue of Kubernetes node-selector manifests;
  * routing directives  -> explicit flow paths from the constrained path
    search — the analogue of ONOS per-hop flow rules.

Both are also rendered as auditable dicts (a K8s-style manifest and
ONOS-style flow rules) so the validator and the benchmark harness can
inspect exactly what would be applied.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import pathfinder
from repro_torch.core.intents import (
    Component,
    Configuration,
    Intent,
    PlacementConstraint,
    RoutingConstraint,
    tighten_bound,
)
from repro_torch.core.labels import Fabric, match_labels
from repro_torch.sharding.plan import ShardingPlan


@dataclasses.dataclass
class CompiledPolicy:
    intent: Intent
    config: Configuration
    manifests: List[Dict]                    # k8s-style placement manifests
    flow_rules: List[Dict]                   # onos-style flow rules
    plan_updates: Dict[str, ShardingPlan]    # component -> restricted plan
    errors: List[str]
    # data-type label -> (min, max) serving-engine counts; consumed by a
    # scaler's apply_policy (max None = unbounded)
    scale_bounds: Dict[str, Tuple[int, Optional[int]]] = \
        dataclasses.field(default_factory=dict)
    # data-type label -> (max TTFT s, max TPOT s) service-level targets;
    # consumed by a planner's apply_policy (the Φ_L planning objective;
    # None = no target on that metric)
    slo_targets: Dict[str, Tuple[Optional[float], Optional[float]]] = \
        dataclasses.field(default_factory=dict)


def eligible_pods(fabric: Fabric, c: PlacementConstraint) -> List[int]:
    return [pod for pod in fabric.pods()
            if c.holds_for_site(fabric.pod_labels(pod))]


def compile_intent(
    intent: Intent,
    fabric: Fabric,
    components: Sequence[Component],
    base_placement: Optional[Dict[str, int]] = None,
    base_plan: Optional[ShardingPlan] = None,
) -> CompiledPolicy:
    """Compile an intent against live state (placement-first, then routing —
    the paper's hybrid coordination: endpoints become concrete only after
    pods are scheduled)."""
    errors: List[str] = []
    placement: Dict[str, int] = dict(base_placement or {})
    plan = base_plan or ShardingPlan()
    manifests: List[Dict] = []
    plan_updates: Dict[str, ShardingPlan] = {}
    inventory = fabric.label_inventory()

    # ---- placement (compute layer) ----
    for pc in intent.placement:
        matched = [c for c in components if c.matches(pc.sel())]
        if not matched:
            errors.append(f"unenforceable: no workload matches {pc.sel()}")
            continue
        # hallucinated-label cross-check (paper failure mode 3) — required
        # labels only; forbidding an absent label is trivially satisfied
        for k, v in pc.require:
            known = inventory.get(k, frozenset())
            if known and v not in known:
                errors.append(f"unknown label {k}={v} (not on any node)")
        pods = eligible_pods(fabric, pc)
        if not pods:
            errors.append(f"no eligible site for {pc.sel()} "
                          f"(require={dict(pc.require)} forbid={dict(pc.forbid)})")
            continue
        # secondary objective: balance load over eligible pods
        load: Dict[int, int] = {p: 0 for p in pods}
        for comp_pod in placement.values():
            if comp_pod in load:
                load[comp_pod] += 1
        for comp in matched:
            pod = min(pods, key=lambda p: load[p])
            placement[comp.name] = pod
            load[pod] += 1
            manifests.append({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": comp.name, "labels": dict(comp.labels)},
                "spec": {"nodeSelector": dict(pc.require),
                         "forbiddenNodeLabels": dict(pc.forbid),
                         "assignedSite": f"pod{pod}"},
            })
            plan_updates[comp.name] = plan.with_(
                device_constraints=(("pod", pod),))

    # ---- routing (network layer) — after placement ----
    paths: Dict[Tuple[str, str], List[str]] = {}
    flow_rules: List[Dict] = []
    for rc in intent.routing:
        # pod-confinement implies co-location: move matching components into
        # one pod (hybrid coordination — placement enables routing)
        if "pod" in rc.forbidden_axes and rc.selector:
            names = [c.name for c in components if c.matches(dict(rc.selector))]
            if names:
                counts: Dict[int, int] = {}
                for nm in names:
                    p = placement.get(nm)
                    if p is not None:
                        counts[p] = counts.get(p, 0) + 1
                target = max(counts, key=counts.get) if counts else 0
                for nm in names:
                    placement[nm] = target
                    plan_updates[nm] = plan.with_(
                        device_constraints=(("pod", target),),
                        forbidden_collective_axes=tuple(rc.forbidden_axes))
        src_v = pathfinder.resolve_endpoint(fabric, rc.flow.src, placement) \
            if rc.flow.src != "*" else None
        dst_v = pathfinder.resolve_endpoint(fabric, rc.flow.dst, placement) \
            if rc.flow.dst != "*" else None
        wps = [pathfinder.resolve_endpoint(fabric, w, placement)
               for w in rc.waypoints]
        if any(w is None for w in wps):
            errors.append(f"waypoint not found: {rc.waypoints}")
            continue

        flows: List[Tuple[str, str]] = []
        if rc.flow.src == "*" and rc.flow.dst == "*":
            if rc.selector:
                # selector-scoped flows: all pairs among matching components
                names = [c.name for c in components
                         if c.matches(dict(rc.selector)) and c.name in placement]
                flows = [(a, b) for a in names for b in names if a != b]
            else:
                errors.append("ambiguous path: no src/dst and no selector "
                              "(empty <src,dst,must_go> triple)")
                continue
        elif rc.flow.src == "*":
            srcs = [c.name for c in components
                    if c.name in placement and c.name != rc.flow.dst]
            flows = [(s, rc.flow.dst) for s in srcs]
        else:
            flows = [(rc.flow.src, rc.flow.dst)]

        if src_v is None and rc.flow.src != "*":
            errors.append(f"unknown endpoint {rc.flow.src}")
            continue
        if dst_v is None and rc.flow.dst != "*":
            errors.append(f"unknown endpoint {rc.flow.dst}")
            continue

        found_any = False
        for s, d in flows:
            sv = pathfinder.resolve_endpoint(fabric, s, placement)
            dv = pathfinder.resolve_endpoint(fabric, d, placement)
            if sv is None or dv is None:
                continue
            path = pathfinder.find_path(
                fabric, sv, dv, forbid=rc.forbid_vertex,
                waypoints=[w for w in wps if w])
            if path is None:
                errors.append(f"no compliant path {s}->{d} "
                              f"(forbid={list(rc.forbid_vertex)})")
                continue
            paths[(s, d)] = path
            found_any = True
            for hop_a, hop_b in zip(path, path[1:]):
                flow_rules.append({
                    "deviceId": hop_a, "treatment": {"output": hop_b},
                    "selector": {"src": s, "dst": d,
                                 "criteria": dict(rc.selector)},
                    "priority": 40_000,
                })
        if not found_any and flows:
            errors.append(f"no applicable flow for {rc.flow} (no-op policy)")

        if rc.forbidden_axes:
            key = dict(rc.selector).get("data-type", "*")
            plan_updates[f"flows/{key}"] = plan.with_(
                forbidden_collective_axes=tuple(rc.forbidden_axes))

    # ---- scaling (runtime capacity layer) — per-label autoscaler bounds ----
    scale_bounds: Dict[str, Tuple[int, Optional[int]]] = {}
    for sc in intent.scaling:
        matched = [c for c in components if c.matches(sc.sel())]
        if not matched:
            errors.append(f"unenforceable: no workload matches {sc.sel()}")
            continue
        if sc.max_engines is not None and sc.min_engines > sc.max_engines:
            errors.append(f"inconsistent scaling bounds for {sc.sel()}: "
                          f"min {sc.min_engines} > max {sc.max_engines}")
            continue
        # bounds attach to the routing label (data-type) of the matched
        # workload class — the key the cluster routes and scales on
        values = {sc.sel().get("data-type")
                  or c.labels.get("data-type") for c in matched}
        values.discard(None)
        if not values:
            # a bound that resolves to no routing label can never be
            # enforced by the autoscaler — fail closed, don't drop it
            errors.append(f"unenforceable: scaling selector {sc.sel()} "
                          "resolves to no data-type routing label")
            continue
        for value in sorted(values):
            # several constraints can land on one label (e.g. a data-type
            # clause and an app clause whose component carries that
            # data-type): INTERSECT the bounds — last-wins would silently
            # drop an earlier clause; an empty intersection is an error
            lo, hi = scale_bounds.get(value, (0, None))
            lo = max(lo, sc.min_engines)
            if sc.max_engines is not None:
                hi = sc.max_engines if hi is None else min(hi, sc.max_engines)
            if hi is not None and lo > hi:
                errors.append(f"conflicting scaling bounds for "
                              f"data-type={value}: min {lo} > max {hi}")
                continue
            scale_bounds[value] = (lo, hi)

    # ---- service levels (runtime latency layer) — per-label SLO targets ----
    slo_targets: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
    for lc in intent.service:
        matched = [c for c in components if c.matches(lc.sel())]
        if not matched:
            errors.append(f"unenforceable: no workload matches {lc.sel()}")
            continue
        if (lc.max_ttft_s is not None and lc.max_ttft_s <= 0) or \
                (lc.max_tpot_s is not None and lc.max_tpot_s <= 0):
            errors.append(f"non-positive service-level target for "
                          f"{lc.sel()}: ttft={lc.max_ttft_s} "
                          f"tpot={lc.max_tpot_s}")
            continue
        # targets attach to the routing label (data-type) of the matched
        # workload class — the key the planner sizes capacity on
        values = {lc.sel().get("data-type")
                  or c.labels.get("data-type") for c in matched}
        values.discard(None)
        if not values:
            errors.append(f"unenforceable: service-level selector "
                          f"{lc.sel()} resolves to no data-type routing "
                          "label")
            continue
        for value in sorted(values):
            # several clauses can land on one label: INTERSECT (the
            # tighter target wins — last-wins would silently relax an
            # earlier promise)
            ttft, tpot = slo_targets.get(value, (None, None))
            slo_targets[value] = (tighten_bound(ttft, lc.max_ttft_s),
                                  tighten_bound(tpot, lc.max_tpot_s))

    config = Configuration(placement=placement, paths=paths)
    return CompiledPolicy(intent=intent, config=config, manifests=manifests,
                          flow_rules=flow_rules, plan_updates=plan_updates,
                          errors=errors, scale_bounds=scale_bounds,
                          slo_targets=slo_targets)
