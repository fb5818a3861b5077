"""Automated validation pipeline (paper §5.5): atomic pass/fail checks over
the post-deployment state, executed without human intervention.

Check classes:
  * placement checks — every matched component sits on a site satisfying
    the constraint (λ_N lookup);
  * label-existence checks — referenced labels exist in the inventory
    (catches hallucinated identifiers, failure mode 3);
  * routing checks — realized paths avoid forbidden vertices / include
    waypoints; a constraint that matched no flow is a detected no-op
    policy (failure mode 2) and FAILS;
  * collective checks — for plans carrying `forbidden_collective_axes`,
    the collectives a traced decode step issues must not cross those mesh
    axes (`ServingEngine.decode_collectives` records them; the reference
    parses them from the compiled HLO). A collective whose group cannot be
    read is taken to cross every axis of extent > 1 (fail-closed);
  * scaling checks — autoscaler bounds must target an existing workload
    class and be internally consistent (min <= max).

An intent is successful only if ALL its checks pass (fail-closed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compiler import CompiledPolicy
from repro_torch.core.intents import (
    Component,
    Configuration,
    Intent,
    placement_satisfied,
    routing_satisfied,
)
from repro_torch.core.labels import Fabric


@dataclasses.dataclass
class Check:
    name: str
    passed: bool
    detail: str


@dataclasses.dataclass
class ValidationReport:
    intent_text: str
    checks: List[Check]
    elapsed_s: float

    @property
    def passed(self) -> bool:
        return bool(self.checks) and all(c.passed for c in self.checks)

    @property
    def n_checks(self) -> int:
        return len(self.checks)

    def summary(self) -> str:
        flag = "PASS" if self.passed else "FAIL"
        return f"[{flag}] {len(self.checks)} checks, {self.elapsed_s*1e3:.1f} ms"


def validate(policy: CompiledPolicy, fabric: Fabric,
             components: Sequence[Component],
             collective_modules: Optional[Dict[str, Sequence[Any]]] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             axis_names: Optional[Tuple[str, ...]] = None) -> ValidationReport:
    t0 = time.time()
    intent = policy.intent
    config = policy.config
    checks: List[Check] = []
    inventory = fabric.label_inventory()

    # compiler-detected errors fail closed
    for err in policy.errors:
        checks.append(Check("compiler/fail-closed", False, err))

    # ---- placement checks ----
    for i, pc in enumerate(intent.placement):
        # hallucination cross-check applies to REQUIRED labels only: a
        # forbid on an absent label is trivially satisfied, not an error
        for k, v in pc.require:
            known = inventory.get(k, frozenset())
            ok = (not known) or (v in known)
            checks.append(Check(
                f"placement[{i}]/label-exists({k}={v})", ok,
                "label present in inventory" if ok
                else f"label {k}={v} does not exist on any node"))
        ok, msg = placement_satisfied(pc, config, fabric, components)
        checks.append(Check(f"placement[{i}]/state", ok, msg))

    # ---- routing checks ----
    for i, rc in enumerate(intent.routing):
        if rc.waypoints or rc.forbid_vertex or rc.forbidden_axes \
                or rc.flow.src != "*" or rc.flow.dst != "*":
            ok, msg = routing_satisfied(rc, config, fabric)
            checks.append(Check(f"routing[{i}]/paths", ok, msg))
        # artifact-level collective-axis compliance
        if rc.forbidden_axes and collective_modules is not None:
            key = dict(rc.selector).get("data-type", "*")
            for mod_name, colls in collective_modules.items():
                if key != "*" and key not in mod_name:
                    continue
                ok, msg = check_collective_axes(
                    colls, rc.forbidden_axes, mesh_shape or (2, 16, 16),
                    axis_names or ("pod", "data", "model"))
                checks.append(Check(
                    f"routing[{i}]/collectives[{mod_name}]", ok, msg))

    # ---- scaling checks (runtime capacity bounds) ----
    for i, sc in enumerate(intent.scaling):
        matched = [c for c in components if c.matches(sc.sel())]
        ok = bool(matched)
        checks.append(Check(
            f"scaling[{i}]/workload-exists", ok,
            f"{len(matched)} component(s) match {sc.sel()}" if ok
            else f"no component matches selector {sc.sel()} (unenforceable)"))
        sane = (sc.min_engines >= 0
                and (sc.max_engines is None
                     or sc.min_engines <= sc.max_engines))
        checks.append(Check(
            f"scaling[{i}]/bounds-sane", sane,
            f"min={sc.min_engines} max={sc.max_engines}" if sane
            else f"inconsistent bounds min={sc.min_engines} "
                 f"max={sc.max_engines}"))

    # ---- service-level checks (runtime latency targets) ----
    for i, lc in enumerate(intent.service):
        matched = [c for c in components if c.matches(lc.sel())]
        ok = bool(matched)
        checks.append(Check(
            f"service[{i}]/workload-exists", ok,
            f"{len(matched)} component(s) match {lc.sel()}" if ok
            else f"no component matches selector {lc.sel()} (unenforceable)"))
        sane = ((lc.max_ttft_s is None or lc.max_ttft_s > 0)
                and (lc.max_tpot_s is None or lc.max_tpot_s > 0)
                and not (lc.max_ttft_s is None and lc.max_tpot_s is None))
        checks.append(Check(
            f"service[{i}]/targets-sane", sane,
            f"ttft<={lc.max_ttft_s} tpot<={lc.max_tpot_s}" if sane
            else f"degenerate service-level targets ttft={lc.max_ttft_s} "
                 f"tpot={lc.max_tpot_s}"))

    if not checks:
        checks.append(Check("no-constraints", False,
                            "intent produced no enforceable constraints"))
    return ValidationReport(intent.text, checks, time.time() - t0)


def axes_crossed(ranks: Optional[Sequence[int]], mesh_shape: Sequence[int],
                 axis_names: Sequence[str]) -> Tuple[str, ...]:
    """Mesh axes along which a collective over ``ranks`` (global device
    indices, row-major over ``mesh_shape``) moves data; ``None`` (group
    unknown) crosses every axis of extent > 1."""
    shape = tuple(mesh_shape)
    if ranks is None:
        return tuple(sorted(n for n, e in zip(axis_names, shape) if e > 1))
    ids = np.asarray(sorted(set(ranks)), dtype=np.int64)
    if len(ids) < 2:
        return ()
    coords = np.stack(np.unravel_index(ids, shape), axis=-1)
    return tuple(sorted(axis_names[ax] for ax in range(len(shape))
                        if len(np.unique(coords[:, ax])) > 1))


def check_collective_axes(collectives: Sequence[Any],
                          forbidden_axes: Sequence[str],
                          mesh_shape: Sequence[int], axis_names: Sequence[str]
                          ) -> Tuple[bool, str]:
    """No recorded collective (``.op``, ``.ranks``) may cross a forbidden
    axis."""
    offenders = []
    for coll in collectives:
        bad = set(axes_crossed(coll.ranks, mesh_shape, axis_names)) & set(forbidden_axes)
        if bad:
            offenders.append((coll.op, sorted(bad)))
    if offenders:
        kinds = ", ".join(f"{k} crosses {a}" for k, a in offenders[:5])
        return False, f"{len(offenders)} collectives cross forbidden axes: {kinds}"
    return True, (f"{len(collectives)} collectives checked, none cross "
                  f"{list(forbidden_axes)}")
