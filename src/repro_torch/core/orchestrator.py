"""The intent-driven orchestration loop (paper §4.2, steps A–F).

  (A) query network topology        (fabric graph / ONOS analogue)
  (B) query placement state         (component -> pod map / K8s analogue)
  (C) construct the enriched prompt (condensed state snapshot)
  (D) parse LLM response            (interpreter backend)
  (E) apply network flow rules      (install realized paths)
  (F) apply service placement       (commit pod assignments / plans)

Safety layer: the compiled policy is applied only if the validator passes
every atomic check (fail-closed) — LLM output is a *suggested* plan.

Runtime hook: `submit(text, apply_to=cluster)` pushes the validated policy
into a live `ServingCluster` — route constraints are installed and every
affected engine is reconfigured online (the compiled plan placed on the
cluster's mesh, prefill/decode warmed in the PREPARE phase, blocking swap,
DowntimeReport per engine in `result.reports`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.compiler import CompiledPolicy, compile_intent
from repro_torch.core.intents import Component, Configuration, DEFAULT_WORKLOAD
from repro_torch.core.interpreter import DeterministicInterpreter, InterpreterBackend
from repro_torch.core.labels import Fabric, build_fabric
from repro_torch.core.validator import ValidationReport, validate


@dataclasses.dataclass
class FabricState:
    """Mutable run-time state of the deployment (the test-bed analogue)."""

    placement: Dict[str, int] = dataclasses.field(default_factory=dict)
    flows: Dict[Tuple[str, str], List[str]] = dataclasses.field(default_factory=dict)
    flow_rules: List[Dict] = dataclasses.field(default_factory=list)
    manifests: List[Dict] = dataclasses.field(default_factory=list)
    plans: Dict[str, object] = dataclasses.field(default_factory=dict)
    # data-type label -> (min, max) serving-engine bounds committed by
    # scaling intents (the HPA-manifest analogue)
    scale_bounds: Dict[str, Tuple[int, Optional[int]]] = \
        dataclasses.field(default_factory=dict)
    # data-type label -> (max TTFT s, max TPOT s) committed by
    # service-level intents (the planner-objective analogue)
    slo_targets: Dict[str, Tuple[Optional[float], Optional[float]]] = \
        dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OrchestrationResult:
    policy: CompiledPolicy
    report: ValidationReport
    applied: bool
    timings: Dict[str, float]
    prompt_tokens: int
    completion_tokens: int
    # engine -> DowntimeReport, populated when submit() ran with apply_to=
    reports: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def success(self) -> bool:
        return self.report.passed and self.applied

    @property
    def total_s(self) -> float:
        return sum(self.timings.values())


class Orchestrator:
    def __init__(self, fabric: Optional[Fabric] = None,
                 interpreter: Optional[InterpreterBackend] = None,
                 components: Sequence[Component] = DEFAULT_WORKLOAD,
                 stabilization_s: float = 0.0):
        self.fabric = fabric or build_fabric((2, 16, 16),
                                             ("pod", "data", "model"))
        self.interpreter = interpreter or DeterministicInterpreter()
        self.components = tuple(components)
        self.state = FabricState()
        self.stabilization_s = stabilization_s
        # default placement: spread components over pods
        for i, comp in enumerate(self.components):
            self.state.placement[comp.name] = i % max(len(self.fabric.pods()), 1)

    # ------------------------------------------------------------------
    def submit(self, text: str,
               collective_modules: Optional[Dict[str, Sequence[object]]] = None,
               apply_to: Optional[object] = None,
               async_reconfig: bool = False,
               ) -> OrchestrationResult:
        """Run the six-step loop for one intent.

        `collective_modules` maps a module name to the collectives its
        traced step issued (`ServingEngine.decode_collectives`); the
        validator checks every routing constraint's forbidden axes against
        the modules whose name holds its data-type.

        `apply_to` (a `repro_torch.serving.cluster.ServingCluster` —
        anything with an ``apply_policy(policy, components=...)`` hook)
        extends step (F) into the live runtime: on a passing validation the
        cluster's route constraints are programmed from the compiled plan
        updates and affected engines are reconfigured online (prepare-ahead
        + blocking swap). The per-engine `DowntimeReport`s land in
        `result.reports`.

        With ``async_reconfig`` the runtime step rides the cluster's
        concurrent-PREPARE path: `submit` returns as soon as the intent
        is validated and the background warm-ups are staged, and
        `result.reports` holds per-engine `PrepareTicket`s whose
        `DowntimeReport`s finalize when the swaps commit at the cluster's
        next step boundaries (serving continues throughout).
        """
        timings: Dict[str, float] = {}

        # (A) + (B): state retrieval
        t0 = time.time()
        _topology = {"vertices": list(self.fabric.vertices),
                     "links": len(self.fabric.links)}
        _placement = dict(self.state.placement)
        timings["state_query"] = time.time() - t0

        # (C) + (D): interpretation (prompt construction inside the backend)
        t0 = time.time()
        res = self.interpreter.interpret(text, self.fabric, self.components)
        timings["interpret"] = time.time() - t0

        # compile against live state (placement first, then routing)
        t0 = time.time()
        policy = compile_intent(res.intent, self.fabric, self.components,
                                base_placement=_placement)
        timings["compile"] = time.time() - t0

        # safety layer: validate BEFORE applying (fail-closed)
        t0 = time.time()
        report = validate(policy, self.fabric, self.components,
                          collective_modules=collective_modules,
                          mesh_shape=self.fabric.mesh_shape,
                          axis_names=self.fabric.axis_names)
        timings["validate"] = time.time() - t0

        applied = False
        t0 = time.time()
        if report.passed:
            # (E) network flow rules, then (F) placement commit
            self.state.flows.update(policy.config.paths)
            self.state.flow_rules.extend(policy.flow_rules)
            self.state.placement.update(policy.config.placement)
            self.state.manifests.extend(policy.manifests)
            self.state.plans.update(policy.plan_updates)
            self.state.scale_bounds.update(policy.scale_bounds)
            self.state.slo_targets.update(policy.slo_targets)
            applied = True
        if self.stabilization_s:
            time.sleep(self.stabilization_s)
        timings["apply"] = time.time() - t0

        # (F, runtime) intent materialization: program the serving cluster
        reports: Dict[str, object] = {}
        if applied and apply_to is not None:
            t0 = time.time()
            kw = {"async_prepare": True} if async_reconfig else {}
            reports = apply_to.apply_policy(policy,
                                            components=self.components,
                                            **kw)
            timings["reconfigure"] = time.time() - t0

        return OrchestrationResult(
            policy=policy, report=report, applied=applied, timings=timings,
            prompt_tokens=res.prompt_tokens,
            completion_tokens=res.completion_tokens,
            reports=reports)
