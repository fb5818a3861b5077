"""The paper's primary contribution in the port: LLM-driven intent-based
privacy-aware orchestration (copies of `repro.core`'s pipeline).

Pipeline: natural-language intent
  -> interpreter (knowledge plane, LLM-shaped backend)
  -> compiler (placement + routing -> ShardingPlans + flow paths)
  -> validator (fail-closed atomic checks incl. the collectives a traced
     decode step issues)
  -> orchestrator (six-step apply loop; `apply_to=` a port `ServingCluster`
     reconfigures it online).
  -> reconfig (`ReconfigEngine`: the reference's deprecated single-engine
     shim over the same lifecycle).
"""
from repro_torch.core.compiler import CompiledPolicy, compile_intent  # noqa: F401
from repro_torch.core.corpus import CORPUS, CorpusEntry  # noqa: F401
from repro_torch.core.intents import (  # noqa: F401
    Component,
    Configuration,
    DEFAULT_WORKLOAD,
    Flow,
    Intent,
    PlacementConstraint,
    RoutingConstraint,
    ScalingConstraint,
    ServiceLevelConstraint,
    satisfies,
)
from repro_torch.core.interpreter import (  # noqa: F401
    DeterministicInterpreter,
    FaultyInterpreter,
    InterpretResult,
)
from repro_torch.core.labels import Fabric, Site, build_fabric  # noqa: F401
from repro_torch.core.orchestrator import (  # noqa: F401
    FabricState,
    OrchestrationResult,
    Orchestrator,
)
from repro_torch.core.reconfig import DowntimeReport, ReconfigEngine  # noqa: F401
from repro_torch.core.validator import ValidationReport, validate  # noqa: F401
