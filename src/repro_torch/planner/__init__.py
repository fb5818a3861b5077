"""Workload-aware configuration planner: cost-model-driven selection of
the serving configuration on heterogeneous device pools.

    catalog    DeviceProfile roofline descriptions (the reference's A100 /
               L40S datasheet profiles, and a measured profile of the card
               or the host) attachable per engine or mesh slice;
    estimator  decode-step cost features counted over an engine's step,
               through the device roofline -> TTFT / TPOT / throughput /
               memory estimates;
    search     candidate enumeration (count x plan variant x profile),
               fail-closed pruning, demand-forecast scoring;
    planner    WorkloadPlanner: typed PlanAction sequences with dwell +
               switching-cost hysteresis, executed through the cluster's
               ticketed async machinery.

The reference's docs/planner.md gives the cost model and a worked intent
-> plan example.
"""
from repro_torch.planner.catalog import (  # noqa: F401
    A100,
    DEVICE_CATALOG,
    L40S,
    DeviceProfile,
    calibrate_host_profile,
    get_profile,
    register_profile,
)
from repro_torch.planner.estimator import (  # noqa: F401
    CostEstimate,
    CostFeatures,
    ResidualCalibration,
    TrafficMix,
    calibrated_estimate,
    estimate,
    estimate_disagg,
    features_from_engine,
    prefill_interference,
)
from repro_torch.planner.search import (  # noqa: F401
    Assignment,
    EngineSpec,
    LabelAssignment,
    LabelDemand,
    ScoredCandidate,
    best_candidate,
    demand_from_tracker,
    eligible_specs,
    score_current,
)
from repro_torch.planner.planner import (  # noqa: F401
    PlanAction,
    WorkloadPlanner,
)
