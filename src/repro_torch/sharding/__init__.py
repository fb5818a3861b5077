"""Sharding plans and their one-card placement."""
from repro_torch.sharding.plan import (  # noqa: F401
    AXIS_NAMES,
    Mesh,
    ShardingPlan,
    default_plan,
    merge_restrictions,
    plan_satisfies,
    plan_to_placement,
    restrict_mesh,
    single_device_mesh,
)
