"""Sharding plans: the compile target of the intent layer (a copy of
`repro.sharding.plan`'s `ShardingPlan`, `default_plan`, `plan_satisfies`
and `merge_restrictions`).

A plan has two halves: the parallelism layout (batch / FSDP / tensor /
expert axes) and the intent layer's restrictions (device pins and the mesh
axes collectives must not cross). The router checks the restrictions with
`plan_satisfies`; `merge_restrictions` is the one merge of them.

The port serves on one card, so a plan materialises as a placement, not as
per-array shardings: `plan_to_placement` resolves the plan's device pins on
a `Mesh` of ``torch.device``s (axes ``("pod", "data", "model")``) with the
reference's modulo rule (`restrict_mesh`) and returns the device that
holds the params and the one that holds the cache. Layouts across devices
(`param_specs`, `cache_specs`) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Logical-axis -> mesh-axis assignment for a whole deployment, plus
    the intent layer's placement restrictions.

    Immutable; derive variants with `with_`. Two halves:

      * parallelism layout (``batch_axes`` .. ``shard_vocab``): how arrays
        shard over the mesh (one card here: `plan_to_placement`);
      * intent restrictions (``device_constraints``,
        ``forbidden_collective_axes``): where the arrays may live and
        which mesh axes their collectives must not cross — checked by the
        validator and by the cluster router (`plan_satisfies`).

    Attributes:
        batch_axes: mesh axes the input batch shards over (DP).
        fsdp_axes: param-storage sharding axes (ZeRO-3 style).
        tp_axis: tensor-parallel mesh axis (None disables TP).
        ep_axis: expert-parallel mesh axis for MoE layers.
        seq_axis: KV-cache sequence sharding (flash-decoding style); a
            mesh axis name, tuple of names, or None.
        sequence_parallel: Megatron-style residual-stream sharding.
        shard_attn_heads: shard attention heads over ``tp_axis``.
        shard_vocab: shard embedding/LM-head vocab over ``tp_axis``.
        device_constraints: ``(("pod", 0), ...)`` — mesh-axis coordinates
            this plan's arrays are confined to (see `restrict_mesh`).
        forbidden_collective_axes: mesh axes that tagged tensors'
            collectives must NOT cross (validated against the collectives
            a decode step records, `ServingEngine.decode_collectives`).
    """

    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)     # param-storage sharding (ZeRO)
    tp_axis: Optional[str] = "model"           # tensor parallel
    ep_axis: Optional[str] = "model"           # expert parallel
    # KV-cache sequence sharding (flash-decoding / context parallel):
    # a mesh axis name or tuple of names
    seq_axis: Any = None
    # Megatron-style sequence parallelism for the residual stream: the
    # between-layer carry is sharded on (batch, tp) so saved scan residuals
    # shrink tp-fold; GSPMD inserts the AG/RS around attention/MLP.
    sequence_parallel: bool = False
    shard_attn_heads: bool = True
    shard_vocab: bool = True
    # restricted device placement (intent layer): mesh-axis coordinates this
    # plan's arrays are confined to, e.g. (("pod", 0),) pins to pod 0.
    device_constraints: Tuple[Tuple[str, int], ...] = ()
    # collective policy hook (intent layer): axes that tagged tensors'
    # collectives must NOT cross. Validated by repro_torch.core.validator.
    forbidden_collective_axes: Tuple[str, ...] = ()

    def with_(self, **kw) -> "ShardingPlan":
        """Return a copy with the given fields replaced (the plan itself
        is frozen).

        Raises:
            TypeError: on a field name `ShardingPlan` does not define.
        """
        return dataclasses.replace(self, **kw)

    @property
    def fsdp(self) -> Optional[Tuple[str, ...]]:
        """FSDP axes, normalized so an empty tuple reads as None."""
        return self.fsdp_axes or None

    @property
    def tp(self) -> Optional[str]:
        """Tensor-parallel axis (alias for ``tp_axis``)."""
        return self.tp_axis


def default_plan(multi_pod: bool = False) -> ShardingPlan:
    """The paper-faithful conservative baseline layout.

    Args:
        multi_pod: also spread the batch over the ``pod`` axis (DP across
            pods) — single-pod batch sharding otherwise.

    Returns:
        An unrestricted `ShardingPlan` (no device constraints, no
        forbidden collective axes).
    """
    if multi_pod:
        return ShardingPlan(batch_axes=("pod", "data"), fsdp_axes=("data",))
    return ShardingPlan()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes (the port's counterpart of a JAX
    mesh): ``devices`` is an object array of ``torch.device``s, one axis
    per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXIS_NAMES

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} cannot carry "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def single_device_mesh(device, axis_names: Sequence[str] = AXIS_NAMES) -> Mesh:
    """A 1×…×1 mesh on one device carrying the full production axis names,
    so every plan's pins resolve."""
    devs = np.empty((1,) * len(axis_names), dtype=object)
    devs.reshape(-1)[0] = torch.device(device)
    return Mesh(devs, tuple(axis_names))


def restrict_mesh(mesh: Mesh,
                  device_constraints: Tuple[Tuple[str, int], ...]) -> Mesh:
    """Slice a mesh down to the coordinates a plan is confined to.

    Logical coordinates fold onto the available hardware by modulo, so a
    plan pinned to ``("pod", 1)`` still resolves on a single-pod (or
    single-device) mesh. Axes the mesh does not carry are ignored; no
    constraints return the mesh unchanged.
    """
    if not device_constraints:
        return mesh
    devs = mesh.devices
    idx: list = [slice(None)] * devs.ndim
    for axis, coord in device_constraints:
        if axis in mesh.axis_names:
            ax = mesh.axis_names.index(axis)
            c = coord % devs.shape[ax]
            idx[ax] = slice(c, c + 1)
    return Mesh(devs[tuple(idx)], mesh.axis_names)


def plan_to_placement(plan: ShardingPlan, mesh: Mesh) -> Dict[str, torch.device]:
    """Materialise a plan on one device of ``mesh``: the plan's pins
    restrict the mesh (`restrict_mesh`) and the first device left holds
    both the params and the cache pool.

    Returns:
        ``{"params": device, "cache": device}``, the placement
        `ServingEngine.swap_plan` and `prepare_executables` take.

    Raises:
        ValueError: the restricted mesh spans more than one device; the
            port does not lay arrays out across devices yet.
    """
    sub = restrict_mesh(mesh, plan.device_constraints)
    if sub.devices.size != 1:
        raise ValueError(f"plan resolves to {sub.devices.size} devices "
                         f"(mesh {dict(sub.shape)}); the port places an engine on one")
    dev = sub.devices.reshape(-1)[0]
    return {"params": dev, "cache": dev}


def plan_satisfies(plan: ShardingPlan, required: ShardingPlan) -> bool:
    """Does `plan` meet the placement/routing requirements of `required`?

    Used by the cluster router (fail-closed): a labeled request may only be
    served by an engine whose plan satisfies the constraint plan compiled
    from the matching intent.

    * every required forbidden collective axis must either be forbidden by
      `plan` or pinned by a device constraint (a single coordinate on an
      axis means no collective can cross it);
    * every required device pin must be pinned identically by `plan`.

    Args:
        plan: the candidate engine's plan.
        required: the constraint plan compiled from an intent (only its
            restriction fields matter).

    Returns:
        True iff `plan` meets every restriction in `required`.
    """
    pinned = dict(plan.device_constraints)
    for axis in required.forbidden_collective_axes:
        if (axis not in plan.forbidden_collective_axes
                and axis not in pinned):
            return False
    for axis, coord in required.device_constraints:
        if pinned.get(axis) != coord:
            return False
    return True


def merge_restrictions(base: ShardingPlan,
                       *required: ShardingPlan) -> ShardingPlan:
    """Merge the restriction fields of `required` plans into `base`.

    The single source of the merge semantics used everywhere a plan must
    be made to satisfy intent constraints (cluster `apply_policy` swaps,
    autoscaler spawn/rebalance targets): forbidden collective axes union;
    device pins accumulate, and a pin that CONFLICTS (same axis, different
    coordinate — whether with `base` or between two required plans)
    degrades to forbidding that axis with no pin. That keeps the result
    fail-closed: an engine asked to be in two places at once satisfies
    neither pinned constraint and the affected labels are rejected at
    routing time rather than silently mis-placed.

    Args:
        base: the plan whose parallelism layout is kept.
        required: constraint plans (only their restriction fields matter).

    Returns:
        `base` with merged ``device_constraints`` and
        ``forbidden_collective_axes``.
    """
    pins = dict(base.device_constraints)
    axes = set(base.forbidden_collective_axes)
    conflicts: set = set()
    for req in required:
        axes.update(req.forbidden_collective_axes)
        for axis, coord in req.device_constraints:
            if axis in pins and pins[axis] != coord:
                conflicts.add(axis)
            else:
                pins[axis] = coord
    for axis in conflicts:
        pins.pop(axis, None)
        axes.add(axis)
    return base.with_(device_constraints=tuple(sorted(pins.items())),
                      forbidden_collective_axes=tuple(sorted(axes)))
