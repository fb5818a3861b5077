"""Sharding plans: the compile target of the intent layer (a copy of
`repro.sharding.plan`'s `ShardingPlan`, `default_plan`, `plan_satisfies`
and `merge_restrictions`).

A plan has two halves: the parallelism layout (batch / FSDP / tensor /
expert axes) and the intent layer's restrictions (device pins and the mesh
axes collectives must not cross). The router checks the restrictions with
`plan_satisfies`; `merge_restrictions` is the one merge of them.

The layout half materialises in two ways:

  * across ranks: `param_specs`, `opt_state_specs`, `cache_specs` and
    `batch_specs` give a `PartitionSpec` tree congruent with the port's
    param, AdamW-state, cache (the flat ``pos{off}/<leaf>`` dict) and batch
    trees; `plan_to_shardings` turns them into a `LeafSharding` (a torch
    ``DeviceMesh`` and its DTensor placements) per leaf on a `Mesh` of
    process ranks (`rank_mesh`);
  * on one device: `plan_to_placement` resolves the plan's device pins on a
    `Mesh` of ``torch.device``s with the reference's modulo rule
    (`restrict_mesh`) and returns the device that holds the params and the
    one that holds the cache, the placement a `ServingEngine` takes.

Mesh axes are ``("pod", "data", "model")``. A spec entry naming several
axes (``("pod", "data")``) shards its dim over each of them in mesh order,
the first axis major, as the reference lays a tuple entry out; uneven dims
follow DTensor's chunk rule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXIS_NAMES = ("pod", "data", "model")

Tree = Dict[str, Any]


class PartitionSpec(tuple):
    """One array's layout, a dim at a time: each entry is None
    (replicated), a mesh axis name, or a tuple of names. Immutable, as the
    reference's ``PartitionSpec``, and normalised as it is: a tuple of one
    name becomes the name, an empty tuple None. ``PartitionSpec()``
    replicates a scalar."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, list):
                e = tuple(e)
            if not (e is None or isinstance(e, str)
                    or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))):
                raise TypeError(f"spec entry {e!r}: not None, an axis name or a tuple of names")
            if isinstance(e, tuple) and len(e) <= 1:
                e = e[0] if e else None
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that dim ``dim`` shards over."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e


P = PartitionSpec


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


# ---------------------------------------------------------------------------
# spec trees (pure functions of (cfg, plan), the reference's)
# ---------------------------------------------------------------------------


def _gqa_specs(plan: ShardingPlan) -> Tree:
    tp = plan.tp if plan.shard_attn_heads else None
    f = plan.fsdp
    return {"wq": P(f, tp), "wk": P(f, tp), "wv": P(f, tp), "wo": P(tp, f)}


def _mla_specs(cfg, plan: ShardingPlan) -> Tree:
    tp = plan.tp if plan.shard_attn_heads else None
    f = plan.fsdp
    return {
        "w_dq": P(f, None),
        "q_norm": {"scale": P(None)},
        "w_uq": P(None, tp),
        "w_dkv": P(f, None),
        "kv_norm": {"scale": P(None)},
        "w_uk": P(None, tp),
        "w_uv": P(None, tp),
        "wo": P(tp, f),
    }


def _norm_specs(cfg) -> Tree:
    s = {"scale": P(None)}
    if cfg.norm_type == "layernorm":
        s["bias"] = P(None)
    return s


def _mlp_specs(cfg, plan: ShardingPlan) -> Tree:
    f, tp = plan.fsdp, plan.tp
    s = {"w_up": P(f, tp), "w_down": P(tp, f)}
    if cfg.mlp_act == "silu":
        s["w_gate"] = P(f, tp)
    return s


def _moe_specs(cfg, plan: ShardingPlan) -> Tree:
    ep, f = plan.ep_axis, plan.fsdp
    s = {"router": P(f, None), "w_up": P(ep, f, None), "w_down": P(ep, None, f)}
    if cfg.mlp_act == "silu":
        s["w_gate"] = P(ep, f, None)
    if cfg.moe and cfg.moe.num_shared_experts:
        s["shared"] = _mlp_specs(cfg, plan)
    return s


def _ssm_specs(cfg, plan: ShardingPlan) -> Tree:
    f, tp = plan.fsdp, plan.tp
    return {
        "w_z": P(f, tp), "w_x": P(f, tp), "w_B": P(f, None), "w_C": P(f, None),
        "w_dt": P(f, tp),
        "conv_x_w": P(None, tp), "conv_x_b": P(tp),
        "conv_B_w": P(None, None), "conv_B_b": P(None),
        "conv_C_w": P(None, None), "conv_C_b": P(None),
        "dt_bias": P(tp), "A_log": P(tp), "D": P(tp),
        "norm_scale": P(tp),
        "out_proj": P(tp, f),
    }


def _sublayer_specs(cfg, plan: ShardingPlan, mixer: str, f: str) -> Tree:
    s: Tree = {"mixer_norm": _norm_specs(cfg)}
    if mixer == "attn":
        s["mixer"] = _gqa_specs(plan)
    elif mixer == "mla":
        s["mixer"] = _mla_specs(cfg, plan)
    else:
        s["mixer"] = _ssm_specs(cfg, plan)
    if f != "none":
        s["ffn_norm"] = _norm_specs(cfg)
        s["ffn"] = _moe_specs(cfg, plan) if f == "moe" else _mlp_specs(cfg, plan)
    return s


def _map_specs(fn, tree: Tree) -> Tree:
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _prepend(spec_tree: Tree, axis=None) -> Tree:
    """Add a leading (scan/layer) dim to every spec."""
    return _map_specs(lambda s: P(axis, *s), spec_tree)


def param_specs(cfg, plan: ShardingPlan) -> Tree:
    """A `PartitionSpec` tree congruent with the port's parameter tree
    (`lm.param_layout`, `encdec.param_layout`): the stacked layer leaves
    lead with an unsharded layer dim."""
    from repro_torch.models.lm import layer_kinds   # no cycle

    f, tp = plan.fsdp, plan.tp
    vocab_tp = tp if plan.shard_vocab else None
    if cfg.encdec is not None:
        enc_layer = {"attn_norm": _norm_specs(cfg), "attn": _gqa_specs(plan),
                     "mlp_norm": _norm_specs(cfg), "mlp": _mlp_specs(cfg, plan)}
        dec_layer = {"self_norm": _norm_specs(cfg), "self_attn": _gqa_specs(plan),
                     "cross_norm": _norm_specs(cfg), "cross_attn": _gqa_specs(plan),
                     "mlp_norm": _norm_specs(cfg), "mlp": _mlp_specs(cfg, plan)}
        return {"embed": P(vocab_tp, f), "pos_embed": P(None, None),
                "enc_layers": _prepend(enc_layer), "enc_norm": _norm_specs(cfg),
                "dec_layers": _prepend(dec_layer), "dec_norm": _norm_specs(cfg)}

    kinds = layer_kinds(cfg)
    if cfg.hybrid_period:
        layer = {f"pos{off}": _sublayer_specs(cfg, plan, *kinds[off])
                 for off in range(len(kinds))}
    else:
        layer = _sublayer_specs(cfg, plan, *kinds[0])
    specs = {"embed": P(vocab_tp, f), "layers": _prepend(layer),
             "final_norm": _norm_specs(cfg)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(f, vocab_tp)
    return specs


def opt_state_specs(pspecs: Tree) -> Tree:
    """AdamW-state specs: the moments shard as the params they track; the
    step count is replicated."""
    return {"m": pspecs, "v": pspecs, "count": P()}


def cache_specs(cfg, plan: ShardingPlan, *, batch: int) -> Tree:
    """Specs of the port's flat decode cache (`lm.cache_shape`,
    `encdec.cache_shape`), leaf names as its keys. The batch (axis 1) shards
    over the batch axes unless ``batch == 1``; K/V and the MLA latent shard
    their sequence over ``plan.seq_axis``; the SSM state shards its
    channels / heads over the tensor axis. An enc-dec model's cross K/V
    (over the encoder frames) keep their sequence whole."""
    from repro_torch.models.lm import layer_kinds, sub_prefixes

    b_ax = plan.batch_axes if batch > 1 else None
    seq = plan.seq_axis

    def gqa(seq_ax=seq):
        return {"k": P(None, b_ax, seq_ax, None, None), "v": P(None, b_ax, seq_ax, None, None)}

    def mla():
        return {"ckv": P(None, b_ax, seq, None), "kpe": P(None, b_ax, seq, None)}

    def ssm():
        return {"conv_x": P(None, b_ax, None, plan.tp), "conv_B": P(None, b_ax, None, None),
                "conv_C": P(None, b_ax, None, None), "ssm": P(None, b_ax, plan.tp, None, None)}

    if cfg.encdec is not None:
        return {**{f"self/{k}": v for k, v in gqa().items()},
                **{f"cross/{k}": v for k, v in gqa(seq_ax=None).items()}}
    out: Tree = {}
    for pre, (mixer, _) in zip(sub_prefixes(cfg), layer_kinds(cfg)):
        leaves = {"attn": gqa, "mla": mla, "ssm": ssm}[mixer]()
        out.update({pre + k: v for k, v in leaves.items()})
    return out


def batch_specs(cfg, plan: ShardingPlan, cell) -> Tree:
    """Input-batch specs of a shape cell: the batch dim shards over the
    batch axes unless ``cell.global_batch == 1``; a train cell adds the loss
    mask; an enc-dec model its frames; an M-RoPE model its ``(3, B, S)``
    positions, which carry the batch on axis 1."""
    b_ax = plan.batch_axes if cell.global_batch > 1 else None
    specs = {"tokens": P(b_ax, None)}
    if cell.kind == "train":
        specs["loss_mask"] = P(b_ax, None)
    if cfg.encdec is not None:
        specs["frames"] = P(b_ax, None, None)
    if cfg.pos_type == "mrope":
        specs["positions"] = P(None, b_ax, None)
    return specs


def prune_spec(spec: PartitionSpec, axis_names: Sequence[str]) -> PartitionSpec:
    """Drop the mesh axes a mesh does not carry (tuple entries element-wise;
    an entry left empty replicates)."""
    parts = []
    for entry in spec:
        if entry is None:
            parts.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axis_names)
            parts.append(kept if kept else None)
        else:
            parts.append(entry if entry in axis_names else None)
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes (the port's counterpart of a JAX
    mesh): ``devices`` is an object array of ``torch.device``s, one axis
    per name in ``axis_names``. A mesh over process ranks (`rank_mesh`)
    also holds ``ranks``, the rank at each coordinate, and has a
    ``DeviceMesh`` view (`device_mesh`)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXIS_NAMES
    ranks: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} cannot carry "
                             f"axes {self.axis_names}")
        if self.ranks is not None and self.ranks.shape != self.devices.shape:
            raise ValueError(f"ranks of shape {self.ranks.shape} on devices of "
                             f"shape {self.devices.shape}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_mesh(self, tag: str = ""):
        """The ``torch.distributed`` ``DeviceMesh`` over ``ranks``, made
        once per grid and ``tag`` and cached. Making one creates its process
        groups, a collective over the whole world: every rank must call this
        for every mesh, the ranks outside it included, in the same order.
        Another ``tag`` gives the same grid over process groups of its own
        (PREPARE's, `PREPARE_TAG`), so collectives issued on another thread
        never share a group with serving's.

        Raises:
            ValueError: the mesh holds devices, not ranks.
        """
        if self.ranks is None:
            raise ValueError("a mesh of devices has no DeviceMesh; build one over "
                             "ranks with rank_mesh")
        dev_type = self.devices.reshape(-1)[0].type
        key = (dev_type, self.axis_names, self.ranks.shape, tuple(self.ranks.reshape(-1)), tag)
        if key not in _DEVICE_MESHES:
            from torch.distributed.device_mesh import DeviceMesh
            _DEVICE_MESHES[key] = DeviceMesh(dev_type, torch.as_tensor(self.ranks),
                                             mesh_dim_names=self.axis_names)
        return _DEVICE_MESHES[key]


_DEVICE_MESHES: Dict[tuple, Any] = {}

#: the tag of PREPARE's process groups (`Mesh.device_mesh`)
PREPARE_TAG = "prepare"


def single_device_mesh(device, axis_names: Sequence[str] = AXIS_NAMES) -> Mesh:
    """A 1×…×1 mesh on one device carrying the full production axis names,
    so every plan's pins resolve."""
    devs = np.empty((1,) * len(axis_names), dtype=object)
    devs.reshape(-1)[0] = torch.device(device)
    return Mesh(devs, tuple(axis_names))


def rank_mesh(shape: Sequence[int], *, device: Union[str, torch.device] = "cuda",
              axis_names: Sequence[str] = AXIS_NAMES) -> Mesh:
    """A mesh over every rank of the default process group, laid out
    row-major over ``shape``: rank ``r`` holds CUDA device ``r mod n`` (or
    the CPU when the caller names it). A CUDA mesh runs over NCCL, a CPU
    mesh over gloo; nothing falls back.

    Raises:
        RuntimeError: no process group; ``device`` is CUDA and no card is
            available; the group's backend is not the device's.
        ValueError: ``shape`` does not hold the world's ranks.
    """
    import torch.distributed as dist

    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("rank_mesh needs an initialised process group")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} does not hold the {world} ranks")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh runs over {want}, not {dist.get_backend()}")
    ranks = np.arange(world).reshape(tuple(shape))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    devs = np.empty(ranks.shape, dtype=object)
    for idx, r in np.ndenumerate(ranks):
        devs[idx] = torch.device("cuda", int(r) % n_cards) if n_cards else torch.device("cpu")
    return Mesh(devs, tuple(axis_names), ranks)


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
    idx = tuple(idx)
    return Mesh(devs[idx], mesh.axis_names,
                None if mesh.ranks is None else mesh.ranks[idx])


class LeafSharding(NamedTuple):
    """One leaf's materialised layout: the ``DeviceMesh`` it lives on, the
    DTensor placements there (one per mesh dim), and the pruned spec they
    come from."""

    mesh: Any
    placements: Tuple[Any, ...]
    spec: PartitionSpec


def spec_placements(spec: PartitionSpec, axis_names: Sequence[str]) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on a mesh with ``axis_names``:
    ``Shard(d)`` on every mesh dim that dim ``d`` names, else
    ``Replicate()``.

    Raises:
        ValueError: the spec names an axis twice.
    """
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names:
        dims = [d for d in range(len(spec)) if name in spec.axes(d)]
        if len(dims) > 1:
            raise ValueError(f"{spec} shards dims {dims} over one axis {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def leaf_sharding(mesh: Mesh, spec: PartitionSpec, tag: str = "") -> LeafSharding:
    """``spec`` pruned to ``mesh``'s axes, on its ``DeviceMesh`` (of
    ``tag``)."""
    spec = prune_spec(spec, mesh.axis_names)
    return LeafSharding(mesh.device_mesh(tag), spec_placements(spec, mesh.axis_names), spec)


def plan_to_shardings(cfg, plan: ShardingPlan, mesh: Mesh, *, n_slots: int,
                      tag: str = "") -> Tree:
    """Materialise a plan across ranks: the mesh restricted to the plan's
    pins (`restrict_mesh`), and every param and cache leaf's
    `LeafSharding` there (`param_specs`, `cache_specs` at batch
    ``n_slots``, each pruned to the mesh's axes), over the process groups
    of ``tag`` (`Mesh.device_mesh`).

    Every rank must call this for every plan, the ranks outside the
    restricted mesh included (`Mesh.device_mesh`).

    Returns:
        ``{"params": tree, "cache": tree}`` of `LeafSharding`.
    """
    sub = restrict_mesh(mesh, plan.device_constraints)
    return {"params": _map_specs(lambda s: leaf_sharding(sub, s, tag), param_specs(cfg, plan)),
            "cache": _map_specs(lambda s: leaf_sharding(sub, s, tag),
                                cache_specs(cfg, plan, batch=n_slots))}


def is_shardings(layout: Any) -> bool:
    """Whether an engine layout is `plan_to_shardings`' (trees of
    `LeafSharding`) rather than `plan_to_placement`'s (devices)."""
    return isinstance(layout, dict) and isinstance(layout.get("params"), dict)


def plan_layout(cfg, plan: ShardingPlan, mesh: Mesh, *, n_slots: int) -> Tree:
    """An engine's layout under ``plan`` on ``mesh``, the one function the
    cluster calls. A mesh of devices (one process) gives the one-device
    placement (`plan_to_placement`, unchanged). A mesh of process ranks
    gives the shardings of the plan's restricted mesh (`plan_to_shardings`
    at the engine's ``cache_batch``: the page count of a paged pool, its
    slot count otherwise), even where the pins leave one rank: every rank
    of the world runs the same cluster, and the engine's state lives on the
    ranks its plan resolves to. Beside them, under ``"prepare"``, the same
    shardings over PREPARE's process groups (`PREPARE_TAG`), which the
    scratch state of PREPARE lives on.

    Every rank must call this for every plan, at the same point.

    Raises:
        ValueError: a mesh of devices whose restricted mesh spans more than
            one device (`plan_to_placement`).
    """
    if mesh.ranks is None:
        return plan_to_placement(plan, mesh)
    out = plan_to_shardings(cfg, plan, mesh, n_slots=n_slots)
    out["prepare"] = plan_to_shardings(cfg, plan, mesh, n_slots=n_slots, tag=PREPARE_TAG)
    out["mesh"] = restrict_mesh(mesh, plan.device_constraints)
    out["plan"] = plan
    return out


def plan_to_placement(plan: ShardingPlan, mesh: Mesh) -> Dict[str, torch.device]:
    """Materialise a plan on one device of ``mesh``: the plan's pins
    restrict the mesh (`restrict_mesh`) and the first device left holds
    both the params and the cache pool.

    Returns:
        ``{"params": device, "cache": device}``, the placement
        `ServingEngine.swap_plan` and `prepare_executables` take.

    Raises:
        ValueError: the restricted mesh spans more than one device: an
            engine lives on one (`plan_to_shardings` lays arrays out across
            ranks).
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
