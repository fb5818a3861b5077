"""The activation-sharding context, and the DTensor helpers the sharded
step builders (`launch.steps`) use.

Model code is plan-agnostic. The builders enter `activation_sharding(mesh,
plan)` around a step, and the model's `constrain(x, ...)` calls (the
reference's sites, by logical dim names) read it. Outside any context
`constrain` is the identity. Inside one it applies the reference's
divisibility rule and redistributes a DTensor to the resolved placements; a
plain tensor passes as it is, because the port's sharded steps keep their
activations rank-local: each rank runs its own batch rows, so the model code
and the kernels only ever see plain tensors.

The context also records the mesh axes the batch rows are split over, so
the few reductions that must be global (the train loss's mask count, the
MoE aux loss's statistics) sum over them (`batch_sum`).

A serving or train step enters the context with ``tensor_parallel=True``.
Then the plan's tensor axis (`tp`: its extent and this rank's coordinate)
splits the work as the reference's compiler splits it: each rank computes
on its own shard of that axis (`layer_local`, `local_of`), the partial
results are summed over the axis where the math needs a sum (`tp_sum`), the
new K/V heads are gathered for the replicated cache (`tp_gather`), and the
greedy pick reads the vocab shards (`tp_argmax`). Attention heads that
do not divide the axis run padded, as the reference's compiler pads them:
the head count rounded up to a multiple of the extent, each rank holding
its run of head slots of the leaf gathered whole (`head_slots`,
`slot_cut`), a slot past the real heads zero. Each sub-layer notes whether
it ran on its shard, padded or gathered whole (`note_tp`, read by
`tp_counts`).

A train step differentiates through the same sums, so each has an
autograd rule written out (`torch.autograd.Function`s; the functional
collectives' own rules are not relied on). A tensor every rank of the
axis holds alike ("replicated") crosses into a shard's computation through
`tp_enter` (identity forward, all-reduce backward); a shard's partial
output leaves through `tp_reduce` (all-reduce forward, identity backward);
a sum that each rank's own shard reads back (the SSM gated norm's
variance) is `tp_sum_shard` (all-reduce both ways). Under sequence
parallelism the residual stream holds this rank's piece of the sequence,
and a sub-layer's norm runs on it: `sp_enter` makes the normed piece whole
for a sub-layer that reads it on its shards (all-gather forward,
reduce-scatter backward), `sp_gather` for one every rank computes whole and
alike, `sp_scatter` sums a partial output into the piece, `sp_cut` cuts a
replicated tensor to it. Inside a sub-layer whose input has entered so, a
branch every rank computes whole from it takes its gradient once
(`tp_once`; `tp_branch` picks each branch's rule). The FSDP
axes are gathered a layer at a time by `gather_shard` (all-gather forward;
backward a reduce-scatter over the axes that split the rows, or an
all-reduce then a cut without ``shard_grads``, a cut over the others).

A decode step enters the context with ``seq_local=True``: where the plan
names a ``seq_axis``, each rank then holds its own piece of the K/V
cache's sequence (`seq_axes`, `seq_piece`), and attention combines its
softmax over those axes (`seq_max`, `seq_sum`).
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

_STATE = threading.local()


class _Frame(NamedTuple):
    """One entered `activation_sharding`."""

    mesh: Any
    plan: Any
    row_axes: Tuple[str, ...]
    rows: Optional[int]
    tensor_parallel: bool
    device_mesh: Any
    shard_grads: bool
    grad_dtype: Optional[torch.dtype]
    seq_local: bool


def _stack() -> list:
    if not hasattr(_STATE, "active"):
        _STATE.active = []
    return _STATE.active


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor. Until something imports
    ``torch.distributed.tensor`` no DTensor can exist, so an unsharded path
    never pays that import (seconds on the card's host)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


@contextlib.contextmanager
def activation_sharding(mesh, plan, *, row_axes: Optional[Sequence[str]] = None,
                        rows: Optional[int] = None, tensor_parallel: bool = False,
                        device_mesh: Any = None, shard_grads: bool = True,
                        grad_dtype: Optional[torch.dtype] = None, seq_local: bool = False):
    """Enter ``(mesh, plan)`` for the model's `constrain` calls.
    ``row_axes``: the mesh axes this step splits the batch rows over (none
    by default: every rank holds every row). ``rows``: the global row count
    of each (micro)batch the step runs, which DTensor's chunk rule cuts over
    those axes (trailing ranks may hold fewer rows, or none); None when the
    rows split evenly. ``tensor_parallel``: the step computes on the
    tensor axis's shards (`tp`), a serving or a train step. ``device_mesh``:
    the ``DeviceMesh`` whose groups the step's own collectives use (the
    mesh's untagged one by default; PREPARE passes its own).
    ``shard_grads`` and ``grad_dtype``: how a train step's layer gathers
    return their gradients (`gather_shard`). ``seq_local``: the step keeps
    the K/V cache on the sequence shards of the plan's ``seq_axis``
    (`seq_axes`; a decode step)."""
    _stack().append(_Frame(mesh, plan, tuple(row_axes or ()), rows, tensor_parallel,
                           device_mesh, shard_grads, grad_dtype, seq_local))
    try:
        yield
    finally:
        _stack().pop()


def current() -> Optional[Tuple[Any, Any]]:
    """The innermost ``(mesh, plan)``, or None outside any context."""
    s = _stack()
    return (s[-1].mesh, s[-1].plan) if s else None


def _resolve(plan: Any, logical: Optional[str]):
    if logical is None:
        return None
    if logical == "batch":
        return plan.batch_axes
    if logical == "tp":
        return plan.tp_axis
    if logical == "ep":
        return plan.ep_axis
    if logical == "seq":
        return plan.seq_axis
    if logical == "sp":   # sequence-parallel residual stream (train)
        return plan.tp_axis if getattr(plan, "sequence_parallel", False) else None
    raise ValueError(f"unknown logical axis {logical!r}")


def constrain(x: torch.Tensor, *logical_dims: Optional[str]) -> torch.Tensor:
    """Pin ``x``'s layout by logical dim names, e.g. ``constrain(x, "batch",
    None, None)``: the identity outside a context; inside one, a DTensor is
    redistributed to the resolved placements unless a dim does not divide
    by its axes' extent (the reference skips those too); a plain tensor, a
    rank's own rows, is returned as it is.

    Raises:
        ValueError: ``logical_dims`` does not name each of ``x``'s dims, or
            names an unknown logical axis.
    """
    ctx = current()
    if ctx is None:
        return x
    mesh, plan = ctx
    if len(logical_dims) != x.dim():
        raise ValueError(f"constrain: {logical_dims} for a tensor of shape {tuple(x.shape)}")
    from repro_torch.sharding.plan import PartitionSpec, leaf_sharding
    spec = PartitionSpec(*[_resolve(plan, d) for d in logical_dims])
    extent = mesh.shape
    for d, size in enumerate(x.shape):
        n = math.prod(extent.get(a, 1) for a in spec.axes(d))
        if n > 1 and size % n:
            return x
    if not is_dtensor(x):
        return x
    sh = leaf_sharding(mesh, spec)
    return x.redistribute(sh.mesh, sh.placements)


# ---------------------------------------------------------------------------
# rows split over the batch axes
# ---------------------------------------------------------------------------


def _row_context():
    s = _stack()
    return (s[-1].mesh, s[-1].row_axes) if s else (None, ())


def row_shards() -> int:
    """How many ways the current step splits its batch rows (1 outside a
    context)."""
    mesh, axes = _row_context()
    return math.prod(mesh.shape[a] for a in axes) if axes else 1


def global_rows() -> Optional[int]:
    """The global row count of the current step's (micro)batches, where it
    was given (`activation_sharding`); None otherwise."""
    s = _stack()
    return s[-1].rows if s else None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the current step's batch rows
    (a new tensor, outside autograd); ``x`` itself outside a context or
    when no axis splits the rows."""
    mesh, axes = _row_context()
    if row_shards() == 1:
        return x
    import torch.distributed as dist
    dm = mesh.device_mesh()
    out = x.detach().clone()
    for a in axes:
        dist.all_reduce(out, group=dm.get_group(a))
    return out


# ---------------------------------------------------------------------------
# the tensor axis of a serving or train step
# ---------------------------------------------------------------------------


def _tp_context():
    """``(DeviceMesh, mesh dim of the tensor axis, its extent)`` of the
    current tensor-parallel context, or None where no axis splits the work:
    outside a context, without ``tensor_parallel``, a plan without a tensor
    axis, a mesh of devices rather than ranks, an axis of one rank, or a
    rank outside the mesh."""
    s = _stack()
    if not s or not s[-1].tensor_parallel:
        return None
    mesh, plan = s[-1].mesh, s[-1].plan
    ax = getattr(plan, "tp_axis", None)
    if ax is None or mesh.ranks is None or mesh.shape.get(ax, 1) == 1:
        return None
    dm = s[-1].device_mesh if s[-1].device_mesh is not None else mesh.device_mesh()
    if dm.get_coordinate() is None:
        return None
    return dm, mesh.axis_names.index(ax), mesh.shape[ax]


def tp() -> Tuple[int, int]:
    """``(extent, this rank's coordinate)`` of the tensor axis the current
    step splits its work over; ``(1, 0)`` where none does."""
    c = _tp_context()
    if c is None:
        return 1, 0
    dm, k, n = c
    return n, dm.get_coordinate()[k]


def tp_axis() -> Optional[str]:
    """The tensor axis's name where it splits the current step, else None."""
    c = _tp_context()
    return None if c is None else c[0].mesh_dim_names[c[1]]


def _tp_group_name() -> str:
    dm, k, _ = _tp_context()
    return dm.get_group(k).group_name


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the tensor axis (an all-reduce; every rank gets
    the same sum); ``x`` itself where no tensor axis splits the step."""
    n, _ = tp()
    if n == 1:
        return x
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(x.contiguous(), "sum", _tp_group_name()))


def tp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every tensor-axis rank's ``x`` put together along ``dim``, in rank
    order (an all-gather); ``x`` itself where no tensor axis splits the
    step."""
    n, _ = tp()
    if n == 1:
        return x
    ops = torch.ops._c10d_functional
    y = x.movedim(dim, 0).contiguous()
    out = ops.wait_tensor(ops.all_gather_into_tensor(y, n, _tp_group_name()))
    return out.movedim(0, dim)


def tp_argmax(x: torch.Tensor, offset: int) -> torch.Tensor:
    """The argmax of each row of the whole ``(R, V)`` matrix whose columns
    ``[offset, offset + x.shape[1])`` this rank holds in ``x``: each rank's
    first maximum is exchanged over the tensor axis, and the lowest global
    index among the maxima wins, which is ``torch.argmax`` of the whole row
    (its first maximal value). Returns ``(R,)`` int64 global indices, the
    same on every rank of the axis."""
    local = torch.argmax(x, dim=-1)
    n, _ = tp()
    if n == 1:
        return local + offset
    val = x.gather(-1, local[:, None])[:, 0].double()
    mine = torch.stack([val, (local + offset).double()], dim=-1)      # (R, 2)
    every = tp_gather(mine[None], 0)                                  # (n, R, 2)
    vals, idx = every[..., 0], every[..., 1]
    best = vals.max(dim=0).values
    cand = torch.where(vals == best[None], idx, torch.full_like(idx, float("inf")))
    return cand.min(dim=0).values.long()


def tp_reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` summed over the tensor axis, this rank's chunk of dim ``dim``
    (a reduce-scatter); ``x`` itself where no tensor axis splits the
    step."""
    n, _ = tp()
    if n == 1:
        return x
    ops = torch.ops._c10d_functional
    y = x.movedim(dim, 0).contiguous()
    out = ops.wait_tensor(ops.reduce_scatter_tensor(y, "sum", n, _tp_group_name()))
    return out.movedim(0, dim)


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the tensor axis (an all-reduce
    with MAX, outside autograd: callers take no gradient through it)."""
    n, _ = tp()
    if n == 1:
        return x
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(x.detach().contiguous(), "max", _tp_group_name()))


# ---------------------------------------------------------------------------
# the sequence axes of a decode step
# ---------------------------------------------------------------------------


def _seq_context():
    """``(DeviceMesh, the mesh dims of the sequence axes)`` of the current
    step where it keeps the K/V cache's sequence local, or None: outside a
    context, without ``seq_local``, a plan without ``seq_axis``, a mesh of
    devices rather than ranks, axes of one rank, or a rank outside the
    mesh."""
    s = _stack()
    if not s or not s[-1].seq_local:
        return None
    mesh, plan = s[-1].mesh, s[-1].plan
    axes = getattr(plan, "seq_axis", None)
    if axes is None or mesh.ranks is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    dims = tuple(k for k, a in enumerate(mesh.axis_names) if a in axes and mesh.shape[a] > 1)
    if not dims:
        return None
    dm = s[-1].device_mesh if s[-1].device_mesh is not None else mesh.device_mesh()
    if dm.get_coordinate() is None:
        return None
    return dm, dims


def seq_axes() -> Tuple[str, ...]:
    """The mesh axes whose ranks each hold a piece of the K/V cache's
    sequence in the current step (the plan's ``seq_axis``, in mesh order,
    those of more than one rank), where the step keeps that piece local
    (``seq_local``: `launch.steps.jit_decode_step`); ``()`` otherwise, and
    attention then reads the whole sequence."""
    c = _seq_context()
    return () if c is None else tuple(c[0].mesh_dim_names[k] for k in c[1])


def seq_piece() -> Tuple[int, int]:
    """``(pieces, index)``: how many pieces the sequence axes cut the
    sequence into, and which one this rank holds, by DTensor's chunk rule
    over several axes (the first axis major; `local_shape_and_offset`). A
    rank whose piece is ``n`` positions (the split is even: the builders
    refuse another) holds ``[index * n, (index + 1) * n)``. ``(1, 0)`` where
    no axis splits the sequence."""
    c = _seq_context()
    if c is None:
        return 1, 0
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.plan import LeafSharding, P
    dm, dims = c
    n = math.prod(dm.size(k) for k in dims)
    placements = tuple(Shard(0) if k in dims else Replicate() for k in range(dm.ndim))
    _, offset = local_shape_and_offset((n,), LeafSharding(dm, placements, P()))
    return n, offset[0]


# A decode step has no backward (it runs under ``torch.no_grad()``), so the
# two reductions of the softmax over the sequence need no autograd rule.


def _seq_all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    dm, dims = _seq_context()
    ops = torch.ops._c10d_functional
    out = x.contiguous()
    for k in dims:          # one all-reduce over each axis: its own wire bytes
        out = ops.wait_tensor(ops.all_reduce(out, op, dm.get_group(k).group_name))
    return out


def seq_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the sequence axes (a MAX
    all-reduce over each in turn); ``x`` itself where none splits the
    sequence."""
    return x if _seq_context() is None else _seq_all_reduce(x, "max")


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the sequence axes (a SUM all-reduce over each in
    turn); ``x`` itself where none splits the sequence."""
    return x if _seq_context() is None else _seq_all_reduce(x, "sum")


def _piece(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of dim ``dim`` of ``x`` over the tensor axis."""
    n, r = tp()
    w = x.shape[dim] // n
    return x.narrow(dim, r * w, w)


# The autograd rules of a tensor-parallel step. Each Function's forward and
# backward call the primitives above (`tp_sum`, `tp_gather`,
# `tp_reduce_scatter`, `tp`), which read the step's context, so a backward
# runs on the thread of its forward, inside the context (`launch.steps`
# turns autograd's device threads off for a sharded step).
#
# TRAP, two backwards for one all-reduce: a sum whose result feeds
# replicated computation (a residual add, the vocab-parallel log-sum-exp,
# the gold logit) has an identity backward, since every rank then holds the
# whole gradient of the sum; a sum whose result each rank's own shard reads
# back (the SSM gated norm's variance) has an all-reduce backward, since
# each rank holds only its shard's part of that gradient. Swapping them
# multiplies a gradient by the axis extent, or drops the other ranks' part.


class _Enter(torch.autograd.Function):
    """A replicated tensor entering a shard's computation: identity forward;
    backward, the shards' partial gradients summed (all-reduce)."""

    @staticmethod
    def forward(fctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return tp_sum(g)


class _Reduce(torch.autograd.Function):
    """A shard's partial result summed for replicated computation:
    all-reduce forward; identity backward (every rank holds the whole
    gradient of the sum, which is each partial's)."""

    @staticmethod
    def forward(fctx, x):
        return tp_sum(x)

    @staticmethod
    def backward(fctx, g):
        return g


class _ShardSum(torch.autograd.Function):
    """A sum each rank's own shard reads back: all-reduce both ways (each
    rank's gradient of the sum is its shard's part alone)."""

    @staticmethod
    def forward(fctx, x):
        return tp_sum(x)

    @staticmethod
    def backward(fctx, g):
        return tp_sum(g)


class _SPGather(torch.autograd.Function):
    """The residual stream's sequence made whole for a sub-layer: all-gather
    forward. The whole sequence feeds replicated computation (the
    sub-layer's norm), so every rank holds its whole gradient alike, and the
    backward keeps this rank's piece (a reduce-scatter would multiply it by
    the axis extent)."""

    @staticmethod
    def forward(fctx, x, dim):
        fctx.dim = dim
        return tp_gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        return _piece(g, fctx.dim), None


class _SPEnter(torch.autograd.Function):
    """A normed piece of the sequence made whole as the input of a
    sub-layer's shards: all-gather forward. Each rank's shard reads the
    whole sequence and holds its own partial gradient of it, so the
    backward sums the partials into this rank's piece (reduce-scatter):
    `_SPGather`'s forward and `_Enter`'s sum in one collective, at half an
    all-reduce's wire bytes."""

    @staticmethod
    def forward(fctx, x, dim):
        fctx.dim = dim
        return tp_gather(x, dim)

    @staticmethod
    def backward(fctx, g):
        return tp_reduce_scatter(g, fctx.dim), None


class _Once(torch.autograd.Function):
    """A tensor that has entered the shards (`_SPEnter`, `_Enter`) read by
    a branch every rank computes whole and alike: identity forward. Every
    rank then holds the branch's whole gradient, which the entry's sum
    would count once a rank, so the backward keeps it on the axis's first
    rank and gives zero on the others (exact: the sum adds zeros)."""

    @staticmethod
    def forward(fctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return g if tp()[1] == 0 else torch.zeros_like(g)


class _SPScatter(torch.autograd.Function):
    """A shard's partial output summed into this rank's piece of the
    sequence: reduce-scatter forward, all-gather backward."""

    @staticmethod
    def forward(fctx, x, dim):
        fctx.dim = dim
        return tp_reduce_scatter(x, dim)

    @staticmethod
    def backward(fctx, g):
        return tp_gather(g, fctx.dim), None


class _SPCut(torch.autograd.Function):
    """A replicated tensor cut to this rank's piece of the sequence: cut
    forward, all-gather backward (the replicated producer takes the whole
    gradient)."""

    @staticmethod
    def forward(fctx, x, dim):
        fctx.dim = dim
        return _piece(x, dim).clone()

    @staticmethod
    def backward(fctx, g):
        return tp_gather(g, fctx.dim), None


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the tensor axis, as the input of a shard's
    computation (identity; its gradient summed over the axis); ``x`` itself
    where no tensor axis splits the step."""
    return x if tp()[0] == 1 else _Enter.apply(x)


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """A shard's partial ``x`` summed over the tensor axis for replicated
    computation: `tp_sum` with an identity backward."""
    return x if tp()[0] == 1 else _Reduce.apply(x)


def tp_sum_shard(x: torch.Tensor) -> torch.Tensor:
    """A shard's partial ``x`` summed over the tensor axis where each rank's
    own shard reads the sum: `tp_sum` with an all-reduce backward."""
    return x if tp()[0] == 1 else _ShardSum.apply(x)


def sp_on(seq_len: int) -> bool:
    """Whether the current step runs its residual stream sequence-parallel:
    a train step whose plan says so, over a tensor axis of more than one
    rank that divides ``seq_len`` (otherwise it runs whole, as `constrain`
    skips a constraint that does not divide)."""
    n, _ = tp()
    c = current()
    return (n > 1 and c is not None and getattr(c[1], "sequence_parallel", False)
            and seq_len % n == 0)


def sp_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's piece of the sequence (dim ``dim``) put together for a
    sub-layer every rank computes whole and alike (`_SPGather`)."""
    return _SPGather.apply(x, dim)


def sp_enter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's normed piece of the sequence (dim ``dim``) put together
    as the input of a sub-layer's shards, its gradient the shards' parts
    summed into the piece (`_SPEnter`). The sub-layer then enters it no
    more (`tp_branch`)."""
    return _SPEnter.apply(x, dim)


def tp_once(x: torch.Tensor) -> torch.Tensor:
    """``x``, which has entered the tensor axis's shards already, as the
    input of a branch every rank computes whole (`_Once`: its gradient
    counted on the axis's first rank alone); ``x`` itself where no tensor
    axis splits the step."""
    return x if tp()[0] == 1 else _Once.apply(x)


def tp_branch(x: torch.Tensor, shard: bool, entered: bool) -> torch.Tensor:
    """``x``, replicated over the tensor axis, as one branch of a
    sub-layer reads it: a branch on this rank's shard (``shard``) takes
    its partial gradient, one every rank computes whole takes the whole.
    Where ``x`` has not entered the shards, a shard's branch enters it here
    (`tp_enter`) and a whole branch reads it as it is; where it has
    (``entered``: `sp_enter` sums its gradient after), a shard's branch
    reads it as it is and a whole branch counts its gradient once
    (`tp_once`)."""
    if entered:
        return x if shard else tp_once(x)
    return tp_enter(x) if shard else x


def sp_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A partial output over the whole sequence summed over the tensor
    axis into this rank's piece of dim ``dim`` (`_SPScatter`)."""
    return _SPScatter.apply(x, dim)


def sp_cut(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A replicated ``x`` cut to this rank's piece of dim ``dim``
    (`_SPCut`)."""
    return _SPCut.apply(x, dim)


# ---------------------------------------------------------------------------
# the FSDP axes of a train step, a layer at a time
# ---------------------------------------------------------------------------


class GatherPlan(NamedTuple):
    """How `gather_shard` makes one leaf's shard what the model computes on.
    ``steps``: ``(group name, extent, coordinate, tensor dim, backward)``
    for each mesh dim whose shards it gathers, in mesh order (the first
    axis major); backward "rs" (reduce-scatter: the ranks' gradients are
    partial sums, their rows differ), "ar" (all-reduce, then this rank's
    chunk: the same sum, without ``shard_grads``) or "cut" (this rank's
    chunk: every rank of that axis holds the same gradient). ``sums``: the
    groups of the mesh dims that replicate the leaf but split the rows,
    whose gradients are summed over them (all-reduce). ``cast``: the dtype
    the gradient is reduced in."""

    steps: Tuple[Tuple[str, int, int, int, str], ...]
    sums: Tuple[str, ...]
    cast: Optional[torch.dtype]


def gather_plan(v: Any, keep: Optional[str], *, stacked: bool,
                summed: Optional[str] = None) -> Optional[GatherPlan]:
    """The `GatherPlan` of DTensor leaf ``v`` in the current train step:
    gather every mesh dim that shards it but ``keep`` (the tensor axis,
    where the leaf's group runs on its shard), its layer dim dropped when
    ``stacked``; None for a plain tensor, or where nothing moves.
    ``summed``: a mesh axis whose ranks each compute a different part of
    the gathered leaf's gradient, which is summed over it as over the axes
    that split the rows (TRAP, a padded leaf: the tensor axis, each rank's
    gradient non-zero on its own head slots alone, `slot_cut`; cutting it
    would keep one rank's part of the chunk)."""
    if not is_dtensor(v):
        return None
    from torch.distributed.tensor import Shard
    s = _stack()
    rows = set(s[-1].row_axes) if s else set()
    if summed is not None:
        rows.add(summed)
    shard_grads = s[-1].shard_grads if s else True
    cast = s[-1].grad_dtype if s else None
    dm = v.device_mesh
    coord = dm.get_coordinate()
    steps, sums = [], []
    shift = 1 if stacked else 0
    for k, (name, p) in enumerate(zip(dm.mesh_dim_names, v.placements)):
        n = dm.size(k)
        if n == 1 or name == keep:
            continue
        group = dm.get_group(k).group_name
        if isinstance(p, Shard):
            back = ("rs" if shard_grads else "ar") if name in rows else "cut"
            steps.append((group, n, coord[k], p.dim - shift, back))
        elif name in rows:
            sums.append(group)
    if not steps and not sums and cast is None:
        return None
    return GatherPlan(tuple(steps), tuple(sums), cast)


def _all_gather(x: torch.Tensor, dim: int, n: int, group: str) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    y = x.movedim(dim, 0).contiguous()
    return ops.wait_tensor(ops.all_gather_into_tensor(y, n, group)).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, n: int, group: str) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    y = x.movedim(dim, 0).contiguous()
    return ops.wait_tensor(ops.reduce_scatter_tensor(y, "sum", n, group)).movedim(0, dim)


def _all_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(x.contiguous(), "sum", group))


class _GatherShard(torch.autograd.Function):
    """`gather_shard`'s rule. The gradient of the gathered tensor is cast,
    then each gathered mesh dim returns it to this rank's shard in mesh
    order (the first axis major, as DTensor's chunk rule nests shards), then
    the row-splitting mesh dims that replicate the leaf sum it."""

    @staticmethod
    def forward(fctx, x, plan):
        fctx.plan = plan
        out = x
        for group, n, _, dim, _ in reversed(plan.steps):
            out = _all_gather(out, dim, n, group)
        return out if plan.steps else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        plan = fctx.plan
        if plan.cast is not None:
            g = g.to(plan.cast)
        for group, n, coord, dim, back in plan.steps:
            if back == "rs":
                g = _reduce_scatter(g, dim, n, group)
                continue
            if back == "ar":
                g = _all_reduce(g, group)
            w = g.shape[dim] // n
            g = g.narrow(dim, coord * w, w)
        for group in plan.sums:
            g = _all_reduce(g, group)
        return g, None


def gather_shard(x: torch.Tensor, plan: Optional[GatherPlan]) -> torch.Tensor:
    """``x``, this rank's shard of a parameter (of one layer of a stacked
    leaf), as the train step computes on it (`gather_plan`): whole along
    every mesh dim but the kept one, its gradient returned to the shard
    summed over the ranks whose rows differ. ``x`` itself where ``plan`` is
    None. Every rank of the leaf's mesh calls this in the same order, and
    its backward issues the same collectives in the same order."""
    return x if plan is None else _GatherShard.apply(x, plan)


def _keep_local(local: torch.Tensor, v: Any, axis: str, *, drop_dim0: bool) -> torch.Tensor:
    """``local`` (this rank's shard of DTensor ``v``, its layer dim dropped
    when ``drop_dim0``) gathered over every mesh dim but ``axis``'s: the
    rank's plain shard of ``axis``, whole along every other dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = v.device_mesh
    k = dm.mesh_dim_names.index(axis)
    tdim = v.placements[k].dim
    shift = 1 if drop_dim0 else 0
    shape = list(v.shape[shift:])
    shape[tdim - shift] = v.shape[tdim] // dm.size(k)
    placements = [Replicate() if j == k else
                  (Shard(p.dim - shift) if isinstance(p, Shard) else p)
                  for j, p in enumerate(v.placements)]
    if all(not isinstance(p, Shard) for p in placements):
        return local
    part = DTensor.from_local(local, dm, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))
    return part.full_tensor()


def _splits_alone(v: Any, axis: Optional[str], *, skip_dim0: bool) -> bool:
    """Whether DTensor ``v`` shards one dim over ``axis`` (not its layer dim
    when ``skip_dim0``), evenly, and no other mesh dim shards that dim."""
    from torch.distributed.tensor import Shard
    dm = v.device_mesh
    if axis is None or axis not in dm.mesh_dim_names:
        return False
    k = dm.mesh_dim_names.index(axis)
    p = v.placements[k]
    if not isinstance(p, Shard) or (skip_dim0 and p.dim == 0):
        return False
    others = [q for j, q in enumerate(v.placements)
              if j != k and isinstance(q, Shard) and q.dim == p.dim]
    return not others and v.shape[p.dim] % dm.size(k) == 0


def layer_local(v: Any, i: int, axis: Optional[str]) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf as a plain tensor that keeps this
    rank's shard of mesh axis ``axis`` (the tensor or expert axis) and
    gathers every other axis's shards (the FSDP axes): `layer_slice` where
    the leaf does not shard a dim over ``axis`` alone and evenly."""
    if not is_dtensor(v) or not _splits_alone(v, axis, skip_dim0=True):
        return layer_slice(v, i)
    return _keep_local(v.to_local()[i], v, axis, drop_dim0=True)


def local_of(v: Any, axis: Optional[str]) -> torch.Tensor:
    """`layer_local` of an unstacked leaf: this rank's shard of ``axis``,
    whole along every other axis; the whole leaf where it does not shard a
    dim over ``axis`` alone and evenly."""
    if not is_dtensor(v) or not _splits_alone(v, axis, skip_dim0=False):
        return full(v)
    return _keep_local(v.to_local(), v, axis, drop_dim0=False)


class SlotCut(NamedTuple):
    """One leaf of a padded head group (`lm.tp_groups`): the dim of one
    layer's leaf that holds the heads, each head's width along it, and the
    real head count ``H``."""

    dim: int
    width: int
    heads: int


def head_slots(heads: int) -> Tuple[int, int]:
    """``(k, first)``: this rank's head slots when ``heads`` are padded over
    the tensor axis of extent ``n``, as the reference's compiler pads them:
    ``H_pad = ceil(H / n) * n``, ``k = H_pad / n`` slots a rank, rank ``r``
    holding ``[r * k, (r + 1) * k)``; a slot ``>= H`` is padding. Heads that
    divide the axis give the rank its even shard."""
    n, r = tp()
    k = -(-heads // n)
    return k, r * k


def slot_cut(w: torch.Tensor, cut: SlotCut) -> torch.Tensor:
    """This rank's ``k`` head slots (`head_slots`) of ``w``, whole along
    ``cut.dim`` (``H`` heads of ``cut.width``): the real heads it holds,
    then zeros for its padding slots, so that a padding slot's q columns
    (or its out-projection rows) are zero and its part of the output is
    exactly 0. Differentiable: the gradient of the whole ``w`` is this
    rank's slots' part, zero elsewhere."""
    k, first = head_slots(cut.heads)
    lo, hi = min(first, cut.heads), min(first + k, cut.heads)
    part = w.narrow(cut.dim, lo * cut.width, (hi - lo) * cut.width)
    if hi - lo == k:
        return part
    shape = list(w.shape)
    shape[cut.dim] = (k - (hi - lo)) * cut.width
    return torch.cat([part, w.new_zeros(shape)], dim=cut.dim)


#: the states of a tensor-parallel group (`lm.tp_groups`): on this rank's
#: even shard, on its padded head slots, or gathered whole
LOCAL, PADDED, GATHERED = "local", "padded", "gathered"


def note_tp(name: str, state: str) -> None:
    """Count one sub-layer ``name`` of a tensor-parallel step as run in
    ``state`` (`LOCAL`, `PADDED` or `GATHERED`): ``"<name>:<state>"`` and
    the total ``"tp_<state>"`` in `tp_counts`; nothing where no tensor axis
    splits the step."""
    if tp()[0] == 1:
        return
    c = _live_counts()
    for key in (f"{name}:{state}", f"tp_{state}"):
        c[key] = c.get(key, 0) + 1


def note_seq(name: str) -> None:
    """Count one attention sub-layer ``name`` of a decode step as run over
    this rank's piece of the cache's sequence (``"<name>:seq_local"`` in
    `tp_counts`; the totals ``tp_local`` / ``tp_padded`` /
    ``tp_gathered`` do not take it)."""
    c = _live_counts()
    key = f"{name}:seq_local"
    c[key] = c.get(key, 0) + 1


def _live_counts() -> dict:
    """This thread's running counts of `note_tp` (``"<name>:local"``,
    ``"<name>:padded"``, ``"<name>:gathered"``, and the totals
    ``"tp_local"`` / ``"tp_padded"`` / ``"tp_gathered"``), the dict
    itself."""
    if not hasattr(_STATE, "tp_counts"):
        _STATE.tp_counts = {}
    return _STATE.tp_counts


def tp_counts() -> dict:
    """A copy of this thread's `note_tp` counts."""
    return dict(_live_counts())


def reset_tp_counts() -> None:
    _live_counts().clear()


def local_shard(x: Any) -> torch.Tensor:
    """A DTensor's own shard (its storage); a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full(x: Any) -> Any:
    """A DTensor gathered to a plain tensor on every rank; anything else as
    it is."""
    return x.full_tensor() if is_dtensor(x) else x


def full_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return full(tree)


def layer_slice(v: Any, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf as a plain tensor. A DTensor (its layer
    dim never sharded) gathers that layer's shards alone."""
    if not is_dtensor(v):
        return v[i]
    from torch.distributed.tensor import DTensor, Shard
    if any(isinstance(p, Shard) and p.dim == 0 for p in v.placements):
        return v.full_tensor()[i]
    placements = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in v.placements]
    shape = v.shape[1:]
    part = DTensor.from_local(v.to_local()[i], v.device_mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))
    return part.full_tensor()


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_shape_and_offset(shape, sharding) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of an array of ``shape`` under ``sharding`` (a
    `LeafSharding`): its local shape and its offset in the global array,
    by DTensor's chunk rule (each mesh dim in order cuts the dim its
    ``Shard`` names into ``ceil(n / size)``-row chunks; a trailing rank may
    hold fewer rows, or none). Pure arithmetic on the mesh's coordinate, so
    it also runs under a fake tensor mode. A rank outside the mesh holds
    ``(0, ...)``."""
    from torch.distributed.tensor import Shard
    coord = sharding.mesh.get_coordinate()
    if coord is None:
        return (0,) * len(shape), (0,) * len(shape)
    local, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n = sharding.mesh.size(i)
            chunk = -(-local[p.dim] // n)
            lo = min(local[p.dim], chunk * coord[i])
            hi = min(local[p.dim], chunk * (coord[i] + 1))
            local[p.dim], offset[p.dim] = hi - lo, offset[p.dim] + lo
    return tuple(local), tuple(offset)


def local_range(shape, sharding, *, dim: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` of dim ``dim`` this rank holds of an array of
    ``shape`` under ``sharding`` (a `LeafSharding`); ``(0, 0)`` on a rank
    outside its mesh."""
    local, offset = local_shape_and_offset(shape, sharding)
    return offset[dim], offset[dim] + local[dim]


def to_dtensor(local: torch.Tensor, sharding, shape) -> Any:
    """A DTensor of global ``shape`` under ``sharding`` from this rank's
    shard ``local`` (no communication)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def place(x: torch.Tensor, sharding) -> Any:
    """``x`` as a DTensor under ``sharding``: a DTensor is redistributed
    (nothing moves when it is placed so already); a plain tensor, the same
    full value on every rank, is cut to this rank's shard, a view of ``x``
    where the shard is contiguous (then the DTensor shares ``x``'s storage:
    on one rank, all of it)."""
    if is_dtensor(x):
        if x.device_mesh == sharding.mesh and tuple(x.placements) == tuple(sharding.placements):
            return x
        return x.redistribute(sharding.mesh, list(sharding.placements))
    if sharding.mesh.get_coordinate() is None:
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, sharding.mesh, list(sharding.placements), src_data_rank=None)
    local, offset = local_shape_and_offset(tuple(x.shape), sharding)
    view = x[tuple(slice(o, o + n) for o, n in zip(offset, local))]
    return to_dtensor(view.contiguous(), sharding, x.shape)


def place_tree(tree: Any, shardings: Any) -> Any:
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings)


def row_placements(placements, dim: int, keep: Sequence[int] = ()) -> Tuple[Any, ...]:
    """Only the placements that shard dim ``dim`` (the batch), and those of
    the mesh dims in ``keep``, the rest replicated: the layout a rank's own
    rows have (with its own shard of the kept mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and (p.dim == dim or j in keep) else Replicate()
                 for j, p in enumerate(placements))


def _mesh_dims(dm, axes: Sequence[str]) -> Tuple[int, ...]:
    return tuple(dm.mesh_dim_names.index(a) for a in axes if a in dm.mesh_dim_names)


def local_rows(x: Any, dim: int, keep: Sequence[str] = ()) -> torch.Tensor:
    """This rank's batch rows of DTensor ``x`` (batch on dim ``dim``), with
    every other dim whole but those the mesh axes in ``keep`` shard, which
    stay this rank's shard: what the rank computes on. A plain tensor is
    returned as it is."""
    if not is_dtensor(x):
        return x
    rows = row_placements(x.placements, dim, _mesh_dims(x.device_mesh, keep))
    if tuple(x.placements) != rows:
        x = x.redistribute(x.device_mesh, list(rows))
    return x.to_local()


def full_shape(shape, sharding, keep: Sequence[str] = ()) -> Tuple[int, ...]:
    """The global shape of an array under ``sharding`` (a `LeafSharding`)
    of which a rank holds ``shape``, every dim whole but those the mesh
    axes in ``keep`` shard (evenly), which are its shard: those dims times
    their axis's extent."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for j in _mesh_dims(sharding.mesh, keep):
        p = sharding.placements[j]
        if isinstance(p, Shard):
            out[p.dim] *= sharding.mesh.size(j)
    return tuple(out)


def from_rows(local: torch.Tensor, sharding, shape, dim: int, keep: Sequence[str] = ()) -> Any:
    """A DTensor under ``sharding`` from each rank's rows ``local`` (batch
    on dim ``dim``, every other dim whole but those the mesh axes in
    ``keep`` shard, already this rank's shard): shards of other dims are
    cut locally, no data moves."""
    from repro_torch.sharding.plan import LeafSharding
    rows = LeafSharding(sharding.mesh,
                        row_placements(sharding.placements, dim,
                                       _mesh_dims(sharding.mesh, keep)), sharding.spec)
    x = to_dtensor(local, rows, shape)
    if rows.placements != tuple(sharding.placements):
        x = x.redistribute(sharding.mesh, list(sharding.placements))
    return x


# ---------------------------------------------------------------------------
# moving between meshes, and the rows of a sharded pool
# ---------------------------------------------------------------------------


def mesh_ranks(dm) -> Tuple[int, ...]:
    """The global ranks of ``DeviceMesh`` ``dm``, row-major."""
    return tuple(int(r) for r in dm.mesh.reshape(-1).tolist())


def world_ranks() -> Tuple[int, ...]:
    import torch.distributed as dist
    return tuple(range(dist.get_world_size()))


def relay(x: Optional[torch.Tensor], holders: Sequence[int], needers: Sequence[int], *,
          shape, dtype: torch.dtype, device: torch.device) -> Optional[torch.Tensor]:
    """A tensor held whole on every rank of ``holders`` made whole on every
    rank of ``needers``: each needer that does not hold it receives it from
    one holder (the ``i``-th such needer from ``holders[i % n]``) by a
    point-to-point send, so it reaches no rank outside the two sets. Every
    rank of the world calls this with the same sets; a rank in neither gets
    ``x`` back as it is (None).

    Raises:
        ValueError: a needer lacks it and nobody holds it.
    """
    import torch.distributed as dist
    missing = [r for r in needers if r not in holders]
    if not missing:
        return x
    if not holders:
        raise ValueError(f"ranks {missing} need a tensor that no rank holds")
    me = dist.get_rank()
    for i, r in enumerate(missing):
        src = holders[i % len(holders)]
        if me == src:
            dist.send(x.contiguous(), dst=r)
        elif me == r:
            x = torch.empty(tuple(shape), dtype=dtype, device=device)
            dist.recv(x, src=src)
    return x


def relay_object(obj: Any, holders: Sequence[int], needers: Sequence[int]) -> Any:
    """`relay` of a picklable object (point to point, to the needers that
    do not hold it)."""
    import torch.distributed as dist
    missing = [r for r in needers if r not in holders]
    if not missing:
        return obj
    me = dist.get_rank()
    for i, r in enumerate(missing):
        src = holders[i % len(holders)]
        box = [obj]
        if me == src:
            dist.send_object_list(box, dst=r)
        elif me == r:
            dist.recv_object_list(box, src=src)
            obj = box[0]
    return obj


def empty_on(sharding, shape, dtype: torch.dtype, device: torch.device) -> Any:
    """A DTensor of global ``shape`` under ``sharding`` whose local shard is
    uninitialised memory (zero rows on a rank outside the mesh)."""
    local, _ = local_shape_and_offset(tuple(shape), sharding)
    return to_dtensor(torch.empty(local, dtype=dtype, device=device), sharding, shape)


def move(x: Any, dst: Any, *, holders: Optional[Sequence[int]] = None) -> Any:
    """``x`` laid out as ``dst``, between meshes of any rank counts: a
    `LeafSharding` gives a DTensor under it, a tuple of ranks a plain tensor
    whole on each of them (None on the other ranks).

    ``x`` is a DTensor, or a plain tensor whole on every rank of
    ``holders`` (every rank of the world by default; None elsewhere). A
    DTensor that stays on its mesh is redistributed; otherwise it is
    gathered whole on its mesh's ranks, sent to the target ranks that lack
    it (`relay`), and cut there (`place`), one leaf at a time, so the
    transient is one whole leaf. A rank outside the target mesh ends up
    holding no shard, and still takes part in the collectives of the ranks
    it shares a group with. Every rank of the world calls this, in the same
    order.
    """
    import torch.distributed as dist
    from repro_torch.sharding.plan import LeafSharding
    me = dist.get_rank()
    if is_dtensor(x):
        if isinstance(dst, LeafSharding) and x.device_mesh is dst.mesh:
            return place(x, dst)
        src = mesh_ranks(x.device_mesh)
        whole = x.full_tensor() if x.device_mesh.get_coordinate() is not None else None
        shape, dtype, device = tuple(x.shape), x.dtype, x.to_local().device
    else:
        src = tuple(holders) if holders is not None else world_ranks()
        whole = x if me in src else None
        shape, dtype, device = tuple(x.shape), x.dtype, x.device
    if isinstance(dst, LeafSharding):
        whole = relay(whole, src, mesh_ranks(dst.mesh), shape=shape, dtype=dtype, device=device)
        if dst.mesh.get_coordinate() is None:
            return empty_on(dst, shape, dtype, device)
        return place(whole, dst)
    whole = relay(whole, src, tuple(dst), shape=shape, dtype=dtype, device=device)
    return whole if me in tuple(dst) else None


def gather_index(x: Any, index: Sequence[int], dim: int) -> Optional[torch.Tensor]:
    """``x[index]`` along ``dim`` (every other dim whole) on every rank of
    DTensor ``x``'s mesh, exchanging only those rows: each rank writes the
    rows it holds (its part of the other dims) into a zero buffer, one rank
    of each replica set, and the buffer is summed over every mesh dim. The
    sum adds zeros to one value, so it is exact. None on a rank outside the
    mesh."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.plan import LeafSharding
    dm = x.device_mesh
    coord = dm.get_coordinate()
    if coord is None:
        return None
    local = x.to_local()
    shape = tuple(x.shape)
    lshape, off = local_shape_and_offset(shape, LeafSharding(dm, tuple(x.placements), None))
    idx = np.asarray(index, dtype=np.int64)
    out_shape = list(shape)
    out_shape[dim] = len(idx)
    buf = torch.zeros(out_shape, dtype=x.dtype, device=local.device)
    if all(c == 0 for c, p in zip(coord, x.placements) if not isinstance(p, Shard)):
        lo, n = off[dim], lshape[dim]
        mine = np.nonzero((idx >= lo) & (idx < lo + n))[0]
        if len(mine):
            region = [slice(o, o + k) for o, k in zip(off, lshape)]
            region[dim] = torch.as_tensor(mine, device=local.device)
            buf[tuple(region)] = local.index_select(
                dim, torch.as_tensor(idx[mine] - lo, device=local.device))
    for i in range(dm.ndim):
        if dm.size(i) > 1:
            dist.all_reduce(buf, group=dm.get_group(i))
    return buf


def rows_whole(local: torch.Tensor, dm, row_axes: Sequence[str], rows: int,
               dim: int = 0) -> torch.Tensor:
    """Every rank's rows (dim ``dim``, split over ``row_axes`` by the chunk
    rule, every other dim whole) put together on every rank of ``dm``: an
    all-gather over the row axes."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.plan import LeafSharding, P
    placements = tuple(Shard(dim) if a in row_axes else Replicate() for a in dm.mesh_dim_names)
    shape = list(local.shape)
    shape[dim] = rows
    return full(to_dtensor(local, LeafSharding(dm, placements, P()), tuple(shape)))


def my_rows(dm, row_axes: Sequence[str], rows: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` of ``rows`` this rank takes when they split over
    ``row_axes`` of ``dm`` by the chunk rule; ``(0, 0)`` outside the
    mesh."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.plan import LeafSharding, P
    placements = tuple(Shard(0) if a in row_axes else Replicate() for a in dm.mesh_dim_names)
    return local_range((rows,), LeafSharding(dm, placements, P()), dim=0)


def write_rows(x: Any, index: Sequence[int], values: torch.Tensor, dim: int) -> None:
    """Write ``values`` (``x``'s shape with ``dim`` cut to ``len(index)``,
    every other dim whole or already this rank's shard of it, as a
    tensor-parallel prefill leaves it) into DTensor ``x`` at ``index`` along
    ``dim``, IN PLACE: each rank writes the rows it holds, its part of the
    other dims; nothing moves between ranks."""
    import numpy as np
    from repro_torch.sharding.plan import LeafSharding
    dm = x.device_mesh
    if dm.get_coordinate() is None:
        return
    local = x.to_local()
    lshape, off = local_shape_and_offset(tuple(x.shape),
                                         LeafSharding(dm, tuple(x.placements), None))
    idx = np.asarray(index, dtype=np.int64)
    lo, n = off[dim], lshape[dim]
    mine = np.nonzero((idx >= lo) & (idx < lo + n))[0]
    if not len(mine):
        return
    src = [slice(o, o + k) if values.shape[d] == x.shape[d] else slice(0, k)
           for d, (o, k) in enumerate(zip(off, lshape))]
    src[dim] = torch.as_tensor(mine, device=values.device)
    dst = [slice(None)] * local.dim()
    dst[dim] = torch.as_tensor(idx[mine] - lo, device=local.device)
    local[tuple(dst)] = values[tuple(src)].to(local.dtype)
