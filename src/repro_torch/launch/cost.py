"""What one rank's step costs, counted as it runs: FLOPs and bytes,
collectives, kernel calls and live memory (the port's counterpart of the
reference's `core/hlo_cost.py` and `core/hlo_analysis.py`, for an eager
step instead of a compiled module).

`StepCost` is a dispatch mode over the step. On fake tensors (the dry run,
`launch.dryrun`) it counts a step that never runs; on real ones it counts
the same step as it runs, by the same rules, so a card run can hold the
dry run's prediction to the truth:

  * FLOPs and bytes by `planner.estimator._StepCount`'s conventions (the
    reference's HLO ones: a product ``2 x prod(result) x K``, every other
    op its result's elements but the free ones; bytes every operand and
    result of an op that is not a view); a kernel's custom op counts its
    FLOP formula (`kernels.ops`);
  * an op on DTensors is not counted itself: DTensor dispatches it to the
    local shards under this mode, and those ops count, so every count is
    the rank's own (an implicit redistribution's collectives included);
  * the sharding propagator's work on meta tensors, and metadata queries
    (``prim``), are not the step's and count nothing;
  * collectives (``_c10d_functional`` and ``c10d`` ops) are counted apart,
    by kind, with each rank's wire bytes by the reference's ring model
    (`repro.core.hlo_analysis.Collective.wire_bytes_per_device`), on the
    mesh axis their group spans; they add no FLOPs or bytes;
  * kernel calls: the ``repro_torch`` custom ops dispatched, by name;
  * live memory: every storage an op creates counts from then until it is
    freed; ``peak_transient`` is the most live at once over the step, and
    ``peak_tensors`` the largest storages live then (the op that made each,
    its shape, dtype and bytes; taken where the live bytes last rose by a
    percent, so within a percent of the peak). The step's inputs are its
    arguments (`argument_bytes`), live before it.

Rank 0 is counted: the fullest rank, since the sharded steps refuse a split
of rows that is not even (`launch.steps._check_rows`) and DTensor's chunk
rule gives the first ranks the larger shards.
"""
from __future__ import annotations

import itertools
import weakref
from collections import Counter
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.planner.estimator import _StepCount
from repro_torch.sharding.ctx import is_dtensor

#: collective ops by kind (the reference's HLO names), and the ones that
#: only wait for a result
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_WAITS = {"wait_tensor", "wait", "barrier"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "_c10d_functional_autograd")


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def wire_bytes(kind: str, operand_bytes: int, result_bytes: int, n: int) -> float:
    """Ring-model bytes each rank of a group of ``n`` moves over its links
    (the reference's `Collective.wire_bytes_per_device`)."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "reduce-scatter":
        return operand_bytes * frac
    if kind == "all-reduce":
        return 2.0 * operand_bytes * frac
    if kind == "all-to-all":
        return operand_bytes * frac
    return float(operand_bytes)


class StepCost(_StepCount):
    """Counts one rank's step (see the module's notes). ``mesh``: the
    `sharding.plan.Mesh` the step runs on, whose axes name each
    collective's group (a step without collectives needs none)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.kernel_calls: Counter = Counter()
        self.collectives: List[Dict[str, Any]] = []
        self.argument_bytes = 0
        self.live = 0
        self.peak_transient = 0
        self.peak_tensors: List[Dict[str, Any]] = []
        self._seen = WeakIdKeyDictionary()
        self._made: Dict[int, tuple] = {}       # live storage -> (bytes, op, shape, dtype)
        self._ids = itertools.count()
        self._snapped = 0
        self._groups = _group_axes(mesh) if mesh is not None else {}

    # -- arguments and live memory -----------------------------------------
    def add_arguments(self, tree: Any) -> int:
        """Count ``tree``'s tensors (a DTensor by its local shard) as the
        step's arguments: live before the step, not a transient. Returns
        their bytes (each storage once)."""
        added = 0
        for t in _tensors(tree):
            t = t.to_local() if is_dtensor(t) else t
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = None
                added += st.nbytes()
        self.argument_bytes += added
        return added

    def _track(self, outs: List[torch.Tensor], op: str = "?") -> None:
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = None
            self.live += n
            key = next(self._ids)
            self._made[key] = (n, op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            weakref.finalize(st, self._free, n, key)
            if self.live > self.peak_transient:
                self.peak_transient = self.live
                if self.live > 1.01 * self._snapped:
                    self._snap()

    def _snap(self, top: int = 5) -> None:
        self._snapped = self.live
        self.peak_tensors = [{"op": op, "shape": list(shape), "dtype": dtype, "bytes": n}
                             for n, op, shape, dtype in sorted(self._made.values(),
                                                               key=lambda m: -m[0])[:top]]

    def _free(self, n: int, key: int) -> None:
        self.live -= n
        self._made.pop(key, None)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "prim":                 # metadata (a fake tensor's ``.device``)
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(is_dtensor(t) for t in ins):
            return NotImplemented        # DTensor runs it on the shards, under this mode
        if any(t.device.type == "meta" for t in ins):
            return func(*args, **kwargs)
        if ns in _COLLECTIVE_NS:
            out = func(*args, **kwargs)
            self._collective(func, args, kwargs, ins, _tensors(out))
            self._track([t for t in _tensors(out) if t.device.type != "meta"], func._opname)
            return out
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if ns == "repro_torch":
            self.kernel_calls[func._opname] += 1
        self._track(_tensors(out), func._opname)
        return out

    def _collective(self, func, args, kwargs, ins, outs) -> None:
        name = func._opname
        if name in _WAITS:
            return
        kind = _KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"collective {func} has no ring model here")
        axis, n = self._group_of(args, kwargs)
        op_b, res_b = _nbytes(ins), _nbytes(outs)
        if func.namespace == "c10d" and not outs:
            res_b = op_b                 # in place: the result is the operand
        self.collectives.append({"kind": kind, "axis": axis, "n": n,
                                 "operand_bytes": op_b, "result_bytes": res_b,
                                 "wire_bytes": wire_bytes(kind, op_b, res_b, n)})

    def _group_of(self, args, kwargs) -> Tuple[str, int]:
        """The mesh axis a collective's group spans and its size, from the
        group's name (a functional collective's argument, or a c10d op's
        process group).

        Raises:
            NotImplementedError: the group is not one of the mesh's axes.
        """
        import torch.distributed as dist
        for a in list(args) + list(kwargs.values()):
            name = a
            if isinstance(a, torch.ScriptObject):   # a c10d op's group, or its ReduceOp
                try:
                    name = dist.ProcessGroup.unbox(a).group_name
                except RuntimeError:
                    continue
            if isinstance(name, str) and name in self._groups:
                return self._groups[name]
        raise NotImplementedError("a collective over a group that is not one axis of "
                                  "the step's mesh")

    # -- results -----------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        by_kind: Counter = Counter(c["kind"] for c in self.collectives)
        by_axis: Dict[str, float] = {}
        for c in self.collectives:
            by_axis[c["axis"]] = by_axis.get(c["axis"], 0.0) + c["wire_bytes"]
        return {"flops": self.flops, "bytes": self.bytes,
                "kernel_calls": dict(self.kernel_calls),
                "collectives": {"n": len(self.collectives), "by_kind": dict(by_kind),
                                "wire_bytes_by_axis": by_axis,
                                "wire_bytes_per_device": sum(by_axis.values())},
                "argument_bytes": self.argument_bytes,
                "peak_transient": self.peak_transient, "peak_tensors": self.peak_tensors}


def _group_axes(mesh) -> Dict[str, Tuple[str, int]]:
    """Group name -> (the mesh axis it spans, its size), for the group of
    each axis of ``mesh``'s `DeviceMesh` (DTensor, the sharded steps and
    AdamW issue every collective over one axis at a time)."""
    dm = mesh.device_mesh()
    return {dm.get_group(i).group_name: (name, dm.size(i))
            for i, name in enumerate(mesh.axis_names)}
