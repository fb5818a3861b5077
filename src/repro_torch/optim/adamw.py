"""AdamW with global-norm clipping and optional reduced-precision state.

The state mirrors the parameter tree (``{"m", "v", "count"}``), as the
reference keeps it. `AdamW.update` works in place, leaf by leaf, in the
reference's order of operations: at full width the reference's functional
form (``g32, m32, v32, mhat, vhat, step, new_p`` for one stacked leaf) would
hold ~7 fp32 copies of a leaf at once; in place it holds two.

The leaves may be DTensors (a sharded train step, `launch.steps`): the
moments are made under the params' placements, each rank updates its own
shards, and the clipping norm is global: each leaf's squares are summed
over the mesh dims it is sharded on, and only those.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tree_util
from repro_torch.models.common import torch_dtype
from repro_torch.sharding.ctx import is_dtensor
from repro_torch.sharding.ctx import local_shard as _local  # a DTensor's own shard

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: Optional[str] = None   # None -> fp32; "bfloat16" halves memory

    def _sdtype(self) -> torch.dtype:
        return torch_dtype(self.state_dtype) if self.state_dtype else torch.float32

    def init(self, params: Tree) -> Tree:
        """Zeroed moments beside each parameter (on its device, or under
        its placements) and a step count, an int32 scalar on the first
        parameter's device (replicated over its mesh)."""
        sd = self._sdtype()

        def zeros(_, p):
            if is_dtensor(p):
                return torch.zeros_like(p, dtype=sd)
            return torch.zeros(p.shape, dtype=sd, device=p.device)

        first = tree_util.leaves(params)[0]
        if is_dtensor(first):
            from torch.distributed.tensor import Replicate, distribute_tensor
            mesh = first.device_mesh
            count = distribute_tensor(torch.zeros((), dtype=torch.int32, device=first.to_local().device),
                                      mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
        else:
            count = torch.zeros((), dtype=torch.int32, device=first.device)
        return {"m": tree_util.map_tree(zeros, params),
                "v": tree_util.map_tree(zeros, params),
                "count": count}

    @torch.no_grad()
    def update(self, grads: Tree, state: Tree, params: Tree) -> Tuple[Tree, Tree]:
        """One step. Updates ``params`` and ``state`` IN PLACE and returns
        them, as the reference's jitted train step donates both (its
        ``donate_argnums=(0, 1)``); ``grads`` are read only. Everything
        after the cast of a gradient is fp32; the count, the LR, the clip
        scale and the bias corrections stay on the device (no host sync)."""
        count = _local(state["count"])
        count.add_(1)
        lr = self.lr(count) if callable(self.lr) else self.lr

        flat_p = tree_util.leaves(params)
        flat_g = tree_util.leaves(grads)
        flat_m = tree_util.leaves(state["m"])
        flat_v = tree_util.leaves(state["v"])
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(_squares(flat_g)))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        flat_p, flat_g, flat_m, flat_v = ([_local(x) for x in xs]
                                          for xs in (flat_p, flat_g, flat_m, flat_v))

        b1, b2 = self.b1, self.b2
        cf = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, cf)
        bc2 = 1.0 - torch.pow(b2, cf)
        f32 = torch.float32
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g32 = g.to(f32, copy=True)
            if scale is not None:
                g32.mul_(scale)
            m32 = m if m.dtype == f32 else m.to(f32)
            v32 = v if v.dtype == f32 else v.to(f32)
            m32.mul_(b1).add_(g32, alpha=1 - b1)
            v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            if m32 is not m:
                m.copy_(m32)
                v.copy_(v32)
            # step = (m / bc1) * rsqrt(v / bc2 + eps^2), written over g32
            denom = torch.div(v32, bc2).add_(self.eps * self.eps).rsqrt_()
            g32.copy_(m32).div_(bc1).mul_(denom)
            del denom, m32, v32
            # decoupled weight decay (skip 1-D params: norms, biases)
            p32 = p if p.dtype == f32 else p.to(f32)
            if p.dim() > 1 and self.weight_decay:
                g32.add_(p32, alpha=self.weight_decay)
            p32.sub_(g32.mul_(lr))
            if p32 is not p:
                p.copy_(p32)
        return params, state


def _squares(flat_g: list) -> list:
    """Each gradient leaf's sum of squares over the whole leaf, in leaf
    order. A DTensor leaf sums its shard's, then over the mesh dims it is
    sharded on (one all-reduce per set of such dims), never over a dim
    that replicates it."""
    sq = [_local(g).float().square().sum() for g in flat_g]
    groups: Dict[tuple, list] = {}
    for i, g in enumerate(flat_g):
        if is_dtensor(g):
            from torch.distributed.tensor import Shard
            dims = tuple(d for d, p in enumerate(g.placements) if isinstance(p, Shard))
            if dims:
                groups.setdefault((g.device_mesh, dims), []).append(i)
    import torch.distributed as dist
    for (mesh, dims), idx in groups.items():
        vec = torch.stack([sq[i] for i in idx])
        for d in dims:
            dist.all_reduce(vec, group=mesh.get_group(d))
        for j, i in enumerate(idx):
            sq[i] = vec[j]
    return sq


def adamw(**kw) -> AdamW:
    return AdamW(**kw)
