"""The train step.

`make_train_step` is the reference's builder on one device. The reference's
``jit_*`` builders and ``named()`` place inputs and outputs under a sharding
plan and wait for sharding across devices; ``batch_struct``,
``decode_struct`` and ``param_struct`` serve the dry run and wait for it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.models import Model
from repro_torch.models.common import torch_dtype
from repro_torch.optim import AdamW

Tree = Dict[str, Any]


def _split_micro(batch: Dict[str, torch.Tensor], accum: int) -> List[Dict[str, torch.Tensor]]:
    """``accum`` microbatches of consecutive rows. ``positions`` carries the
    batch on axis 1 (the M-RoPE layout), everything else on axis 0.

    Raises:
        ValueError: ``accum`` does not divide a leaf's batch.
    """

    def one(key, x):
        ax = 1 if key == "positions" else 0
        if x.shape[ax] % accum:
            raise ValueError(f"{key}: batch {x.shape[ax]} is not a multiple of {accum}")
        new = x.shape[:ax] + (accum, x.shape[ax] // accum) + x.shape[ax + 1:]
        return x.reshape(new).movedim(ax, 0)

    split = {k: one(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(accum)]


def _loss_and_grads(model: Model, params: Tree, batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads in `tree.items` order) of one (micro)batch.
    The gradient is taken with respect to detached aliases of the
    parameters, so the parameters themselves never require grad."""
    leaves = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.train_loss(batch, params=tree_util.like(params, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, optimizer: AdamW, accum_steps: int = 1,
                    grad_reduce_dtype: Optional[str] = None):
    """``(params, opt_state, batch) -> (params, opt_state, loss, metrics)``.

    The loss and its gradients come from ``model.train_loss`` through the
    reference's plain ops (no kernel runs: none has a backward, as in the
    reference). ``params`` and ``opt_state`` are updated IN PLACE and
    returned, as the reference's jitted step donates both. The loss and the
    metrics stay on the device.

    ``accum_steps > 1`` accumulates the gradients of that many microbatches
    (`_split_micro`) and averages them and the loss; the metrics are the last
    microbatch's. ``grad_reduce_dtype`` casts the gradients, and the
    accumulator keeps that dtype (fp32 without it).
    """
    cast = torch_dtype(grad_reduce_dtype) if grad_reduce_dtype else None

    def train_step(params: Tree, opt_state: Tree, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, metrics, grads = _loss_and_grads(model, params, batch)
            if cast is not None:
                grads = [g.to(cast) for g in grads]
        else:
            acc_dtype = cast or torch.float32
            gsum, lsum = None, 0.0
            for mb in _split_micro(batch, accum_steps):
                loss, metrics, grads = _loss_and_grads(model, params, mb)
                if cast is not None:
                    grads = [g.to(cast) for g in grads]
                if gsum is None:
                    gsum = [g.to(acc_dtype, copy=True) for g in grads]
                else:
                    for a, g in zip(gsum, grads):
                        a.add_(g.to(acc_dtype))
                lsum = lsum + loss
                del grads
            grads = [g.div_(accum_steps) for g in gsum]
            loss = lsum / accum_steps
        optimizer.update(tree_util.like(params, grads), opt_state, params)
        return params, opt_state, loss, metrics

    return train_step
