"""Feed-forward layers: gated-SiLU / squared-ReLU / GELU MLPs and MoE.

The MoE keeps the reference's grouped, capacity-bucketed dense dispatch
(one-hot dispatch and combine einsums), so its results match token for
token. Prefill routes through the MoE top-k kernel; decode and training
keep the plain `router_topk`, as the reference does (training with the
Switch aux loss).

In a tensor-parallel step (`sharding.ctx.tp`), an MLP whose ``d_ff``
columns and rows are this rank's shard, and an MoE whose experts and shared
expert are, return this rank's partial output, which the layer sums over
the tensor axis once (`lm.tp_groups`). The router stays replicated:
routing, capacity and drops are the global ones. The replicated input and
routing weights enter the shards' computation through `ctx.tp_enter`. In a
sequence-parallel train step the input has entered already (``entered``:
`ctx.sp_enter`), and the branches every rank computes whole from it (the
router, a part gathered whole) count its gradient once (`ctx.tp_branch`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import top_k
from repro_torch.models.common import act_fn
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import batch_sum, constrain, global_rows, row_shards

# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------


def mlp_shapes(cfg: ModelConfig, d_ff: Optional[int] = None, lead: Tuple[int, ...] = ()
               ) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Per-layer ``{name: (shape, std)}``; std None is the fan-in rule."""
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    out_scale = ff ** -0.5 / math.sqrt(2 * cfg.num_layers)
    shapes = {"w_up": (lead + (d, ff), None),
              "w_down": (lead + (ff, d), out_scale)}
    if cfg.mlp_act == "silu":    # gated
        shapes["w_gate"] = (lead + (d, ff), None)
    return shapes


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, width: Optional[int] = None, *,
        entered: bool = False) -> torch.Tensor:
    """The MLP of ``x`` (``width`` columns, ``d_ff`` by default): this
    rank's partial output where ``p`` holds its shard of the columns (the
    replicated ``x`` then enters it, `ctx.tp_branch`; ``entered``: it has
    entered already)."""
    x = ctx.tp_branch(x, p["w_up"].shape[-1] < (width or cfg.d_ff), entered)
    act = act_fn(cfg.mlp_act)
    if cfg.mlp_act == "silu":
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


EXPERT_PAD_MULTIPLE = 16


def padded_experts(num_experts: int) -> int:
    m = EXPERT_PAD_MULTIPLE
    return (num_experts + m - 1) // m * m


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` (int64) as a compare against ``arange(n)``:
    the same values, without the range check that reads ``idx`` back to the
    host, and the same ops on every device and under a fake tensor mode (so
    a dry run counts what the card runs)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def switch_aux(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch load-balancing loss of ``(T, E)`` router probabilities and
    the ``(T, k)`` chosen ids (top-1 dispatch fraction times mean prob).

    When a sharded step splits the tokens over ranks (`ctx.row_shards`),
    the fraction and the token count are summed over them, and each rank
    returns its share, linear in its own probabilities: the shares sum to
    the loss over every token, and so do their gradients."""
    E = probs.shape[-1]
    one = one_hot(idx[:, 0], E).float()
    if row_shards() == 1:
        return E * torch.sum(one.mean(dim=0) * probs.mean(dim=0))
    n = batch_sum(torch.tensor(float(probs.shape[0]), device=probs.device))
    f = batch_sum(one.sum(dim=0)) / n
    return E * torch.sum(f * probs.sum(dim=0)) / n


def router_topk(m: MoEConfig, logits: torch.Tensor, *, want_aux: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Top-k routing of ``(T, E)`` logits. Returns (weights (T, k), expert
    ids (T, k), Switch load-balancing aux loss, or None unless
    ``want_aux``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = top_k(probs, m.top_k)
    if m.norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx, (switch_aux(probs, idx) if want_aux else None)


EXACT_SMALL_G = 512   # groups up to this size dispatch drop-free (cap = g)
GROUP_SIZE = 1024     # tokens per dispatch group


def _check_grouping(B: int, S: int) -> None:
    """A sharded step runs each rank's ``B`` rows of ``S`` tokens alone:
    its groups (and so its capacity and drops) are the global ones only if
    every token's group is drop-free (``rows S <= EXACT_SMALL_G`` over the
    global rows) or every rank's tokens start on a group boundary and fill
    whole groups (the rows are contiguous, cut by DTensor's chunk rule into
    ``ceil(rows / ranks)`` a rank, so the groups are then the same; a rank
    without rows holds no group).

    Raises:
        ValueError: neither holds.
    """
    n = row_shards()
    if n == 1:
        return
    rows = global_rows() or B * n
    chunk = -(-rows // n)
    if not (rows * S <= EXACT_SMALL_G
            or ((chunk * S) % GROUP_SIZE == 0 and (rows * S) % GROUP_SIZE == 0)):
        raise ValueError(
            f"MoE over {B * S} local tokens of {rows * S} ({chunk} rows a rank over {n}): "
            f"the local dispatch groups are not the global ones (neither drop-free nor "
            f"whole groups of {GROUP_SIZE})")


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *, kernel: bool,
            want_aux: bool = False, entered: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Grouped capacity-bucketed dense-dispatch MoE over ``x (B, S, d)``.
    Returns (out, aux_loss), the aux loss only if ``want_aux`` (training;
    serving never reads it), else None. ``kernel`` routes through
    `kops.moe_topk` (prefill); otherwise through the plain `router_topk`
    (decode, and training, which differentiates through it).

    Where the experts are this rank's shard of the tensor axis (fewer than
    ``E_pad`` in ``p["w_up"]``, `lm.tp_groups`), the dispatch keeps only
    theirs, and the output is this rank's partial sum, as is the shared
    expert's part where it is its shard. Where only one of the two parts is
    a shard, that part is summed over the axis here and the output is
    whole (`lm._note_layer`). ``entered``: ``x`` has entered the shards
    already (module notes)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    _check_grouping(B, S)
    E, k = m.num_experts, m.top_k
    E_pad = padded_experts(E)
    xt = x.reshape(T, d)

    # a rank without rows runs one empty group, so it joins the aux loss's
    # collectives as the others do
    g = max(min(GROUP_SIZE, T), 1)
    T_pad = (T + g - 1) // g * g
    if T_pad != T:
        xt = F.pad(xt, (0, 0, 0, T_pad - T))
    G = T_pad // g
    xg = xt.reshape(G, g, d)

    logits = (ctx.tp_branch(xg, False, entered).float() @ p["router"]).reshape(G * g, E)
    if kernel:
        weights, idx = kops.moe_topk(logits, k, norm_topk=m.norm_topk_prob)
        aux = switch_aux(torch.softmax(logits.float(), dim=-1), idx) if want_aux else None
    else:
        weights, idx, aux = router_topk(m, logits, want_aux=want_aux)
    weights = weights.reshape(G, g, k)
    idx = idx.long().reshape(G, g, k)

    # capacity per expert within a group
    if g <= EXACT_SMALL_G:
        cap = g                      # drop-free
    else:
        cap = min(max(1, int(math.ceil(g * k / E * m.capacity_factor))), g)

    # position of each (token, slot) within its per-group expert bucket
    e_one = one_hot(idx, E_pad)                                # (G, g, k, E_pad)
    flat = e_one.reshape(G, g * k, E_pad)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e.reshape(G, g, k, E_pad) * e_one).sum(dim=-1)   # (G, g, k)
    keep = pos < cap
    weights = weights * keep.to(weights.dtype)

    dt = xt.dtype
    disp = torch.einsum(
        "gske,gskc->gsec", e_one.to(dt),
        one_hot(torch.where(keep, pos, cap), cap + 1).to(dt)[..., :-1])
    wsum = (e_one.to(weights.dtype) * weights[..., None]).sum(dim=2)
    n_local = p["w_up"].shape[0]
    experts_local = n_local < E_pad
    # the replicated tokens and routing weights enter the experts' shard
    # (`ctx.tp_branch`; the router takes every rank's part of its
    # gradient), before the rank's slice of the experts
    xg = ctx.tp_branch(xg, experts_local, entered)
    if experts_local:               # this rank's experts [e0, e0 + n_local)
        e0 = ctx.tp()[1] * n_local
        disp = disp[:, :, e0:e0 + n_local]
        wsum = ctx.tp_enter(wsum)[:, :, e0:e0 + n_local]
    x_e = torch.einsum("gsec,gsd->gecd", disp, xg)            # (G, E_pad, cap, d)
    x_e = constrain(x_e, "batch", "ep", None, None)            # expert parallel

    act = act_fn(cfg.mlp_act)
    if cfg.mlp_act == "silu":
        h = act(torch.einsum("gecd,edf->gecf", x_e, p["w_gate"])) * torch.einsum(
            "gecd,edf->gecf", x_e, p["w_up"])
    else:
        h = act(torch.einsum("gecd,edf->gecf", x_e, p["w_up"]))
    y_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])      # (G, E_pad, cap, d)
    y_e = constrain(y_e, "batch", "ep", None, None)

    combine = disp * wsum[..., None]
    out = torch.einsum("gsec,gecd->gsd", combine.to(y_e.dtype), y_e)

    out = out.reshape(T_pad, d)[:T]
    if m.num_shared_experts:
        shared = mlp(cfg, p["shared"], xt[:T], width=m.d_shared, entered=entered)
        shared_local = p["shared"]["w_up"].shape[-1] < m.d_shared
        # TRAP, replicated leaves: where one part runs on its shard and the
        # other whole, the shard's part is summed here, and the layer adds
        # a whole output (every rank's leaves then take the whole gradient)
        if experts_local and not shared_local:
            out = ctx.tp_reduce(out)
        elif shared_local and not experts_local:
            shared = ctx.tp_reduce(shared)
        out = out + shared
    return out.reshape(B, S, d), aux
