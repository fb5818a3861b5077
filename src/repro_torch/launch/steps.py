"""Step builders: the train step, and the reference's sharded builders.

`make_train_step` is the reference's builder: on one device without a
mesh, or data-parallel over a plan's batch axes with a mesh. `named`,
`jit_train_step`, `jit_prefill` and `jit_decode_step` keep the reference's
names and contract: params, AdamW state, batch, cache, logits and the loss
come in and go out as DTensors under the placements of the plan's spec trees
(`sharding.param_specs`, `opt_state_specs`, `batch_specs`, `cache_specs`;
logits ``(batch axes, tensor axis if shard_vocab)``; the loss replicated),
and the numbers are the one-device step's. Nothing is compiled: the
builders place inputs and outputs under a plan's placements, and the steps
run eagerly.

The compute layout (the reference leaves it to its compiler): ZeRO-3
storage and data parallelism over the batch axes, and tensor parallelism
over the plan's tensor axis. Each rank runs its own batch rows over plain
tensors, so the model code and the kernels see plain tensors only. Every
step gathers a layer at a time over the FSDP axes only and keeps each
tensor-axis shard local (`lm.layer_params`, `lm.train_steps`, with the
groups of `lm.tp_groups`: heads, ``d_ff`` columns, experts, SSM heads, the
vocab), summing the partial outputs over the tensor axis at each residual
add, the embedding's masked lookup and, in train, the vocab-parallel loss;
attention heads that do not divide the axis run padded on each rank's head
slots (the leaf gathered whole, then cut: `ctx.slot_cut`; in train its
gradient summed over the axis), any other group whose dim does not divide
runs gathered whole, and each is counted so (`ctx.note_tp`; the enc-dec
stacks by the same rule). Serving
logits leave as this rank's vocab columns, with no gather, and a cache
leaf the tensor axis shards (an SSM state's heads and channels) is used in
place. A train step gathers each layer inside its checkpointed scan step
through `ctx.gather_shard`, whose backward returns the layer's gradient to
the params' placements (a reduce-scatter over the FSDP axes that split the
rows, ``shard_grads``, or an all-reduce then a cut), and differentiates
through the tensor axis's sums by the rules of `sharding.ctx`; where the
plan says ``sequence_parallel`` its residual stream holds this rank's
piece of the sequence. AdamW updates each rank's shards, clipping by the
global norm. The loss is the global masked mean: each rank divides its sum
by the mask count over every rank's rows.

``batch_struct``, ``decode_struct`` and ``param_struct`` give the inputs of
a shape cell as meta tensors (shapes and dtypes, no memory): the stand-ins
the dry run (`launch.dryrun`) places on its fake mesh.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.models import Model, lm
from repro_torch.models.common import padded_vocab, torch_dtype
from repro_torch.optim import AdamW
from repro_torch.sharding import ctx
from repro_torch.sharding.plan import (
    LeafSharding,
    Mesh,
    P,
    ShardingPlan,
    batch_specs,
    cache_specs,
    leaf_sharding,
    opt_state_specs,
    param_specs,
)

Tree = Dict[str, Any]

#: the parameter subtrees stacked over layers, gathered a layer at a time
STACKED = ("layers", "enc_layers", "dec_layers")


# ---------------------------------------------------------------------------
# meta stand-ins of a cell's inputs (no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg, cell) -> Dict[str, torch.Tensor]:
    """Stand-ins of a train or prefill batch of ``cell``: ``tokens (B, S)``
    int32 (S + 1 columns in train), a train cell's ``loss_mask (B, S)``
    fp32, an enc-dec model's ``frames (B, F, d)`` bf16, an M-RoPE model's
    ``positions (3, B, S)`` int32."""
    B = cell.global_batch
    S = cell.seq_len + 1 if cell.kind == "train" else cell.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    if cell.kind == "train":
        batch["loss_mask"] = _meta((B, S - 1), torch.float32)
    if cfg.encdec is not None:
        batch["frames"] = _meta((B, cfg.encdec.encoder_seq_len, cfg.d_model), torch.bfloat16)
    if cfg.pos_type == "mrope":
        batch["positions"] = _meta((3, B, S), torch.int32)
    return batch


def decode_struct(model: Model, cell, cache_dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[torch.Tensor, Tree, torch.Tensor]:
    """``(tokens (B, 1) int32, cache, pos () int32)`` stand-ins of a decode
    step at ``S_max = cell.seq_len``; the cache in ``cache_dtype``, the SSM
    state fp32 (`lm.init_cache`'s dtypes)."""
    from repro_torch.models.lm import leaf_name
    from repro_torch.models.ssm import state_dtype
    B = cell.global_batch
    cache = {k: _meta(s, state_dtype(leaf_name(k), cache_dtype))
             for k, s in model.cache_shapes(B, cell.seq_len).items()}
    return _meta((B, 1), torch.int32), cache, _meta((), torch.int32)


def param_struct(model: Model, cell=None) -> Tree:
    """The parameter stand-ins; an enc-dec model's ``pos_embed`` holds
    ``cell.seq_len + 1`` rows (the train cell's targets and one more)."""
    return model.param_shapes(max_seq=cell.seq_len + 1 if cell is not None else None)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def named(mesh: Mesh, spec_tree: Tree) -> Tree:
    """A `LeafSharding` per spec of ``spec_tree``, on ``mesh`` (its axes
    pruned to the mesh's)."""
    return tree_util.map_tree(lambda _, s: leaf_sharding(mesh, s), spec_tree)


def check_even(tree: Any, shardings: Any, what: str) -> None:
    """Every leaf of ``tree`` splits evenly under its `LeafSharding`: each
    dim over the mesh axes its spec names (the reference's jit refuses an
    input whose sharded dim does not divide, and so do the builders, before
    any collective).

    Raises:
        ValueError: a dim does not divide over its axes' extent.
    """
    if isinstance(tree, dict):
        for k, v in tree.items():
            check_even(v, shardings[k], f"{what}/{k}")
        return
    mesh = shardings.mesh
    extent = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for d, size in enumerate(tree.shape):
        axes = shardings.spec.axes(d) if d < len(shardings.spec) else ()
        n = 1
        for a in axes:
            n *= extent[a]
        if size % n:
            raise ValueError(f"{what}: dim {d} of shape {tuple(tree.shape)} does not divide "
                             f"over {axes} ({n} ways)")


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


def _loss_and_grads(model: Model, params: Tree, batch: Dict[str, torch.Tensor],
                    sharded: bool = False):
    """(loss, metrics, grads in `tree.items` order) of one (micro)batch.
    The gradient is taken with respect to detached aliases of the
    parameters (of each rank's shard of a DTensor leaf), so the parameters
    themselves never require grad. ``sharded``: the step's model computes
    on `_train_params` (inside the step's context), and each gradient is
    its shard's, summed over the ranks that split the rows by the gathers'
    backward (`ctx.gather_shard`).

    Autograd's device threads are off: the backward runs here, on the
    thread whose context the collectives' rules and each checkpointed
    step's recompute read (TRAP, the recompute: every rank issues the same
    collectives in the same order), in the same order with and without a
    mesh."""
    leaves = [ctx.local_shard(p).detach().requires_grad_(True)
              for p in tree_util.leaves(params)]
    with torch.enable_grad(), torch.autograd.set_multithreading_enabled(False):
        tree = (_train_params(model.cfg, params, leaves) if sharded
                else tree_util.like(params, leaves))
        loss, metrics = model.train_loss(batch, params=tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _train_params(cfg, params: Tree, leaves: List[torch.Tensor]) -> Tree:
    """The tree a sharded train step's model computes on, over ``leaves``
    (each rank's shard of each leaf of DTensor tree ``params``, in `items`
    order): the stacked layers as DTensors over those shards, gathered a
    layer at a time by the model (`lm.train_steps`); every other leaf
    gathered here (`ctx.gather_shard`), the embedding and the LM head
    keeping their vocab shard where the vocab runs local (`lm.tp_groups`).
    Inside the step's context."""
    vocab = lm.tp_groups(cfg)["vocab"] == ctx.LOCAL
    axis = ctx.tp_axis()

    def one(path, p, leaf):
        top = path.split("/", 1)[0]
        sh = LeafSharding(p.device_mesh, tuple(p.placements), P())
        if top in STACKED:
            return ctx.to_dtensor(leaf, sh, p.shape)
        keep = axis if vocab and top in ("embed", "lm_head") else None
        return ctx.gather_shard(leaf, ctx.gather_plan(p, keep, stacked=False))

    return tree_util.map_tree(one, params, tree_util.like(params, leaves))


def _accumulate(model: Model, params: Tree, micro: List[Dict[str, torch.Tensor]],
                cast: Optional[torch.dtype], sharded: bool = False):
    """(loss, metrics, grads) over the microbatches: one of them as it is,
    several averaged (the metrics the last one's), the gradients cast to
    ``cast`` and accumulated in it (fp32 without it); ``sharded`` as
    `_loss_and_grads` takes it."""
    if len(micro) == 1:
        loss, metrics, grads = _loss_and_grads(model, params, micro[0], sharded)
        if cast is not None:
            grads = [g.to(cast) for g in grads]
        return loss, metrics, grads
    acc_dtype = cast or torch.float32
    gsum, lsum = None, 0.0
    for mb in micro:
        loss, metrics, grads = _loss_and_grads(model, params, mb, sharded)
        if cast is not None:
            grads = [g.to(cast) for g in grads]
        if gsum is None:
            gsum = [g.to(acc_dtype, copy=True) for g in grads]
        else:
            for a, g in zip(gsum, grads):
                a.add_(g.to(acc_dtype))
        lsum = lsum + loss
        del grads
    return lsum / len(micro), metrics, [g.div_(len(micro)) for g in gsum]


def _row_axes(mesh: Mesh, x: Any, dim: int) -> Tuple[str, ...]:
    """The mesh axes DTensor ``x`` splits dim ``dim`` over (none for a
    plain tensor: every rank holds every row)."""
    if not ctx.is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(name for name, p in zip(mesh.axis_names, x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def _check_rows(mesh: Mesh, row_axes: Tuple[str, ...], rows: int, what: str) -> None:
    """A jit input's rows split evenly over ``row_axes``: the reference's
    jit refuses an uneven input (`check_even` guards the same inputs).

    Raises:
        ValueError: ``rows`` does not divide over ``row_axes``.
    """
    n = 1
    for a in row_axes:
        n *= mesh.shape[a]
    if rows % n:
        raise ValueError(f"{what}: {rows} rows do not split evenly over {row_axes} ({n} ways)")


def _my_rows(mesh: Mesh, row_axes: Tuple[str, ...], x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's chunk of dim ``dim`` of the full ``x`` split over
    ``row_axes``, by DTensor's chunk rule (the first axis major): chunks of
    ``ceil(rows / ranks)``, so trailing ranks may hold fewer rows or none,
    the split the reference's padded microbatch computes. A rank without
    rows still joins every collective of the step (`ctx.batch_sum`, the
    gradient reduce-scatter), contributing zero."""
    if not row_axes:
        return x
    from torch.distributed.tensor import Replicate, Shard
    placements = tuple(Shard(dim) if a in row_axes else Replicate() for a in mesh.axis_names)
    lo, hi = ctx.local_range(x.shape, LeafSharding(mesh.device_mesh(), placements, P()), dim=dim)
    return x.narrow(dim, lo, hi - lo)


def _replicated(mesh: Mesh, value: torch.Tensor):
    """A scalar the same on every rank, as a replicated DTensor."""
    return ctx.to_dtensor(value, leaf_sharding(mesh, P()), ())


def _batch_dim(key: str) -> int:
    return 1 if key == "positions" else 0


def make_train_step(model: Model, optimizer: AdamW, mesh: Optional[Mesh] = None,
                    plan: Optional[ShardingPlan] = None, accum_steps: int = 1,
                    grad_reduce_dtype: Optional[str] = None, shard_grads: bool = True):
    """``(params, opt_state, batch) -> (params, opt_state, loss, metrics)``.

    The loss and its gradients come from ``model.train_loss`` through the
    reference's plain ops (no kernel runs: none has a backward, as in the
    reference). ``params`` and ``opt_state`` are updated IN PLACE and
    returned, as the reference's jitted step donates both. The loss and the
    metrics stay on the device.

    ``accum_steps > 1`` accumulates the gradients of that many microbatches
    (`_split_micro`: consecutive rows of the global batch) and averages them
    and the loss; the metrics are the last microbatch's. ``grad_reduce_dtype``
    casts the gradients, and the accumulator keeps that dtype (fp32 without
    it).

    With a ``mesh`` and a ``plan``, ``params`` and ``opt_state`` are
    DTensors under the plan's specs and the batch is a DTensor whose rows
    split over the batch axes (or plain, every rank holding all of it).
    Each rank runs its rows of each microbatch on its shards: a layer at a
    time gathered over the FSDP axes inside each checkpointed scan step,
    the groups of `lm.tp_groups` on their tensor-axis shards, the residual
    stream sequence-parallel where the plan says so (`lm.forward`). The
    loss and metrics come back summed over the ranks that split the rows
    (replicated DTensor scalars). Each layer's gradient comes back to the
    params' placements as the backward leaves it: ``shard_grads``
    reduce-scatters it over the FSDP axes that split the rows; without it
    it is all-reduced, then cut. ``grad_reduce_dtype`` casts it before that
    reduction (the wire carries that dtype), and the accumulator of
    ``accum_steps`` holds each rank's shards alone.

    A microbatch's rows need not split evenly over the batch axes: each rank
    takes its chunk by DTensor's rule (`_my_rows`), and a rank left without
    rows contributes zero to the loss, the metrics and the gradients, whose
    normalisations sum over the ranks.

    Raises:
        ValueError: ``accum_steps`` does not divide the batch; a mesh
            without a plan; an MoE layer whose local dispatch groups would
            not be the global ones (`models.mlp`).
    """
    cast = torch_dtype(grad_reduce_dtype) if grad_reduce_dtype else None
    if mesh is None:
        def train_step(params: Tree, opt_state: Tree, batch: Dict[str, torch.Tensor]):
            micro = [batch] if accum_steps == 1 else _split_micro(batch, accum_steps)
            loss, metrics, grads = _accumulate(model, params, micro, cast)
            optimizer.update(tree_util.like(params, grads), opt_state, params)
            return params, opt_state, loss, metrics

        return train_step
    if plan is None:
        raise ValueError("a sharded train step needs a plan beside its mesh")

    def train_step(params: Tree, opt_state: Tree, batch: Dict[str, torch.Tensor]):
        row_axes = _row_axes(mesh, batch["tokens"], 0)
        whole = {k: ctx.full(v) for k, v in batch.items()}
        micro = [whole] if accum_steps == 1 else _split_micro(whole, accum_steps)
        micro = [{k: _my_rows(mesh, row_axes, v, _batch_dim(k)) for k, v in mb.items()}
                 for mb in micro]
        rows = whole["tokens"].shape[0] // accum_steps
        with ctx.activation_sharding(mesh, plan, row_axes=row_axes, rows=rows,
                                     tensor_parallel=True, shard_grads=shard_grads,
                                     grad_dtype=cast):
            loss, metrics, grads = _accumulate(model, params, micro, cast, sharded=True)
            loss = ctx.batch_sum(loss)
            metrics = {k: ctx.batch_sum(v) for k, v in metrics.items()}
        flat = tree_util.leaves(params)
        placed = [ctx.to_dtensor(g, LeafSharding(p.device_mesh, tuple(p.placements), P()),
                                 p.shape) for p, g in zip(flat, grads)]
        del grads
        optimizer.update(tree_util.like(params, placed), opt_state, params)
        return (params, opt_state, _replicated(mesh, loss),
                {k: _replicated(mesh, v) for k, v in metrics.items()})

    return train_step


def jit_train_step(model: Model, optimizer: AdamW, mesh: Mesh, plan: ShardingPlan, cell,
                   accum_steps: int = 1, grad_reduce_dtype: Optional[str] = None,
                   shard_grads: bool = True):
    """`make_train_step` over ``mesh`` whose inputs are placed under the
    plan's params, AdamW-state and ``cell``'s batch specs first (nothing
    moves when they are placed so already): params and state are then
    updated in place under those placements."""
    pspecs = param_specs(model.cfg, plan)
    psh, osh = named(mesh, pspecs), named(mesh, opt_state_specs(pspecs))
    bsh = named(mesh, batch_specs(model.cfg, plan, cell))
    step = make_train_step(model, optimizer, mesh, plan, accum_steps, grad_reduce_dtype,
                           shard_grads)

    def train_step(params: Tree, opt_state: Tree, batch: Dict[str, torch.Tensor]):
        check_even(params, psh, "params")
        check_even(opt_state, osh, "opt_state")
        check_even(batch, bsh, "batch")
        return step(ctx.place_tree(params, psh), ctx.place_tree(opt_state, osh),
                    ctx.place_tree(batch, bsh))

    return train_step


def _serving_params(cfg, params: Tree) -> Tree:
    """The leaves outside the layer stacks gathered whole, but the
    embedding and the LM head, which keep this rank's vocab shard where
    the vocab runs local (`lm.tp_groups`); the stacks stay sharded, cut a
    layer at a time as the model reaches them. Called inside the step's
    `ctx.activation_sharding`."""
    vocab = lm.tp_groups(cfg)["vocab"] == ctx.LOCAL
    axis = ctx.tp_axis()
    return {k: v if k in STACKED else
            ctx.local_of(v, axis) if vocab and k in ("embed", "lm_head") else ctx.full_tree(v)
            for k, v in params.items()}


def _tp_keys(cfg) -> Tuple[Optional[str], frozenset]:
    """The tensor axis of the current step and the cache keys it keeps as
    this rank's shard (`lm.tp_cache_local`); inside the step's context."""
    return ctx.tp_axis(), lm.tp_cache_local(cfg, lm.tp_groups(cfg))


def _logits_sharding(mesh: Mesh, plan: ShardingPlan, cell) -> LeafSharding:
    b_ax = plan.batch_axes if cell.global_batch > 1 else None
    return leaf_sharding(mesh, P(b_ax, plan.tp if plan.shard_vocab else None))


def _logits_out(logits: torch.Tensor, lsh: LeafSharding, B: int, v_pad: int,
                axis: Optional[str]) -> Any:
    """Each rank's logits rows (all its vocab columns, or its shard of them)
    as a DTensor under ``lsh``."""
    keep = (axis,) if axis is not None and logits.shape[1] < v_pad else ()
    return ctx.from_rows(logits, lsh, (B, v_pad), dim=0, keep=keep)


def _cache_out(local: Tree, csh: Tree, batch: int, keeps: Dict[str, Tuple[str, ...]]) -> Tree:
    """Each rank's cache rows (batch on axis 1) as DTensors under ``csh``;
    leaf ``k`` holds this rank's shard of the mesh axes ``keeps[k]`` (the
    tensor axis, or the sequence axes)."""
    out = {}
    for k, v in local.items():
        keep = keeps[k]
        shape = list(ctx.full_shape(v.shape, csh[k], keep))
        shape[1] = batch
        out[k] = ctx.from_rows(v, csh[k], tuple(shape), dim=1, keep=keep)
    return out


def _cache_keeps(cache: Tree, axis: Optional[str], kept: frozenset,
                 seq: Tuple[str, ...] = ()) -> Dict[str, Tuple[str, ...]]:
    """The mesh axes whose shard each cache leaf keeps in a step: the
    tensor axis ``axis`` for the leaves in ``kept`` (`_tp_keys`), the
    sequence axes ``seq`` for those with a sequence (K/V, the MLA latent),
    none for the rest."""
    return {k: (axis,) if k in kept else seq if lm.is_positional(k) else ()
            for k in cache}


def jit_prefill(model: Model, mesh: Mesh, plan: ShardingPlan, cell):
    """``(params, batch) -> (logits (B, V_pad), cache)`` under ``plan``
    on ``mesh``: params, batch, logits and cache as DTensors under their
    specs (``cell.global_batch`` sizes the batch specs and the cache's).
    Each rank computes its rows over the whole sequence; a cache whose
    sequence the plan shards (``seq_axis``) is cut to each rank's piece on
    the way out, with no data moved."""
    psh = named(mesh, param_specs(model.cfg, plan))
    bsh = named(mesh, batch_specs(model.cfg, plan, cell))
    csh = named(mesh, cache_specs(model.cfg, plan, batch=cell.global_batch))
    lsh = _logits_sharding(mesh, plan, cell)
    v_pad = padded_vocab(model.cfg.vocab_size)

    def prefill(params: Tree, batch: Dict[str, Any]):
        check_even(params, psh, "params")
        check_even({k: v for k, v in batch.items() if k in bsh}, bsh, "batch")
        params = ctx.place_tree(params, psh)
        placed = {k: ctx.place(v, bsh[k]) if k in bsh else v for k, v in batch.items()}
        B = placed["tokens"].shape[0]
        row_axes = _row_axes(mesh, placed["tokens"], 0)
        _check_rows(mesh, row_axes, B, "a prefill batch")
        local = {k: ctx.local_rows(v, _batch_dim(k)) if k in bsh else v
                 for k, v in placed.items()}
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, row_axes=row_axes,
                                                      tensor_parallel=True):
            axis, kept = _tp_keys(model.cfg)
            logits, cache = model.prefill(local, params=_serving_params(model.cfg, params))
        return (_logits_out(logits, lsh, B, v_pad, axis),
                _cache_out(cache, csh, B, _cache_keeps(cache, axis, kept)))

    return prefill


def jit_decode_step(model: Model, mesh: Mesh, plan: ShardingPlan, cell):
    """``(params, tokens (B, 1), cache, pos) -> (logits, cache)`` under
    ``plan`` on ``mesh``, all as DTensors under their specs (``pos``
    replicated). Each rank runs its rows. A cache leaf stays on its shard,
    written in place, where the step computes on that shard: a K/V or MLA
    latent leaf whose sequence the plan shards (``seq_axis``) keeps each
    rank's positions (attention runs over them and combines the softmax
    over the sequence axes: `ctx.seq_axes`, `models.attention`); an SSM
    state whose heads run local keeps the rank's heads. Any other shard (an
    SSM state whose heads run gathered) is gathered to the rank's rows for
    the step and cut back after.

    Raises:
        ValueError: a sequence axis also splits the batch rows.
    """
    psh = named(mesh, param_specs(model.cfg, plan))
    csh = named(mesh, cache_specs(model.cfg, plan, batch=cell.global_batch))
    b_ax = plan.batch_axes if cell.global_batch > 1 else None
    tsh = leaf_sharding(mesh, P(b_ax, None))
    lsh = _logits_sharding(mesh, plan, cell)
    v_pad = padded_vocab(model.cfg.vocab_size)

    def decode(params: Tree, tokens: torch.Tensor, cache: Tree, pos):
        check_even(params, psh, "params")
        check_even(tokens, tsh, "tokens")
        check_even(cache, csh, "cache")
        params = ctx.place_tree(params, psh)
        tokens = ctx.place(tokens, tsh)
        cache = ctx.place_tree(cache, csh)
        B = tokens.shape[0]
        row_axes = _row_axes(mesh, tokens, 0)
        _check_rows(mesh, row_axes, B, "a decode batch")
        with torch.no_grad(), ctx.activation_sharding(mesh, plan, row_axes=row_axes,
                                                      tensor_parallel=True, seq_local=True):
            axis, kept = _tp_keys(model.cfg)
            seq = ctx.seq_axes()
            if set(seq) & set(row_axes):
                raise ValueError(f"the sequence axes {seq} also split the batch rows "
                                 f"{row_axes}")
            keeps = _cache_keeps(cache, axis, kept, seq)
            local = {k: ctx.local_rows(v, 1, keep=keeps[k]) for k, v in cache.items()}
            logits, local = model.decode_step(ctx.local_rows(tokens, 0), local,
                                              ctx.full(pos),
                                              params=_serving_params(model.cfg, params))
        return (_logits_out(logits, lsh, B, v_pad, axis),
                _cache_out(local, csh, B, keeps))

    return decode
