"""Decoder-only LM assembly (dense, MoE, SSM and hybrid families; GQA or
MLA attention).

Layer parameters and caches keep the reference's scan-stacked layout: every
layer leaf has a leading dim of `n_scan_steps`, and `forward` is a Python
loop over it. Parameters are nested dicts of tensors with the reference's
keys. A hybrid (Jamba) model scans over *periods*: one step holds
``hybrid_period`` sub-layers, each under its ``pos{off}`` key (attention at
``hybrid_attn_offsets``, Mamba elsewhere, MoE per the MoEConfig cadence), so
its leading dim is ``num_layers / hybrid_period``.

The cache is one flat dict of tensors: a leaf is named by its own name
(``"k"``, ``"ckv"``, ``"ssm"``, ...), prefixed with ``"pos{off}/"`` in a
hybrid model (`leaf_name` strips the prefix).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as ffn
from repro_torch.models import ssm as ssd
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    dtype_of,
    embed_init,
    norm_shapes,
    padded_vocab,
    param_dtype_of,
    vocab_mask,
)
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import batch_sum, constrain, is_dtensor, layer_slice

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# per-position layer kinds
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """(mixer_kind, ffn_kind) for each in-period position (or the single
    repeated layer of a homogeneous model): mixers "attn", "mla", "ssm";
    ffns "mlp", "moe", "none".

    Raises:
        ValueError: an enc-dec model (its stacks are `models.encdec`'s).
    """
    if cfg.encdec is not None:
        raise ValueError(f"{cfg.name}: an enc-dec model has no decoder-only layer "
                         "kinds (see repro_torch.models.encdec)")
    period = cfg.hybrid_period or 1
    kinds = []
    for off in range(period):
        if cfg.family == "ssm":
            mixer = "ssm"
        elif cfg.hybrid_period:
            mixer = "attn" if off in cfg.hybrid_attn_offsets else "ssm"
        else:
            mixer = "mla" if cfg.attn_type == "mla" else "attn"
        if cfg.family == "ssm":
            f = "none"
        elif cfg.moe is not None and off % cfg.moe.every_k_layers == cfg.moe.offset:
            f = "moe"
        else:
            f = "mlp"
        kinds.append((mixer, f))
    return tuple(kinds)


def n_scan_steps(cfg: ModelConfig) -> int:
    """The stacked leading dim: layers, or periods of a hybrid model.

    Raises:
        ValueError: the layers are not a whole number of periods.
    """
    period = cfg.hybrid_period or 1
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole "
                         f"periods of {period}")
    return cfg.num_layers // period


def sub_prefixes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Each in-period position's key prefix: ``"pos{off}/"`` in a hybrid
    model, ``""`` for the one layer of a homogeneous model."""
    if cfg.hybrid_period:
        return tuple(f"pos{off}/" for off in range(cfg.hybrid_period))
    return ("",)


def leaf_name(key: str) -> str:
    """A cache key's leaf name, without its ``pos{off}/`` prefix."""
    return key.rsplit("/", 1)[-1]


# ---------------------------------------------------------------------------
# parameter layout and init
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its full shape (with the leading `n_scan_steps` dim
    for layer leaves), dtype and init: a std, ``None`` for the fan-in rule on the
    per-layer shape, or "ones" / "zeros" / "embed" / "a_log" (the Mamba2
    ``A_log``, `ssm.a_log_init`)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Union[float, str, None]
    stacked: bool = False


def param_layout(cfg: ModelConfig) -> Params:
    """The parameter tree as `Leaf` specs, key for key the reference's
    ``lm.init_params`` pytree (padded vocab and experts included; a hybrid
    model's sub-layers under ``layers/pos{off}``)."""
    pd = param_dtype_of(cfg)
    steps, d = n_scan_steps(cfg), cfg.d_model

    def layer(shape, init, dtype=pd):
        return Leaf((steps,) + tuple(shape), dtype, init, stacked=True)

    def norm(dim):
        return {k: layer(s, "ones" if k == "scale" else "zeros")
                for k, s in norm_shapes(cfg, dim).items()}

    def sublayer(mixer, f):
        out: Params = {"mixer_norm": norm(d)}
        if mixer == "ssm":
            out["mixer"] = {k: layer(s, init, dtype or pd)
                            for k, (s, init, dtype) in ssd.ssm_shapes(cfg).items()}
        elif mixer == "mla":
            out["mixer"] = {k: norm(s[0]) if std == "norm" else layer(s, std)
                            for k, (s, std) in attn.mla_shapes(cfg).items()}
        else:
            out["mixer"] = {k: layer(s, std) for k, (s, std) in attn.gqa_shapes(cfg).items()}
        if f != "none":
            out["ffn_norm"] = norm(d)
        if f == "moe":
            m = cfg.moe
            e_pad = ffn.padded_experts(m.num_experts)
            moe = {"router": layer((d, m.num_experts), 0.02, torch.float32)}
            moe.update({k: layer(s, std) for k, (s, std)
                        in ffn.mlp_shapes(cfg, m.d_expert, lead=(e_pad,)).items()})
            if m.num_shared_experts:
                moe["shared"] = {k: layer(s, std) for k, (s, std)
                                 in ffn.mlp_shapes(cfg, m.d_shared).items()}
            out["ffn"] = moe
        elif f == "mlp":
            out["ffn"] = {k: layer(s, std) for k, (s, std) in ffn.mlp_shapes(cfg).items()}
        return out

    kinds = layer_kinds(cfg)
    if cfg.hybrid_period:
        layers = {f"pos{off}": sublayer(*kind) for off, kind in enumerate(kinds)}
    else:
        layers = sublayer(*kinds[0])

    v_pad = padded_vocab(cfg.vocab_size)
    tree: Params = {
        "embed": Leaf((v_pad, d), pd, "embed"),
        "layers": layers,
        "final_norm": {k: Leaf(s, pd, "ones" if k == "scale" else "zeros")
                       for k, s in norm_shapes(cfg, d).items()},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = Leaf((d, v_pad), pd, "embed")
    return tree


def map_layout(fn, layout: Params, *trees: Params, path: str = "") -> Params:
    """Apply ``fn(path, leaf, *tree_leaves)`` over the layout's leaves."""
    out = {}
    for key, spec in layout.items():
        sub = f"{path}/{key}" if path else key
        others = [t[key] for t in trees]
        if isinstance(spec, Leaf):
            out[key] = fn(sub, spec, *others)
        else:
            out[key] = map_layout(fn, spec, *others, path=sub)
    return out


def init_layout(layout: Params, gen: torch.Generator, *, device: torch.device) -> Params:
    """Random weights for a `Leaf` layout, made on ``device`` from ``gen``,
    with the reference's std rules. A stacked leaf is drawn one layer at a
    time, so a full-width model needs one layer's fp32 draw of scratch, not
    one leaf's."""

    def make(_, leaf: Leaf):
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
        if leaf.init == "embed":
            return embed_init(gen, leaf.shape, leaf.dtype, device=device)
        if leaf.init == "a_log":
            return ssd.a_log_init(leaf.shape[-1], device=device).expand(leaf.shape).clone()
        if not leaf.stacked:
            return dense_init(gen, leaf.shape, leaf.dtype, leaf.init, device=device)
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        for i in range(leaf.shape[0]):
            out[i] = dense_init(gen, leaf.shape[1:], leaf.dtype, leaf.init, device=device)
        return out

    return map_layout(make, layout)


def init_layout_sharded(layout: Params, gen: torch.Generator, shardings: Params, *,
                        device: torch.device) -> Params:
    """`init_layout`'s weights, drawn in its order from ``gen``, each cut to
    this rank's shard under ``shardings`` (a `LeafSharding` tree congruent
    with the layout) as it is made: DTensors, and the whole model never
    exists on one device. A stacked leaf is drawn and cut one layer at a
    time, so the transient is one layer (a whole leaf for the others)."""
    from repro_torch.sharding import ctx

    def make(path, leaf: Leaf, sh):
        shape = tuple(leaf.shape)
        local, off = ctx.local_shape_and_offset(shape, sh)
        if leaf.stacked and leaf.init not in ("ones", "zeros", "a_log"):
            out = torch.empty(local, dtype=leaf.dtype, device=device)
            cut = tuple(slice(o, o + n) for o, n in zip(off[1:], local[1:]))
            for i in range(shape[0]):
                layer = dense_init(gen, shape[1:], leaf.dtype, leaf.init, device=device)
                if off[0] <= i < off[0] + local[0]:
                    out[i - off[0]] = layer[cut]
                del layer
            return ctx.to_dtensor(out, sh, shape)
        whole = init_layout({"x": leaf}, gen, device=device)["x"]
        part = whole[tuple(slice(o, o + n) for o, n in zip(off, local))].clone()
        del whole
        return ctx.to_dtensor(part, sh, shape)

    return map_layout(make, layout, shardings)


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device: torch.device) -> Params:
    """Random weights of ``cfg``'s layout (`init_layout`)."""
    return init_layout(param_layout(cfg), gen, device=device)


def layer_params(layers: Params, i: int, cut: "TPCut" = None,
                 axis: Optional[str] = None, path: str = "") -> Params:
    """Layer ``i``'s slice of the stacked layer tree: views, no copies; a
    DTensor leaf gathers that layer's shards alone (`ctx.layer_slice`), or,
    where its path is in ``cut.local``, keeps this rank's shard of mesh
    axis ``axis`` and gathers the others (`ctx.layer_local`); a padded
    leaf of ``cut`` is gathered whole, then cut to this rank's head slots
    (`ctx.slot_cut`)."""
    cut = cut or TPCut()
    out = {}
    for k, v in layers.items():
        sub = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            out[k] = layer_params(v, i, cut, axis, sub)
        elif sub in cut.local:
            out[k] = ctx.layer_local(v, i, axis)
        elif sub in cut.padded:
            out[k] = ctx.slot_cut(layer_slice(v, i), cut.padded[sub])
        else:
            out[k] = layer_slice(v, i)
    return out


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

#: each tensor-parallel group's leaves (the tensor-axis-sharded leaves of
#: the reference's spec trees, `sharding.plan`), by the sub-layer kind
TP_LEAVES = {
    "attn": ("mixer", ("wq", "wo")),
    "attn_kv": ("mixer", ("wk", "wv")),
    "mla": ("mixer", ("w_uq", "w_uk", "w_uv", "wo")),
    "ssm": ("mixer", ("w_z", "w_x", "w_dt", "conv_x_w", "conv_x_b", "dt_bias", "A_log",
                      "D", "norm_scale", "out_proj")),
    "mlp": ("ffn", ("w_up", "w_gate", "w_down")),
    "experts": ("ffn", ("w_up", "w_gate", "w_down")),
    "shared": ("ffn/shared", ("w_up", "w_gate", "w_down")),
}


def tp_groups(cfg: ModelConfig) -> Dict[str, str]:
    """How each tensor-parallel group of a step runs on this rank: on its
    even shard of the tensor axis (`ctx.LOCAL`), on its padded head slots
    (`ctx.PADDED`), or gathered whole (`ctx.GATHERED`), by the reference's
    rule: a group runs on its shard when the dim it splits divides by the
    axis's extent, and attention heads that do not divide are padded, as
    the reference's compiler pads them (`ctx.head_slots`). Every group is
    gathered where no tensor axis splits the step.

      * ``attn``: the q heads (``wq`` columns, ``wo`` rows) when the plan
        shards heads: local where ``num_heads`` divides, else padded (a
        single head is not padded: it runs gathered); ``attn_kv``: the K/V
        heads local too where the q heads are local and ``num_kv_heads``
        divides as well, otherwise K/V are computed whole and each q slot
        reads its K/V head by index (`attention._kv_heads_read`), counted
        padded beside padded q heads and gathered beside local ones;
      * ``mla``: MLA's heads (``w_uq``/``w_uk``/``w_uv`` columns, ``wo``
        rows), local or padded as ``attn``, the latent whole;
      * ``ssm``: the SSM heads (one group of B/C, `ssm.ssm_dims`);
      * ``mlp`` / ``shared``: the ``d_ff`` (``d_shared``) columns and rows;
      * ``experts``: the experts, when the expert axis is the tensor axis;
      * ``vocab``: the embedding's rows and the LM head's columns.
    """
    LOCAL, PADDED, GATHERED = ctx.LOCAL, ctx.PADDED, ctx.GATHERED
    n, _ = ctx.tp()
    names = ("attn", "attn_kv", "mla", "ssm", "mlp", "experts", "shared", "vocab")
    if n == 1:
        return {k: GATHERED for k in names}
    plan = ctx.current()[1]

    def state(on: bool) -> str:
        return LOCAL if on else GATHERED

    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    heads = (GATHERED if not plan.shard_attn_heads or hq < 2 else
             LOCAL if hq % n == 0 else PADDED)
    kv = (LOCAL if heads == LOCAL and hkv > 0 and hkv % n == 0 else
          PADDED if heads == PADDED else GATHERED)
    out = {"attn": heads, "attn_kv": kv, "mla": heads, "ssm": GATHERED,
           "mlp": state(cfg.d_ff > 0 and cfg.d_ff % n == 0),
           "experts": GATHERED, "shared": GATHERED,
           "vocab": state(plan.shard_vocab and padded_vocab(cfg.vocab_size) % n == 0)}
    if cfg.ssm is not None:
        _, H, _, _, _ = ssd.ssm_dims(cfg)
        out["ssm"] = state(cfg.ssm.n_groups == 1 and H % n == 0)
    if cfg.moe is not None:
        m = cfg.moe
        out["experts"] = state(plan.ep_axis == plan.tp_axis
                               and ffn.padded_experts(m.num_experts) % n == 0)
        out["shared"] = state(bool(m.num_shared_experts) and m.d_shared % n == 0)
    return out


def _slot_cuts(cfg: ModelConfig, group: str) -> Dict[str, ctx.SlotCut]:
    """The leaves of a padded head group (``attn`` or ``mla``) and how each
    is cut to this rank's slots (`ctx.slot_cut`): a q projection's columns,
    an out-projection's rows, each head ``width`` wide."""
    H = cfg.num_heads
    if group == "attn":
        hd = cfg.resolved_head_dim
        return {"wq": ctx.SlotCut(1, hd, H), "wo": ctx.SlotCut(0, hd, H)}
    m = cfg.mla
    return {"w_uq": ctx.SlotCut(1, m.qk_nope_head_dim + m.qk_rope_head_dim, H),
            "w_uk": ctx.SlotCut(1, m.qk_nope_head_dim, H),
            "w_uv": ctx.SlotCut(1, m.v_head_dim, H),
            "wo": ctx.SlotCut(0, m.v_head_dim, H)}


@dataclasses.dataclass(frozen=True)
class TPCut:
    """How a tensor-parallel step cuts a stack's layer leaves: the paths
    (``[pos{off}/]mixer/wq`` ...) that keep this rank's even shard of the
    tensor axis, and those of padded head groups with their `ctx.SlotCut`
    (gathered whole, then cut to the rank's slots); every other leaf is
    gathered whole."""

    local: frozenset = frozenset()
    padded: Dict[str, ctx.SlotCut] = dataclasses.field(default_factory=dict)


def _cut_of(cfg: ModelConfig, groups: Dict[str, str], subs) -> TPCut:
    """The `TPCut` of ``subs``: ``(key prefix, group)`` pairs, the prefix
    naming the sub-layer's leaves (``pos0/mixer/``, ``self_attn/`` ...)."""
    local, padded = set(), {}
    for pre, g in subs:
        if groups[g] == ctx.LOCAL:
            local.update(pre + leaf for leaf in TP_LEAVES[g][1])
        elif groups[g] == ctx.PADDED and g in ("attn", "mla"):
            padded.update({pre + k: c for k, c in _slot_cuts(cfg, g).items()})
    return TPCut(frozenset(local), padded)


def tp_cut(cfg: ModelConfig, groups: Dict[str, str]) -> TPCut:
    """The `TPCut` of a decoder-only model's layer tree."""
    subs = []
    for pre, (mixer, f) in zip(sub_prefixes(cfg), layer_kinds(cfg)):
        names = [mixer] + (["attn_kv"] if mixer == "attn" else [])
        names += {"mlp": ["mlp"], "moe": ["experts", "shared"], "none": []}[f]
        subs += [(f"{pre}{TP_LEAVES[g][0]}/", g) for g in names]
    return _cut_of(cfg, groups, subs)


#: each enc-dec stack's sub-layers: (key, kind, name counted) (the
#: reference's `_gqa_specs` / `_mlp_specs` for every one): the encoder's
#: attention and MLP, the decoder's self-attention, cross-attention and MLP
ENCDEC_SUBLAYERS = {"enc_layers": (("attn", "attn", "enc_attn"), ("mlp", "mlp", "enc_mlp")),
                    "dec_layers": (("self_attn", "attn", "self_attn"),
                                   ("cross_attn", "attn", "cross_attn"),
                                   ("mlp", "mlp", "dec_mlp"))}


def encdec_cut(cfg: ModelConfig, stack: str, groups: Dict[str, str]) -> TPCut:
    """The `TPCut` of an enc-dec stack (``"enc_layers"`` or
    ``"dec_layers"``): each attention's ``attn``/``attn_kv`` groups and
    each MLP's ``mlp``, under the sub-layer's own key (``self_attn/wq``
    ...)."""
    return _cut_of(cfg, groups, [(f"{sub}/", g) for sub, kind, _ in ENCDEC_SUBLAYERS[stack]
                                 for g in (("attn", "attn_kv") if kind == "attn" else ("mlp",))])


def note_encdec(stack: str, groups: Dict[str, str]) -> Tuple[bool, ...]:
    """Count one layer of an enc-dec stack (`ctx.note_tp`), each sub-layer
    under its own name (`ENCDEC_SUBLAYERS`; an attention's K/V heads as
    ``<name>_kv``). Returns whether each sub-layer's output is a partial
    sum over the tensor axis (local or padded), in that order."""
    out = []
    for _, kind, name in ENCDEC_SUBLAYERS[stack]:
        ctx.note_tp(name, groups[kind])
        if kind == "attn":
            ctx.note_tp(name + "_kv", groups["attn_kv"])
        out.append(groups[kind] != ctx.GATHERED)
    return tuple(out)


def _note_layer(cfg: ModelConfig, kind, groups: Dict[str, str]) -> Tuple[bool, bool]:
    """Count one sub-layer's groups (`ctx.note_tp`); returns whether its
    mixer's and its ffn's outputs are partial sums over the tensor axis (a
    local or a padded group's). An MoE whose experts and shared expert are
    not both on their shards sums its shard's part itself (`mlp.moe_ffn`),
    and returns a whole output."""
    mixer, f = kind
    ctx.note_tp(mixer, groups[mixer])
    if mixer == "attn":
        ctx.note_tp("attn_kv", groups["attn_kv"])
    partial = groups[mixer] != ctx.GATHERED
    if f == "mlp":
        ctx.note_tp("mlp", groups["mlp"])
        return partial, groups["mlp"] == ctx.LOCAL
    if f == "moe":
        ctx.note_tp("experts", groups["experts"])
        if cfg.moe.num_shared_experts:
            ctx.note_tp("shared", groups["shared"])
        return partial, groups["experts"] == ctx.LOCAL and (
            not cfg.moe.num_shared_experts or groups["shared"] == ctx.LOCAL)
    return partial, False


def _embed_lookup(params: Params, tokens: torch.Tensor, v_pad: int,
                  sp: bool = False) -> torch.Tensor:
    """The embedding rows of ``tokens``. An embedding whose vocab rows this
    rank holds a shard of (fewer rows than ``v_pad``) looks up the tokens
    in its range, zero elsewhere, and sums over the tensor axis: each
    token's row comes from the one rank that holds it, exactly (the sum
    feeds the replicated residual stream: `ctx.tp_reduce`). ``sp``: the
    rows are this rank's piece of the sequence (dim 1), the sum
    reduce-scattered into it (`ctx.sp_scatter`), or the whole lookup cut
    to it (`ctx.sp_cut`)."""
    emb = params["embed"]
    n_local = emb.shape[0]
    if n_local == v_pad:
        return ctx.sp_cut(emb[tokens], 1) if sp else emb[tokens]
    idx = tokens.long() - ctx.tp()[1] * n_local
    inside = (idx >= 0) & (idx < n_local)
    rows = emb[idx.clamp(0, n_local - 1)] * inside[..., None].to(emb.dtype)
    return ctx.sp_scatter(rows, 1) if sp else ctx.tp_reduce(rows)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


#: the cache leaves with a sequence axis (axis 2, after the stacked dim and
#: the batch), by leaf name (`leaf_name`)
POSITIONAL_LEAVES = ("k", "v", "ckv", "kpe")


def is_positional(key: str) -> bool:
    """Whether cache leaf ``key`` has a sequence axis (axis 2)."""
    return leaf_name(key) in POSITIONAL_LEAVES


def _mixer_cache_shape(cfg: ModelConfig, mixer: str, batch: int, s_max: int
                       ) -> Dict[str, Tuple[int, ...]]:
    if mixer == "ssm":
        return ssd.state_shapes(cfg, batch)
    if mixer == "mla":
        m = cfg.mla
        return {"ckv": (batch, s_max, m.kv_lora_rank),
                "kpe": (batch, s_max, m.qk_rope_head_dim)}
    shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def cache_shape(cfg: ModelConfig, batch: int, s_max: int) -> Dict[str, Tuple[int, ...]]:
    """Shape of each cache leaf, stacked over `n_scan_steps`: attention
    ``k``/``v`` ``(L, batch, s_max, Hkv, Dh)``; MLA ``ckv`` ``(L, batch,
    s_max, R)`` and ``kpe`` ``(L, batch, s_max, Dr)``; SSM
    ``conv_x``/``conv_B``/``conv_C`` ``(L, batch, K-1, C)`` and ``ssm``
    ``(L, batch, H, P, N)``, which have no sequence axis (``s_max`` does not
    size them). A hybrid model's leaves are keyed ``pos{off}/<leaf>``."""
    steps = n_scan_steps(cfg)
    return {pre + k: (steps,) + s
            for pre, (mixer, _) in zip(sub_prefixes(cfg), layer_kinds(cfg))
            for k, s in _mixer_cache_shape(cfg, mixer, batch, s_max).items()}


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *,
               dtype: torch.dtype = torch.bfloat16, device: torch.device) -> Cache:
    """Zeroed decode cache, stacked over layers. bf16 by default, as in the
    reference, whatever the activation dtype; the SSM ``ssm`` state is fp32
    always."""
    return {k: torch.zeros(s, dtype=ssd.state_dtype(leaf_name(k), dtype), device=device)
            for k, s in cache_shape(cfg, batch, s_max).items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor, sp: bool) -> torch.Tensor:
    """``x`` normed by the norm ``p``. ``sp``: ``x`` is this rank's piece
    of the sequence, normed there, as the reference norms it; the norm's
    replicated params then enter the piece's computation (`ctx.tp_enter`:
    each rank's gradient is its piece's part, summed over the axis)."""
    if sp:
        p = {k: ctx.tp_enter(v) for k, v in p.items()}
    return apply_norm(cfg, p, x)


def _enter(h: torch.Tensor, sp: bool, shard: bool) -> torch.Tensor:
    """A normed input as its sub-layer reads it: ``h`` itself, or under
    sequence parallelism (``sp``) every rank's piece put together, through
    `ctx.sp_enter` where the sub-layer reads it on its shards (``shard``:
    the reduce-scatter backward sums their parts), else `ctx.sp_gather`
    (every rank computes on it whole and alike)."""
    if not sp:
        return h
    return ctx.sp_enter(h, 1) if shard else ctx.sp_gather(h, 1)


def _shard_inputs(cfg: ModelConfig, kind, groups: Dict[str, str]) -> Tuple[bool, bool]:
    """Whether a sub-layer's mixer and its ffn read their normed input on
    a shard of the tensor axis (`_enter`): attention on its q heads or
    padded slots, an MLP on its ``d_ff`` columns, an MoE on its experts or
    its shared expert's columns. MLA's shards read its latents, which enter
    them on their own, and an SSM enters its input itself: both read it
    whole."""
    mixer, f = kind
    m = mixer == "attn" and groups["attn"] != ctx.GATHERED
    if f == "mlp":
        return m, groups["mlp"] == ctx.LOCAL
    if f == "moe":
        return m, groups["experts"] == ctx.LOCAL or (
            bool(cfg.moe.num_shared_experts) and groups["shared"] == ctx.LOCAL)
    return m, False


def _exit(out: torch.Tensor, partial: bool, sp: bool) -> torch.Tensor:
    """A sub-layer's output as its residual add takes it: a partial sum over
    the tensor axis summed (`ctx.tp_reduce`; under sequence parallelism
    reduce-scattered into this rank's piece, `ctx.sp_scatter`), a whole
    output as it is (cut to the piece, `ctx.sp_cut`)."""
    if sp:
        return ctx.sp_scatter(out, 1) if partial else ctx.sp_cut(out, 1)
    return ctx.tp_reduce(out) if partial else out


def _run_layer(cfg, p, kind, x, *, positions, mode, cache, pos, partial=(False, False),
               sp=False, entered=(False, False)):
    """One sub-layer: returns (x, its new cache (None in train mode), its
    MoE aux loss (None unless a train-mode MoE layer)). ``partial``: whether
    the mixer's and the ffn's outputs are this rank's partial sums over the
    tensor axis (`tp_groups`); each is then summed over the axis once, at
    its residual add. ``sp``: ``x`` is this rank's piece of the sequence (a
    sequence-parallel train step); each norm then runs on the piece, each
    sub-layer on the whole sequence, the normed piece gathered into it
    (`_enter`; ``entered``: whether the mixer's and the ffn's normed input
    enters their shards, `_shard_inputs`), and its output is
    reduce-scattered (or cut) back into the piece (`_exit`)."""
    mixer, f = kind
    h = _enter(_norm(cfg, p["mixer_norm"], x, sp), sp, entered[0])
    if mixer == "ssm":
        out, new_cache = ssd.ssm_block(cfg, p["mixer"], h, mode=mode, state=cache)
    elif mixer == "mla":
        out, new_cache = attn.mla_attention(
            cfg, p["mixer"], h, positions=positions, mode=mode, cache=cache, pos=pos)
    else:
        out, new_cache = attn.gqa_attention(
            cfg, p["mixer"], h, positions=positions, mode=mode, cache=cache, pos=pos,
            entered=entered[0])
    x = x + constrain(_exit(out, partial[0], sp), "batch", "sp" if mode == "train" else None,
                      None)
    if f == "none":
        return x, new_cache, None
    # TRAP, SP and the MoE groups: the MoE runs on the whole sequence, so
    # its dispatch groups and capacity are the reference's
    h = _enter(_norm(cfg, p["ffn_norm"], x, sp), sp, entered[1])
    aux = None
    if f == "moe":
        out, aux = ffn.moe_ffn(cfg, p["ffn"], h, kernel=(mode == "prefill"),
                               want_aux=(mode == "train"), entered=entered[1])
    else:
        out = ffn.mlp(cfg, p["ffn"], h, entered=entered[1])
    return (x + constrain(_exit(out, partial[1], sp), "batch",
                          "sp" if mode == "train" else None, None), new_cache, aux)


def train_steps(layers: Params, cut: "TPCut" = None, axis: Optional[str] = None):
    """The stacked layer tree of a train step, one scan step at a time:
    yields ``(lp, gather)``, ``lp`` the step's leaves (views from one
    `unbind` of each stacked leaf; of a DTensor leaf, of this rank's shard)
    and ``gather(lp)`` the layer the model computes on: each DTensor leaf
    gathered over its FSDP axes, and over the tensor axis ``axis`` unless
    its path is in ``cut.local`` (`ctx.gather_shard`: its gradient comes
    back to the shard, summed over the ranks that split the rows). A padded
    leaf of ``cut`` is gathered whole, then cut to this rank's head slots
    (`ctx.slot_cut`), and its gradient is summed over ``axis`` too (each
    rank's is its own slots' part). A checkpointed step calls ``gather``
    inside, so its backward gathers the layer again and no gathered layer
    is saved."""
    cut = cut or TPCut()
    padded = cut.padded
    plans = dict(tree_util.items(tree_util.map_tree(
        lambda path, v: ctx.gather_plan(v, axis if path in cut.local else None, stacked=True,
                                        summed=axis if path in padded else None),
        layers)))
    views = tree_util.map_tree(
        lambda _, v: (v.to_local() if is_dtensor(v) else v).unbind(0), layers)

    def one(path, t):
        w = ctx.gather_shard(t, plans[path])
        return ctx.slot_cut(w, padded[path]) if path in padded else w

    def gather(lp: Params) -> Params:
        return tree_util.map_tree(one, lp)

    steps = len(tree_util.leaves(views)[0])
    for i in range(steps):
        yield tree_util.map_tree(lambda _, vs: vs[i], views), gather


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (``aten.mm``, which
    every ``x @ w`` becomes), recompute everything else: the reference's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(name: Optional[str]):
    """The `torch.utils.checkpoint` context of a policy name.

    "nothing" (or None, the baseline): save only each scan step's input,
    recompute the step's whole forward in backward (~1.33x flops).
    "dots": save matmul outputs too, less recompute, more memory.
    """
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if name in (None, "nothing"):
        return noop_context_fn
    raise ValueError(f"unknown remat policy {name!r}")


def _train_layers(cfg, layers, x, positions, *, remat, remat_policy, groups, sp):
    """The scan in train mode: no cache; each scan step recomputed in
    backward under `torch.utils.checkpoint` when ``remat``. Returns (x, the
    MoE aux loss summed over the layers). Each step's layer is gathered
    inside the step (`train_steps`), keeping the tensor-axis shard of the
    groups ``groups`` runs local; ``sp``: ``x`` is this rank's piece of the
    sequence (`_run_layer`)."""
    kinds, prefixes = layer_kinds(cfg), sub_prefixes(cfg)
    context_fn = _remat_context(remat_policy)
    cut = tp_cut(cfg, groups)

    entered = [_shard_inputs(cfg, kind, groups) if sp else (False, False) for kind in kinds]

    def step(x, lp, gather, partial):
        lp = gather(lp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pre, kind, part, ent in zip(prefixes, kinds, partial, entered):
            x, _, a = _run_layer(cfg, lp[pre[:-1]] if pre else lp, kind, x,
                                 positions=positions, mode="train", cache=None, pos=None,
                                 partial=part, sp=sp, entered=ent)
            x = constrain(x, "batch", "sp", None)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, gather in train_steps(layers, cut, ctx.tp_axis()):
        # TRAP, the recompute: counted here, once per forward, not in the
        # step that the backward runs again
        partial = [_note_layer(cfg, kind, groups) for kind in kinds]
        if remat:
            x, a = checkpoint(step, x, lp, gather, partial, use_reentrant=False,
                              context_fn=context_fn)
        else:
            x, a = step(x, lp, gather, partial)
        aux = aux + a
    return x, aux


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "prefill",                # train | prefill | decode
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    pos: Optional[torch.Tensor] = None,   # decode position: scalar or (B,)
    remat: bool = True,
    remat_policy: Optional[str] = "nothing",
) -> Tuple[torch.Tensor, Optional[Cache], Optional[torch.Tensor]]:
    """Returns (hidden (B, S, d), cache, MoE aux loss). Train mode runs the
    reference ops only (no kernel: none has a backward), with no cache, each
    scan step under ``remat`` (`_remat_context`), and returns the MoE aux
    loss summed over the layers (a zero scalar without MoE). Prefill returns
    a new cache stacked over the scan steps: ``(L, B, S, Hkv, Dh)`` K/V (or
    the MLA latent) in the activation dtype, or the SSM state after the
    prompt (conv histories in the activation dtype, ``ssm`` fp32). Decode
    writes into ``cache`` in place and returns it. Serving computes no aux
    loss (None). ``positions`` defaults to the token positions (``pos`` in
    decode), as three equal streams ``(3, B, S)`` for M-RoPE.

    In a tensor-parallel step (`ctx.tp`), the groups `tp_groups` names run
    on this rank's shards: ``params`` then hold the embedding's vocab shard
    where ``vocab`` runs local (`launch.steps`), the layers are cut here,
    and the cache's SSM leaves are this rank's heads and channels
    (`tp_cache_local`). A train step gathers and cuts each layer inside its
    checkpointed scan step (`train_steps`) and, where the plan says
    ``sequence_parallel``, carries its residual stream as this rank's piece
    of the sequence between the sub-layers, each norm on the piece; the
    hidden is then made whole here (`ctx.sp_gather`; `train_loss` instead
    gathers it into the LM head's shard, `_head_input`)."""
    x, new_cache, aux, sp = _forward(cfg, params, tokens, mode=mode, positions=positions,
                                     cache=cache, pos=pos, remat=remat,
                                     remat_policy=remat_policy)
    return (ctx.sp_gather(x, 1) if sp else x), new_cache, aux


def _forward(cfg, params, tokens, *, mode, positions, cache, pos, remat, remat_policy):
    """`forward`'s work: returns (hidden after the final norm, cache, aux,
    whether the step ran sequence-parallel, the hidden then this rank's
    piece of the sequence)."""
    B, S = tokens.shape
    kinds = layer_kinds(cfg)
    prefixes = sub_prefixes(cfg)
    groups = tp_groups(cfg)
    if ctx.tp()[0] > 1:
        ctx.note_tp("vocab", groups["vocab"])
    sp = mode == "train" and ctx.sp_on(S)
    x = _embed_lookup(params, tokens, padded_vocab(cfg.vocab_size), sp).to(dtype_of(cfg))
    x = constrain(x, "batch", "sp" if mode == "train" else None, None)
    if positions is None:
        if mode == "decode":
            p = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
            positions = p.expand(B)[:, None] if p.dim() == 0 else p[:, None]
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        if cfg.pos_type == "mrope":
            positions = positions.expand(3, B, S)

    if mode == "train":
        x, aux = _train_layers(cfg, params["layers"], x, positions, remat=remat,
                               remat_policy=remat_policy, groups=groups, sp=sp)
        return _norm(cfg, params["final_norm"], x, sp), None, aux, sp

    cut = tp_cut(cfg, groups)
    axis = ctx.tp_axis()
    per_step = []
    for i in range(n_scan_steps(cfg)):
        lp = layer_params(params["layers"], i, cut, axis)
        new_lc: Cache = {}
        for pre, kind in zip(prefixes, kinds):
            sc = ({k[len(pre):]: v[i] for k, v in cache.items() if k.startswith(pre)}
                  if mode == "decode" else None)
            x, out, _ = _run_layer(cfg, lp[pre[:-1]] if pre else lp, kind, x,
                                   positions=positions, mode=mode, cache=sc, pos=pos,
                                   partial=_note_layer(cfg, kind, groups))
            x = constrain(x, "batch", None, None)
            if mode == "prefill":
                new_lc.update({pre + k: v for k, v in out.items()})
        per_step.append(new_lc)
        del lp      # a gathered layer is freed before the next is gathered
    new_cache = cache if mode == "decode" else {
        k: torch.stack([lc[k] for lc in per_step]) for k in per_step[0]}
    x = apply_norm(cfg, params["final_norm"], x)
    return x, new_cache, None, False


def tp_cache_local(cfg: ModelConfig, groups: Dict[str, bool]) -> frozenset:
    """The cache keys a tensor-parallel step keeps as this rank's shard of
    the tensor axis: an SSM sub-layer's ``conv_x`` channels and ``ssm``
    heads where its heads run local (`tp_groups`); K/V and the MLA latent
    stay whole (replicated over the axis, as the reference's specs)."""
    if groups["ssm"] != ctx.LOCAL:
        return frozenset()
    return frozenset(pre + k for pre, (mixer, _) in zip(sub_prefixes(cfg), layer_kinds(cfg))
                     if mixer == "ssm" for k in ("conv_x", "ssm"))


def _head_cols(cfg: ModelConfig, params: Params) -> int:
    """The LM head's vocab columns this rank holds: all ``V_pad``, or its
    shard where the vocab runs local (`tp_groups`)."""
    return params["embed"].shape[0] if cfg.tie_embeddings else params["lm_head"].shape[1]


def _head_input(cfg: ModelConfig, params: Params, hidden: torch.Tensor, sp: bool
                ) -> torch.Tensor:
    """The hidden a train step's LM head reads: ``hidden`` itself, or
    under sequence parallelism (``sp``: it is this rank's normed piece)
    every rank's piece put together, through `ctx.sp_enter` where the head
    is this rank's vocab shard (`cross_entropy` with ``entered``), else
    `ctx.sp_gather`."""
    return _enter(hidden, sp, _head_cols(cfg, params) < padded_vocab(cfg.vocab_size))


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor, *,
              entered: bool = False) -> torch.Tensor:
    """``hidden`` through the LM head (the tied embedding's transpose):
    this rank's vocab columns where the head is its shard (`tp_groups`),
    the replicated ``hidden`` entering the shard's product (`ctx.tp_enter`)
    unless it has ``entered`` already (`_head_input`)."""
    if not entered and _head_cols(cfg, params) < padded_vocab(cfg.vocab_size):
        hidden = ctx.tp_enter(hidden)
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]


# ---------------------------------------------------------------------------
# losses and entry points
# ---------------------------------------------------------------------------


def cross_entropy(
    cfg: ModelConfig,
    params: Params,
    hidden: torch.Tensor,     # (B, S, d)
    targets: torch.Tensor,    # (B, S) int
    mask: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
    entered: bool = False,
) -> torch.Tensor:
    """Token-mean next-token CE with an fp32 log-softmax over the real vocab
    (the padded ids masked). ``chunk`` cuts the sequence into chunks, each
    recomputed in backward, so the ``(B, S, V)`` logits never exist at once.
    ``entered``: ``hidden`` has entered the LM head's shard already
    (`_head_input`).

    Where the LM head is this rank's vocab shard (`tp_groups`), the loss is
    vocab-parallel: the row maximum is all-reduced with MAX (outside
    autograd: the shift cancels), the sum of exponentials and the gold
    logit, taken on the shard that holds it, are summed over the tensor
    axis (`ctx.tp_reduce`), and each shard masks the padded ids it holds.

    Raises:
        ValueError: ``chunk`` does not divide the sequence.
    """
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    v_pad = padded_vocab(cfg.vocab_size)
    cols = _head_cols(cfg, params)
    off = ctx.tp()[1] * cols if cols < v_pad else 0
    vmask = (vocab_mask(cfg.vocab_size, v_pad, device=hidden.device)[off:off + cols]
             if v_pad != cfg.vocab_size else None)

    def chunk_loss(h, t, m):
        logits = logits_fn(cfg, params, h, entered=entered).float()
        if vmask is not None:
            logits = logits + vmask
        if cols == v_pad:
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, t[..., None].long())[..., 0]
        else:
            top = ctx.tp_max(logits.detach().amax(dim=-1))
            lse = torch.log(ctx.tp_reduce(torch.exp(logits - top[..., None]).sum(dim=-1))) + top
            idx = t.long() - off
            inside = (idx >= 0) & (idx < cols)
            mine = logits.gather(-1, idx.clamp(0, cols - 1)[..., None])[..., 0]
            gold = ctx.tp_reduce(torch.where(inside, mine, torch.zeros_like(mine)))
        return ((lse - gold) * m).sum()

    if chunk is None or chunk >= S:
        total = chunk_loss(hidden, targets, mask)
    else:
        if S % chunk:
            raise ValueError(f"loss chunk {chunk} does not divide the sequence {S}")
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            total = total + checkpoint(chunk_loss, hidden[:, sl], targets[:, sl], mask[:, sl],
                                       use_reentrant=False)
    # the mask count over every rank's rows: the loss is the global masked
    # mean, and each rank's share of it sums to that (`ctx.batch_sum`)
    return total / torch.clamp(batch_sum(mask.sum()), min=1.0)


def train_loss(
    cfg: ModelConfig,
    params: Params,
    batch: Dict[str, Any],
    *,
    aux_weight: float = 0.01,
    loss_chunk: Optional[int] = None,
    remat_policy: Optional[str] = "nothing",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch``: ``tokens (B, S + 1)``, optionally ``loss_mask (B, S)`` and
    M-RoPE ``positions (3, B, S + 1)`` (the last position is dropped).
    Returns (``ce + aux_weight * moe_aux``, ``{"ce", "moe_aux"}``)."""
    tokens = batch["tokens"]
    positions = batch.get("positions")
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if positions is not None:
        positions = positions[..., :-1]
    hidden, _, aux, sp = _forward(cfg, params, inp, mode="train", positions=positions,
                                  cache=None, pos=None, remat=True, remat_policy=remat_policy)
    ce = cross_entropy(cfg, params, _head_input(cfg, params, hidden, sp), tgt,
                       mask=batch.get("loss_mask"), chunk=loss_chunk, entered=sp)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-token logits (B, V_pad), populated cache).

    ``batch`` may carry ``true_len`` (an int, or a 0-d int64 tensor on the
    model's device): the prompt is then right-padded to the token buffer's
    length and the logits are read at ``true_len - 1``; causal attention
    keeps every position below it blind to the padding (an SSM state would
    fold the padding in: its engine never pads). The position is selected
    on the device, never read back to the host, so a CUDA graph captured
    over a ``true_len`` tensor reads each replay's value.
    """
    tokens = batch["tokens"]
    hidden, cache, _ = forward(cfg, params, tokens, mode="prefill",
                               positions=batch.get("positions"))
    true_len = batch.get("true_len")
    if true_len is None:
        last = hidden[:, -1:, :]
    else:
        at = torch.as_tensor(true_len, dtype=torch.long, device=hidden.device).reshape(1) - 1
        last = hidden.index_select(1, at)
    return logits_fn(cfg, params, last)[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One serving step over ``tokens (B, 1)`` at ``pos`` (scalar or (B,)):
    returns (logits (B, V_pad), cache updated in place)."""
    hidden, cache, _ = forward(cfg, params, tokens, mode="decode", cache=cache, pos=pos)
    return logits_fn(cfg, params, hidden[:, 0:1, :])[:, 0, :], cache
