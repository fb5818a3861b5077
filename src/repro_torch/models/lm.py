"""Decoder-only LM assembly (dense, MoE and SSM families).

Layer parameters and caches keep the reference's scan-stacked layout: every
layer leaf has a leading ``L`` dim, and `forward` is a Python loop over it.
Parameters are nested dicts of tensors with the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

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
)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# per-layer kinds
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """(mixer_kind, ffn_kind) of the one repeated layer. The port has the
    dense and MoE families with GQA attention, and the attention-free SSM
    family (Mamba2); hybrid periods, MLA and enc-dec are not ported yet."""
    if cfg.family == "ssm" and not cfg.hybrid_period:
        return (("ssm", "none"),)
    if cfg.family not in ("dense", "moe") or cfg.hybrid_period or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / attention {cfg.attn_type!r} "
            "is not ported yet")
    if cfg.moe is not None and (0 % cfg.moe.every_k_layers == cfg.moe.offset):
        return (("attn", "moe"),)
    return (("attn", "mlp"),)


# ---------------------------------------------------------------------------
# parameter layout and init
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its full shape (with the leading ``L`` for layer
    leaves), dtype and init: a std, ``None`` for the fan-in rule on the
    per-layer shape, or "ones" / "zeros" / "embed" / "a_log" (the Mamba2
    ``A_log``, `ssm.a_log_init`)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Union[float, str, None]
    stacked: bool = False


def param_layout(cfg: ModelConfig) -> Params:
    """The parameter tree as `Leaf` specs, key for key the reference's
    ``lm.init_params`` pytree (padded vocab and experts included)."""
    pd = param_dtype_of(cfg)
    L, d = cfg.num_layers, cfg.d_model
    mixer, f = layer_kinds(cfg)[0]

    def layer(shape, init, dtype=pd):
        return Leaf((L,) + tuple(shape), dtype, init, stacked=True)

    def norm(dim):
        return {k: layer(s, "ones" if k == "scale" else "zeros")
                for k, s in norm_shapes(cfg, dim).items()}

    layers: Params = {"mixer_norm": norm(d)}
    if mixer == "ssm":
        layers["mixer"] = {k: layer(s, init, dtype or pd)
                           for k, (s, init, dtype) in ssd.ssm_shapes(cfg).items()}
    else:
        layers["mixer"] = {k: layer(s, std) for k, (s, std) in attn.gqa_shapes(cfg).items()}
    if f != "none":
        layers["ffn_norm"] = norm(d)
    if f == "moe":
        m = cfg.moe
        e_pad = ffn.padded_experts(m.num_experts)
        moe = {"router": layer((d, m.num_experts), 0.02, torch.float32)}
        moe.update({k: layer(s, std) for k, (s, std)
                    in ffn.mlp_shapes(cfg, m.d_expert, lead=(e_pad,)).items()})
        if m.num_shared_experts:
            moe["shared"] = {k: layer(s, std) for k, (s, std)
                             in ffn.mlp_shapes(cfg, m.d_shared).items()}
        layers["ffn"] = moe
    elif f == "mlp":
        layers["ffn"] = {k: layer(s, std) for k, (s, std) in ffn.mlp_shapes(cfg).items()}

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


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device: torch.device) -> Params:
    """Random weights made on ``device`` from ``gen``, with the reference's
    std rules. A stacked leaf is drawn one layer at a time, so a full-width
    model needs one layer's fp32 draw of scratch, not one leaf's."""

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

    return map_layout(make, param_layout(cfg))


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


#: the cache leaves with a sequence axis (axis 2, after ``L`` and the batch)
POSITIONAL_LEAVES = ("k", "v")


def cache_shape(cfg: ModelConfig, batch: int, s_max: int) -> Dict[str, Tuple[int, ...]]:
    """Shape of each cache leaf, stacked over layers: attention ``k``/``v``
    ``(L, batch, s_max, Hkv, Dh)``; SSM ``conv_x``/``conv_B``/``conv_C``
    ``(L, batch, K-1, C)`` and ``ssm`` ``(L, batch, H, P, N)``, which have
    no sequence axis (``s_max`` does not size them)."""
    L = cfg.num_layers
    if layer_kinds(cfg)[0][0] == "ssm":
        return {k: (L,) + s for k, s in ssd.state_shapes(cfg, batch).items()}
    shape = (L, batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: ModelConfig, batch: int, s_max: int, *,
               dtype: torch.dtype = torch.bfloat16, device: torch.device) -> Cache:
    """Zeroed decode cache, stacked over layers. bf16 by default, as in the
    reference, whatever the activation dtype; the SSM ``ssm`` state is fp32
    always."""
    return {k: torch.zeros(s, dtype=ssd.state_dtype(k, dtype), device=device)
            for k, s in cache_shape(cfg, batch, s_max).items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _run_layer(cfg, p, kind, x, *, positions, mode, cache, pos):
    mixer, f = kind
    h = apply_norm(cfg, p["mixer_norm"], x)
    if mixer == "ssm":
        out, new_cache = ssd.ssm_block(cfg, p["mixer"], h, mode=mode, state=cache)
    else:
        out, new_cache = attn.gqa_attention(
            cfg, p["mixer"], h, positions=positions, mode=mode, cache=cache, pos=pos)
    x = x + out
    if f == "none":
        return x, new_cache
    h = apply_norm(cfg, p["ffn_norm"], x)
    if f == "moe":
        out, _ = ffn.moe_ffn(cfg, p["ffn"], h, kernel=(mode == "prefill"))
    else:
        out = ffn.mlp(cfg, p["ffn"], h)
    return x + out, new_cache


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "prefill",                # prefill | decode
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    pos: Optional[torch.Tensor] = None,   # decode position: scalar or (B,)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Returns (hidden (B, S, d), cache). Prefill returns a new cache
    stacked over layers: ``(L, B, S, Hkv, Dh)`` K/V in the activation dtype,
    or the SSM state after the prompt (conv histories in the activation
    dtype, ``ssm`` fp32). Decode writes into ``cache`` in place and returns
    it. The MoE aux loss is a training term and the port serves only, so it
    is not computed."""
    B, S = tokens.shape
    kind = layer_kinds(cfg)[0]
    x = params["embed"][tokens].to(dtype_of(cfg))
    if positions is None:
        if mode == "decode":
            p = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
            positions = p.expand(B)[:, None] if p.dim() == 0 else p[:, None]
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)

    per_layer = []
    for i in range(cfg.num_layers):
        lc = {k: v[i] for k, v in cache.items()} if mode == "decode" else None
        x, new_lc = _run_layer(cfg, layer_params(params["layers"], i), kind, x,
                               positions=positions, mode=mode, cache=lc, pos=pos)
        if mode == "prefill":
            per_layer.append(new_lc)
    new_cache = cache if mode == "decode" else {
        k: torch.stack([lc[k] for lc in per_layer]) for k in per_layer[0]}
    x = apply_norm(cfg, params["final_norm"], x)
    return x, new_cache


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-token logits (B, V_pad), populated cache).

    ``batch`` may carry ``true_len``: the prompt is then right-padded to the
    token buffer's length and the logits are read at ``true_len - 1``;
    causal attention keeps every position below it blind to the padding (an
    SSM state would fold the padding in: its engine never pads).
    """
    tokens = batch["tokens"]
    hidden, cache = forward(cfg, params, tokens, mode="prefill",
                            positions=batch.get("positions"))
    true_len = batch.get("true_len")
    if true_len is None:
        last = hidden[:, -1:, :]
    else:
        t = int(true_len)
        last = hidden[:, t - 1:t, :]
    return logits_fn(cfg, params, last)[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One serving step over ``tokens (B, 1)`` at ``pos`` (scalar or (B,)):
    returns (logits (B, V_pad), cache updated in place)."""
    hidden, cache = forward(cfg, params, tokens, mode="decode", cache=cache, pos=pos)
    return logits_fn(cfg, params, hidden[:, 0:1, :])[:, 0, :], cache
