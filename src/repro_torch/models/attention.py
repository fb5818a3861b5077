"""Attention variants with an explicit cache: GQA (MHA included; RoPE,
Qwen2-VL's M-RoPE, or none for learned positions), MLA (multi-head latent
attention, MiniCPM3 / DeepSeek-V2 style) and the Whisper decoder's
cross-attention.

Cache per layer:
  GQA   : ``{"k": (B, S_max, Hkv, Dh), "v": (B, S_max, Hkv, Dh)}``
  MLA   : ``{"ckv": (B, S_max, R), "kpe": (B, S_max, Dr)}`` (the latent)
  cross : ``{"k": (B, S_enc, Hkv, Dh), "v": (B, S_enc, Hkv, Dh)}``

Modes:
  train   — full-sequence causal (or bidirectional) attention, no cache, in
            the reference's plain ops only (no kernel has a backward): plain
            `sdpa`, chunked `flash_attention_ref` from `FLASH_THRESHOLD` on
  prefill — full-sequence causal attention, returns the new cache: GQA
            through the flash kernel; MLA in the expanded form through plain
            `sdpa`, as the reference (its qk head dim is not the v head dim)
  decode  — q_len == 1 at per-row (or one shared) position ``pos``; writes
            the new entry into the cache IN PLACE and attends over it in
            plain ops (the reference has no decode kernel either); MLA in the
            absorbed form

In a tensor-parallel step (`sharding.ctx.tp`), a layer whose projections
are this rank's head shards (`lm.tp_groups`; read off their widths)
attends over its own q heads and the K/V heads they read, and returns its
partial output projection, which the layer sums over the tensor axis.
Heads that do not divide the axis are padded (`ctx.head_slots`): the rank
holds ``k`` head slots from ``r * k``, a slot past the real heads has zero
q columns and zero out-projection rows, and each slot reads its K/V head
by an explicit index (`_kv_heads_read`), since a rank's slots can straddle
a K/V group unevenly. The
cache stays whole over that axis, as the reference's specs keep it: new K/V
heads computed on their shards are gathered before they are written. In
train, every replicated tensor that enters a shard's computation (the
normed input; K/V computed whole; MLA's latent and its query's) crosses
`ctx.tp_enter`, whose backward sums the shards' parts of its gradient. A
sequence-parallel step gathers the normed input into the shards itself
(``entered``: `ctx.sp_enter`, whose reduce-scatter backward is that sum),
and a branch every rank computes whole from it (K/V computed whole) then
counts its gradient once (`ctx.tp_branch`).

In a decode step that keeps the cache on its sequence shards
(`ctx.seq_axes`: the plan's ``seq_axis``), each rank holds the K/V (or the
latent) of its own positions: the new entry is written on the rank that
holds ``pos`` alone, the query attends over the local positions, and the
softmax is combined over the sequence axes flash-decoding style (a MAX
all-reduce of the row maximum, then one SUM all-reduce of the rescaled
sums and weighted values, in fp32). Where the tensor axis that holds the
rank's q heads also cuts the sequence, the query is gathered over the
heads first (every rank's slots, padding included) and the rank keeps its
own slots after the combine.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.common import apply_rope, mrope_cos_sin, rmsnorm, rope_cos_sin
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain

Cache = Dict[str, torch.Tensor]

# from this sequence length on, causal attention in train mode (and MLA
# prefill) attends chunk by chunk (the reference's threshold; it never
# materialises S x S logits)
FLASH_THRESHOLD = 8192


def _full_attn(q, k, v, *, scale, causal):
    """Prefill: causal attention goes to the flash kernel (its plain version
    on the CPU); bidirectional attention to `sdpa`."""
    if causal:
        return kops.flash_attention(q, k, v, causal=True, scale=scale)
    return sdpa(q, k, v, scale=scale, causal=False)


def _train_attn(q, k, v, *, scale, causal):
    """Train mode, the reference's plain ops: `sdpa`, or the chunked
    online-softmax `flash_attention_ref` for long causal sequences."""
    if causal and q.shape[1] >= FLASH_THRESHOLD:
        # q (and the output) shard the sequence, k/v stay whole across it
        q = constrain(q, "batch", "seq", None, None)
        k = constrain(k, "batch", None, None, None)
        v = constrain(v, "batch", None, None, None)
        out = flash_attention_ref(q, k, v, causal=True, scale=scale)
        return constrain(out, "batch", "seq", None, None)
    return sdpa(q, k, v, scale=scale, causal=causal)


# ---------------------------------------------------------------------------
# core scaled-dot-product with GQA grouping
# ---------------------------------------------------------------------------


def sdpa(
    q: torch.Tensor,            # (B, Q, Hq, D)
    k: torch.Tensor,            # (B, S, Hkv, D)
    v: torch.Tensor,            # (B, S, Hkv, Dv)
    *,
    scale: float,
    causal: bool,
    kv_len: Optional[torch.Tensor] = None,    # valid kv prefix: scalar or (B,)
) -> torch.Tensor:
    """Grouped-query attention with fp32 softmax. Returns (B, Q, Hq, Dv)."""
    B, Q, Hq, D = q.shape
    if k.dtype != q.dtype:      # low-precision (bf16) KV cache: upcast for math
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Q, Hkv, G, D)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, k).float() * scale

    S = k.shape[1]
    dev = q.device
    mask = None                                          # (B or 1, Q, S)
    if causal:
        q_pos = torch.arange(Q, device=dev)
        k_pos = torch.arange(S, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None])[None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev)
        if kv_len.dim() == 0:
            valid = (torch.arange(S, device=dev)[None, :] < kv_len)[None]
        else:                                            # per-batch (B,)
            valid = torch.arange(S, device=dev)[None, None, :] < kv_len[:, None, None]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)

    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", w, v)
    return out.reshape(B, Q, Hq, v.shape[-1])


# ---------------------------------------------------------------------------
# decode over this rank's piece of a sequence-sharded cache
# ---------------------------------------------------------------------------


def _write_local(leaf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor, offset: int) -> None:
    """Write ``new`` (``(B, 1, ...)``) at position ``pos`` (scalar or
    ``(B,)``) into ``leaf``, this rank's piece ``[offset, offset + S_local)``
    of a cache leaf's sequence, IN PLACE, on the rank that holds ``pos``
    alone: a masked write from tensor ops (no host read of ``pos``). A rank
    that does not hold it writes back the value already there. The select
    runs in ``new``'s dtype (an fp8 value upcast and cast back is itself);
    the cast to the cache's dtype is the write's, as in the one-device
    step."""
    at = pos.long() - offset
    own = (at >= 0) & (at < leaf.shape[1])
    at = at.clamp(0, leaf.shape[1] - 1)
    if pos.dim() == 0:
        at = at.reshape(1)
        old = leaf[:, at].to(new.dtype)
        leaf[:, at] = torch.where(own, new, old).to(leaf.dtype)
    else:
        bidx = torch.arange(leaf.shape[0], device=leaf.device)
        old = leaf[bidx, at].to(new.dtype)
        mask = own.reshape((-1,) + (1,) * (old.dim() - 1))
        leaf[bidx, at] = torch.where(mask, new[:, 0], old).to(leaf.dtype)


def _local_valid(S: int, offset: int, pos: torch.Tensor) -> torch.Tensor:
    """Which of this rank's positions ``offset + [0, S)`` a query at ``pos``
    reads (``<= pos``): ``(1, S)`` for a scalar ``pos``, ``(B, S)`` for
    per-row positions."""
    steps = offset + torch.arange(S, device=pos.device)
    return steps[None, :] <= (pos if pos.dim() == 0 else pos[:, None])


def _combine(logits: torch.Tensor, values) -> torch.Tensor:
    """Softmax-weighted values over a sequence split across the sequence
    axes, flash-decoding style: ``logits (..., S_local)`` fp32, masked with
    -1e30 (as `sdpa`); ``values(p)``: the weighted sum of this rank's values
    by ``p`` (fp32), ``(..., Dv)``. The row maximum is taken over every
    rank's positions (`ctx.seq_max`); then ``Σ exp(s − m)`` and
    ``Σ exp(s − m)·v`` are summed over the axes in one all-reduce
    (`ctx.seq_sum`), in fp32. A rank whose positions are all masked adds
    exactly 0: position 0 lies on the first rank, so the maximum is finite
    and ``exp(-1e30 − m)`` is 0."""
    m = ctx.seq_max(logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - m)
    acc = ctx.seq_sum(torch.cat([values(p).float(), p.sum(dim=-1, keepdim=True)], dim=-1))
    return acc[..., :-1] / acc[..., -1:]


def _heads_for_seq(hq: int, total: int) -> bool:
    """Whether a decode over the sequence shard gathers the query over its
    heads: the rank holds ``hq`` of ``total`` heads on the tensor axis, and
    that axis also cuts the sequence (TRAP: combining over it would add
    different heads together). The query is gathered (it is tiny), every
    head attends over the local positions, and the rank keeps its own heads
    for the out-projection, as the reference's partitioner does."""
    return hq < total and ctx.tp_axis() in ctx.seq_axes()


def _gqa_decode_seq(q, k_cache, v_cache, k, v, pos, *, scale, kv_index, gather, heads):
    """GQA decode over this rank's piece of the cache's sequence: the new
    K/V written where ``pos`` falls, ``q (B, 1, hq, D)`` attending over the
    local positions below ``pos + 1``, combined over the sequence axes
    (`_combine`). ``kv_index``: the cache's K/V head each of this rank's q
    slots reads (`_kv_heads_read`); ``gather``: `_heads_for_seq`, the
    query then gathered over every rank's slots, the ``heads`` real ones
    attending over every K/V head in their groups, a padding slot's output
    0, and the rank keeping its own slots. Returns ``(B, 1, hq, Dv)``."""
    _, index = ctx.seq_piece()
    S = k_cache.shape[1]
    offset = index * S
    _write_local(k_cache, k, pos, offset)
    _write_local(v_cache, v, pos, offset)
    B, Q, hq, D = q.shape
    if gather:
        q = ctx.tp_gather(q, 2)[:, :, :heads]
    else:
        k_cache, v_cache = _take_kv(k_cache, kv_index), _take_kv(v_cache, kv_index)
    if k_cache.dtype != q.dtype:    # low-precision cache: upcast for the math
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    Hq, Hkv = q.shape[2], k_cache.shape[2]
    qg = q.reshape(B, Q, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bshd->bhgqs", qg, k_cache).float() * scale
    valid = _local_valid(S, offset, pos)
    logits = torch.where(valid[:, None, None, None, :], logits, -1e30)
    # the weights meet the values in the values' dtype, as in `sdpa`
    out = _combine(logits, lambda p: torch.einsum("bhgqs,bshd->bhgqd", p.to(v_cache.dtype),
                                                  v_cache))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, v_cache.shape[-1]).to(q.dtype)
    if gather:
        n, r = ctx.tp()
        if n * hq > heads:      # padding slots: zero out-projection rows
            out = torch.cat([out, out.new_zeros((B, Q, n * hq - heads, out.shape[-1]))], 2)
        out = out[:, :, r * hq:(r + 1) * hq]
    ctx.note_seq("attn")
    return out


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------


def gqa_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Per-layer ``{name: (shape, std)}``; std None is the fan-in rule."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": ((d, hq * hd), None),
        "wk": ((d, hkv * hd), None),
        "wv": ((d, hkv * hd), None),
        "wo": ((hq * hd, d), (hq * hd) ** -0.5 / math.sqrt(2 * cfg.num_layers)),
    }


def _positional_cos_sin(cfg: ModelConfig, positions: torch.Tensor
                        ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    hd = cfg.resolved_head_dim
    if cfg.pos_type == "rope":            # positions (S,) or (B, S)
        return rope_cos_sin(positions, hd, cfg.rope_theta)
    if cfg.pos_type == "mrope":           # positions (3, B, S)
        return mrope_cos_sin(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return None


def gqa_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                    # (B, S, d)
    *,
    positions: torch.Tensor,            # rope: (S,) or (B, S); mrope: (3, B, S)
    mode: str = "prefill",              # train | prefill | decode
    causal: bool = True,
    cache: Optional[Cache] = None,
    pos: Optional[torch.Tensor] = None,  # decode write position: scalar or (B,)
    entered: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """``entered``: ``x`` has entered the shards already (module notes)."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    # this rank's q and K/V heads: all of them, or its shard (`lm.tp_groups`)
    hq, hkv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    # the replicated x enters the shards' projections (`ctx.tp_branch`)
    xs = ctx.tp_branch(x, hq < cfg.num_heads, entered)
    q = (xs @ p["wq"]).reshape(B, S, hq, hd)
    xkv = xs if hkv < cfg.num_kv_heads else ctx.tp_branch(x, False, entered)
    k = (xkv @ p["wk"]).reshape(B, S, hkv, hd)
    v = (xkv @ p["wv"]).reshape(B, S, hkv, hd)

    cs = _positional_cos_sin(cfg, positions)
    if cs is not None:
        q = apply_rope(q, *cs)
        k = apply_rope(k, *cs)
    # the K/V head each of the rank's q slots reads (K/V computed on their
    # shards are its own already); those are gathered whole for the cache
    kv_index = _kv_heads_read(cfg, hq)
    if hkv < cfg.num_kv_heads:
        k_own, v_own = k, v
        if mode != "train":
            k, v = ctx.tp_gather(k, 2), ctx.tp_gather(v, 2)
    elif hq < cfg.num_heads:
        # TRAP, replicated leaves: K/V computed whole (replicated) enter
        # the q heads' shard before the rank's heads are read, so wk/wv
        # take every rank's part of their gradient
        k, v = ctx.tp_enter(k), ctx.tp_enter(v)
        k_own = _take_kv(k, kv_index).contiguous()
        v_own = _take_kv(v, kv_index).contiguous()
    else:
        k_own, v_own = k, v

    scale = hd ** -0.5
    if mode == "train":
        new_cache: Optional[Cache] = None
        out = _train_attn(q, k_own, v_own, scale=scale, causal=causal)
    elif mode == "prefill":
        new_cache = {"k": k, "v": v}
        out = _full_attn(q, k_own, v_own, scale=scale, causal=causal)
    elif mode == "decode":
        if cache is None or pos is None or S != 1:
            raise ValueError("decode needs a cache, a position and one token per row")
        pos = torch.as_tensor(pos, device=x.device)
        k_cache, v_cache = cache["k"], cache["v"]
        new_cache = cache
        if ctx.seq_axes():      # this rank's piece of the cache's sequence
            out = _gqa_decode_seq(q, k_cache, v_cache, k, v, pos, scale=scale,
                                  kv_index=kv_index, gather=_heads_for_seq(hq, cfg.num_heads),
                                  heads=cfg.num_heads)
        else:
            if pos.dim() == 0:  # one position for the whole batch (indexed by a
                at = pos.reshape(1).long()   # tensor: no read of pos on the host)
                k_cache[:, at] = k.to(k_cache.dtype)
                v_cache[:, at] = v.to(v_cache.dtype)
            else:               # per-slot positions (serving engine)
                bidx = torch.arange(B, device=x.device)
                k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
                v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
            k_cache, v_cache = _take_kv(k_cache, kv_index), _take_kv(v_cache, kv_index)
            out = sdpa(q, k_cache, v_cache, scale=scale, causal=False, kv_len=pos + 1)
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")

    out = out.reshape(B, S, hq * hd) @ p["wo"]
    return out, new_cache


def _kv_heads_read(cfg: ModelConfig, hq: int) -> Optional[Tuple[int, ...]]:
    """The K/V head of the whole set (the cache's) each of this rank's
    ``hq`` q head slots reads: GQA maps q head ``h`` to K/V head
    ``h // (Hq / Hkv)``, and a padding slot (``>= Hq``, `ctx.head_slots`)
    reads head 0. The rank's slots are its run from `ctx.head_slots` (its
    even shard where the heads divide); None where ``hq`` is every head
    (each reads its own group)."""
    H = cfg.num_heads
    if hq == H:
        return None
    group = H // cfg.num_kv_heads
    first = ctx.head_slots(H)[1]
    return tuple(h // group if h < H else 0 for h in range(first, first + hq))


def _take_kv(t: torch.Tensor, index: Optional[Tuple[int, ...]]) -> torch.Tensor:
    """The K/V heads (dim 2) of ``t`` as the q slots of ``index`` read them
    (`_kv_heads_read`), in the grouping `sdpa` and the flash kernel take (q
    slot ``j`` reads K/V head ``j // (slots / heads)``): ``t`` itself where
    the slots are every head or read all of ``t``'s heads in order, a slice
    of ``t`` where they read a run of its heads in equal groups, else one
    K/V head per slot (`index_select`, attention then MHA): contiguous
    slots can straddle a K/V group unevenly, which no grouping
    expresses."""
    if index is None:
        return t
    hq, k0 = len(index), index[0]
    heads = index[-1] - k0 + 1
    if hq % heads == 0 and index == tuple(k0 + j // (hq // heads) for j in range(hq)):
        return t if (k0 == 0 and heads == t.shape[2]) else t[:, :, k0:k0 + heads]
    return t.index_select(2, torch.tensor(index, dtype=torch.long, device=t.device))


# ---------------------------------------------------------------------------
# cross-attention (the Whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """The reference's ``init_cross_attn``: a GQA layer's projections."""
    return gqa_shapes(cfg)


def cross_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                            # (B, S_dec, d)
    *,
    enc_out: Optional[torch.Tensor] = None,     # (B, S_enc, d): train, prefill
    cache: Optional[Cache] = None,              # decode: the encoder's K/V
    mode: str = "prefill",                      # train | prefill | decode
    entered: bool = False,
    enc_entered: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Bidirectional attention of the decoder over the encoder output, in
    plain `sdpa`. Without ``cache`` it projects ``enc_out`` to K/V and
    returns them as the new cache (computed once, at prefill; none in
    train); with one it reads the cached K/V and returns the cache as it is.

    On a rank whose projections are its head shards or its padded head
    slots (`lm.tp_groups`), ``q`` comes from its ``wq`` columns, K/V from
    its ``wk``/``wv`` columns over the replicated ``enc_out`` (which enters
    the shard through `ctx.tp_enter`, so that ``wk``/``wv`` take every
    rank's part of its gradient) or whole, and the output is its partial
    ``wo`` product. The cache stays whole over the heads, as the
    reference's specs keep it: prefill gathers the new K/V heads for it,
    and decode reads the heads the rank's slots read (`_kv_heads_read`).
    ``entered`` / ``enc_entered``: ``x`` / ``enc_out`` has entered the
    shards already (a sequence-parallel train step; `ctx.tp_branch`).

    Raises:
        ValueError: neither ``enc_out`` nor ``cache`` is given.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    xs = ctx.tp_branch(x, hq < cfg.num_heads, entered)
    q = (xs @ p["wq"]).reshape(B, S, hq, hd)
    kv_index = _kv_heads_read(cfg, hq)
    if cache is None:
        if enc_out is None:
            raise ValueError("cross-attention needs the encoder output or its cache")
        F_enc = enc_out.shape[1]
        es = ctx.tp_branch(enc_out, hkv < cfg.num_kv_heads, enc_entered)
        k = (es @ p["wk"]).reshape(B, F_enc, hkv, hd)
        v = (es @ p["wv"]).reshape(B, F_enc, hkv, hd)
        if hkv < cfg.num_kv_heads:
            k_own, v_own = k, v
            if mode != "train":
                k, v = ctx.tp_gather(k, 2), ctx.tp_gather(v, 2)
        elif hq < cfg.num_heads:
            # TRAP, replicated leaves: as in `gqa_attention`
            k, v = ctx.tp_enter(k), ctx.tp_enter(v)
            k_own = _take_kv(k, kv_index).contiguous()
            v_own = _take_kv(v, kv_index).contiguous()
        else:
            k_own, v_own = k, v
        cache = None if mode == "train" else {"k": k, "v": v}
    else:
        k_own, v_own = _take_kv(cache["k"], kv_index), _take_kv(cache["v"], kv_index)
    out = sdpa(q, k_own, v_own, scale=hd ** -0.5, causal=False)
    return out.reshape(B, S, hq * hd) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], object]]:
    """Per-layer ``{name: (shape, std)}`` in the reference's key order
    (``init_mla``); std None is the fan-in rule, "norm" a norm's ``(dim,)``."""
    m = cfg.mla or MLAConfig()
    d, hq = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ((d, m.q_lora_rank), None),
        "q_norm": ((m.q_lora_rank,), "norm"),
        "w_uq": ((m.q_lora_rank, hq * qk_head), None),
        "w_dkv": ((d, m.kv_lora_rank + m.qk_rope_head_dim), None),
        "kv_norm": ((m.kv_lora_rank,), "norm"),
        "w_uk": ((m.kv_lora_rank, hq * m.qk_nope_head_dim), None),
        "w_uv": ((m.kv_lora_rank, hq * m.v_head_dim), None),
        "wo": ((hq * m.v_head_dim, d),
               (hq * m.v_head_dim) ** -0.5 / math.sqrt(2 * cfg.num_layers)),
    }


def _mla_heads(cfg: ModelConfig, p: dict) -> int:
    """This rank's MLA heads: all of them, or its shard of the tensor axis,
    or its padded head slots (``w_uk``'s width, `lm.tp_groups`; a padding
    slot's ``w_uq``/``w_uk``/``w_uv`` columns and ``wo`` rows are zero, so
    its part of the output is exactly 0)."""
    m = cfg.mla or MLAConfig()
    return p["w_uk"].shape[1] // m.qk_nope_head_dim


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    m = cfg.mla or MLAConfig()
    B, S, _ = x.shape
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = rmsnorm(x @ p["w_dq"], p["q_norm"]["scale"], cfg.norm_eps)
    if _mla_heads(cfg, p) < cfg.num_heads:
        q_lat = ctx.tp_enter(q_lat)
    q = (q_lat @ p["w_uq"]).reshape(B, S, _mla_heads(cfg, p), qk_head)
    q_nope, q_pe = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_pe, cos, sin)


def _mla_latent_kv(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    m = cfg.mla or MLAConfig()
    ckv_kpe = x @ p["w_dkv"]
    ckv = rmsnorm(ckv_kpe[..., : m.kv_lora_rank], p["kv_norm"]["scale"], cfg.norm_eps)
    kpe = apply_rope(ckv_kpe[..., m.kv_lora_rank:][:, :, None, :], cos, sin)[:, :, 0, :]
    return ckv, kpe                       # kpe: one rotary head shared by all


def _mla_expand(cfg: ModelConfig, p: dict, q_nope, q_pe, ckv, kpe):
    """The expanded form: per-head K (nope | shared rope part) and V from
    the latent, and Q as (nope | rope)."""
    m = cfg.mla or MLAConfig()
    B, S = ckv.shape[:2]
    hq = _mla_heads(cfg, p)
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, hq, m.qk_nope_head_dim)
    v = (ckv @ p["w_uv"]).reshape(B, S, hq, m.v_head_dim)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, hq, m.qk_rope_head_dim)], dim=-1)
    return torch.cat([q_nope, q_pe], dim=-1), k, v


def _mla_decode(cfg: ModelConfig, p: dict, q_nope, q_pe, cache: Cache, ckv_new, kpe_new,
                pos: torch.Tensor, *, scale: float) -> torch.Tensor:
    """MLA's absorbed decode over the whole cache: the new latent entry
    written at ``pos`` IN PLACE, the query projected into the latent space
    attending over the ``R + Dr``-wide cache. Returns ``(B, 1, hq, Dv)``."""
    m = cfg.mla or MLAConfig()
    B, hq = q_nope.shape[0], q_nope.shape[2]
    ckv, kpe = cache["ckv"], cache["kpe"]
    S_max = ckv.shape[1]
    steps = torch.arange(S_max, device=pos.device)
    if pos.dim() == 0:      # one position for the whole batch
        at = pos.reshape(1).long()
        ckv[:, at] = ckv_new.to(ckv.dtype)
        kpe[:, at] = kpe_new.to(kpe.dtype)
        valid = (steps <= pos)[None, None, None, :]
    else:                   # per-slot positions (serving engine)
        bidx = torch.arange(B, device=pos.device)
        ckv[bidx, pos] = ckv_new[:, 0].to(ckv.dtype)
        kpe[bidx, pos] = kpe_new[:, 0].to(kpe.dtype)
        valid = (steps[None, :] <= pos[:, None])[:, None, None, :]    # (B,1,1,S)
    if ckv.dtype != q_nope.dtype:   # low-precision cache: upcast for the math
        ckv, kpe = ckv.to(q_nope.dtype), kpe.to(q_nope.dtype)
    # q_nope (B,1,H,Dn) through w_uk per head -> latent query (B,1,H,R)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, hq, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_pe, kpe)).float() * scale
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(ckv.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv)                # (B,1,H,R)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, hq, m.v_head_dim)
    return torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)


def _mla_decode_seq(cfg: ModelConfig, p: dict, q_nope, q_pe, cache: Cache, ckv_new, kpe_new,
                    pos: torch.Tensor, *, scale: float, gather: bool) -> torch.Tensor:
    """`_mla_decode` over this rank's piece of the latent cache's sequence:
    the new entry written where ``pos`` falls, the latent query and its
    rotary part against the local positions, ``o_lat`` combined over the
    sequence axes (`_combine`) before ``w_uv``. ``gather``: the query's
    ``(B, 1, H, R + Dr)`` gathered over every rank's head slots (padding
    included) and the rank's own slots kept after the combine
    (`_heads_for_seq`). Returns ``(B, 1, hq, Dv)``."""
    m = cfg.mla or MLAConfig()
    R = m.kv_lora_rank
    B, Q, hq = q_nope.shape[:3]
    ckv, kpe = cache["ckv"], cache["kpe"]
    _, index = ctx.seq_piece()
    S = ckv.shape[1]
    offset = index * S
    _write_local(ckv, ckv_new, pos, offset)
    _write_local(kpe, kpe_new, pos, offset)
    if ckv.dtype != q_nope.dtype:   # low-precision cache: upcast for the math
        ckv, kpe = ckv.to(q_nope.dtype), kpe.to(q_nope.dtype)
    w_uk = p["w_uk"].reshape(R, hq, m.qk_nope_head_dim)
    q_all = torch.cat([torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk), q_pe], dim=-1)
    if gather:
        q_all = ctx.tp_gather(q_all, 2)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_all[..., :R], ckv)
              + torch.einsum("bqhd,bsd->bhqs", q_all[..., R:], kpe)).float() * scale
    valid = _local_valid(S, offset, pos)
    logits = torch.where(valid[:, None, None, :], logits, -1e30)
    o_lat = _combine(logits, lambda w: torch.einsum("bhqs,bsr->bhqr", w.to(ckv.dtype), ckv))
    o_lat = o_lat.transpose(1, 2).to(q_nope.dtype)                # (B,1,H,R)
    if gather:
        r = ctx.tp()[1]
        o_lat = o_lat[:, :, r * hq:(r + 1) * hq]
    ctx.note_seq("mla")
    w_uv = p["w_uv"].reshape(R, hq, m.v_head_dim)
    return torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)


def mla_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                    # (B, S, d)
    *,
    positions: torch.Tensor,            # (S,) or (B, S)
    mode: str = "prefill",              # train | prefill | decode
    cache: Optional[Cache] = None,
    pos: Optional[torch.Tensor] = None,  # decode write position: scalar or (B,)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """MLA with a latent-compressed cache. Train and prefill use the
    expanded form (materialised K/V) through plain `sdpa`, chunked from
    `FLASH_THRESHOLD` on; prefill returns the latent ``ckv``/``kpe``, train
    no cache. Decode writes the new latent
    entry into ``cache`` IN PLACE and runs the *absorbed* form:
    the query is projected into the latent space and attends over the
    ``R + Dr``-wide cache directly (no per-step K/V re-expansion)."""
    m = cfg.mla or MLAConfig()
    B, S, _ = x.shape
    hq = _mla_heads(cfg, p)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    # rotary over the whole qk_rope_head_dim
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_pe = _mla_q(cfg, p, x, cos, sin)

    if mode in ("train", "prefill"):
        ckv, kpe = _mla_latent_kv(cfg, p, x, cos, sin)
        new_cache: Optional[Cache] = {"ckv": ckv, "kpe": kpe} if mode == "prefill" else None
        if hq < cfg.num_heads:     # the whole latent enters the rank's heads
            ckv, kpe = ctx.tp_enter(ckv), ctx.tp_enter(kpe)
        q, k, v = _mla_expand(cfg, p, q_nope, q_pe, ckv, kpe)
        if S >= FLASH_THRESHOLD:
            # v's head dim differs from q's: pad it for the chunked path
            dv = m.v_head_dim
            v_pad = torch.nn.functional.pad(v, (0, q.shape[-1] - dv))
            q = constrain(q, "batch", "seq", None, None)
            k = constrain(k, "batch", None, None, None)
            v_pad = constrain(v_pad, "batch", None, None, None)
            out = flash_attention_ref(q, k, v_pad, causal=True, scale=scale)[..., :dv]
            out = constrain(out, "batch", "seq", None, None)
        else:
            out = sdpa(q, k, v, scale=scale, causal=True)
    elif mode == "decode":
        if cache is None or pos is None or S != 1:
            raise ValueError("decode needs a cache, a position and one token per row")
        ckv_new, kpe_new = _mla_latent_kv(cfg, p, x, cos, sin)
        pos = torch.as_tensor(pos, device=x.device)
        new_cache = cache
        if ctx.seq_axes():      # this rank's piece of the cache's sequence
            out = _mla_decode_seq(cfg, p, q_nope, q_pe, cache, ckv_new, kpe_new, pos,
                                  scale=scale, gather=_heads_for_seq(hq, cfg.num_heads))
        else:
            out = _mla_decode(cfg, p, q_nope, q_pe, cache, ckv_new, kpe_new, pos, scale=scale)
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")

    out = out.reshape(B, S, hq * m.v_head_dim)
    return out @ p["wo"], new_cache
