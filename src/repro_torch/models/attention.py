"""GQA attention (MHA included) with an explicit KV cache.

Cache per layer: ``{"k": (B, S_max, Hkv, Dh), "v": (B, S_max, Hkv, Dh)}``.

Modes:
  prefill — full-sequence causal attention through the flash kernel,
            returns the new K/V
  decode  — q_len == 1 at per-row (or one shared) position ``pos``; writes
            the new K/V into the cache IN PLACE and attends over it with
            `sdpa` (the reference has no decode kernel either)
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import apply_rope, rope_cos_sin

Cache = Dict[str, torch.Tensor]


def _full_attn(q, k, v, *, scale, causal):
    """Causal attention goes to the flash kernel (its plain version on the
    CPU); bidirectional attention to `sdpa`."""
    if causal:
        return kops.flash_attention(q, k, v, causal=True, scale=scale)
    return sdpa(q, k, v, scale=scale, causal=False)


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


def gqa_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,                    # (B, S, d)
    *,
    positions: torch.Tensor,            # (S,) or (B, S)
    mode: str = "prefill",              # prefill | decode
    causal: bool = True,
    cache: Optional[Cache] = None,
    pos: Optional[torch.Tensor] = None,  # decode write position: scalar or (B,)
) -> Tuple[torch.Tensor, Optional[Cache]]:
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = (x @ p["wq"]).reshape(B, S, hq, hd)
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)

    if cfg.pos_type != "rope":
        raise NotImplementedError(f"pos_type {cfg.pos_type!r} is not ported yet")
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    scale = hd ** -0.5
    if mode == "prefill":
        new_cache: Optional[Cache] = {"k": k, "v": v}
        out = _full_attn(q, k, v, scale=scale, causal=causal)
    elif mode == "decode":
        if cache is None or pos is None or S != 1:
            raise ValueError("decode needs a cache, a position and one token per row")
        pos = torch.as_tensor(pos, device=x.device)
        k_cache, v_cache = cache["k"], cache["v"]
        if pos.dim() == 0:      # one position for the whole batch
            k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
        else:                   # per-slot positions (serving engine)
            bidx = torch.arange(B, device=x.device)
            k_cache[bidx, pos] = k[:, 0].to(k_cache.dtype)
            v_cache[bidx, pos] = v[:, 0].to(v_cache.dtype)
        new_cache = cache
        out = sdpa(q, k_cache, v_cache, scale=scale, causal=False, kv_len=pos + 1)
    else:
        raise ValueError(f"unknown mode {mode!r} (prefill | decode)")

    out = out.reshape(B, S, hq * hd) @ p["wo"]
    return out, new_cache
