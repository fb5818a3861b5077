"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its TPU kernel and its Hopper port. They
run for CPU tensors (the tests) and in ``chip_smoke.py``'s comparison on the
card, never on the card's serving path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last dim, in descending order, the lower
    index first among equal values (`jax.lax.top_k`'s order, which
    `torch.topk` does not promise). Returns (values, int64 indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def flash_attention_ref(
    q: torch.Tensor,            # (B, Sq, Hq, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention chunked over q and k -> ``(B, Sq, Hq, D)``
    in q's dtype. Inputs are widened to fp32 and everything after is fp32,
    the softmax weights included, as in the Pallas body."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    Sq_p = (Sq + q_chunk - 1) // q_chunk * q_chunk
    Sk_p = (Sk + k_chunk - 1) // k_chunk * k_chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, Sk_p - Sk))
    vp = F.pad(v, (0, 0, 0, 0, 0, Sk_p - Sk))
    nq, nk = Sq_p // q_chunk, Sk_p // k_chunk

    qh = qp.reshape(B, nq, q_chunk, Hkv, G, D)
    kh = kp.reshape(B, nk, k_chunk, Hkv, D)
    vh = vp.reshape(B, nk, k_chunk, Hkv, D)
    dev = q.device

    outs = []
    for qi in range(nq):
        q_blk = qh[:, qi].float()
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, q_chunk, D), dtype=torch.float32, device=dev)
        hi = min(nk, ((qi + 1) * q_chunk + k_chunk - 1) // k_chunk) if causal else nk
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        for ki in range(hi):
            k_blk, v_blk = kh[:, ki], vh[:, ki]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk.float()) * scale
            k_pos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            mask = k_pos[None, :] < Sk
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.movedim(3, 1))               # (B, qc, Hkv, G, D)
    out = torch.stack(outs, dim=1).reshape(B, Sq_p, Hq, D)[:, :Sq]
    return out.to(q.dtype)


def moe_topk_ref(logits: torch.Tensor, k: int, *, norm_topk: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` logits -> (weights ``(T, k)`` fp32, ids ``(T, k)`` int32):
    fp32 softmax, then the k largest, the lowest index first among equals."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, idx = top_k(probs, k)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx.to(torch.int32)
