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


def heads_of_groups(t: torch.Tensor, rep: int) -> torch.Tensor:
    """``(..., G, N)`` -> ``(..., G * rep, N)``: head h reads group
    ``h // rep`` (`repeat_interleave`, written as a broadcast so that it
    never reads a count back to the host, and a CUDA graph can hold it)."""
    *lead, G, N = t.shape
    return t[..., None, :].expand(*lead, G, rep, N).reshape(*lead, G * rep, N)


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """Segment sums from inclusive prefix sums ``cs`` of x: ``out[..., i,
    j] = cs[..., i] - cs[..., j] = sum_{j < t <= i} x[..., t]``,
    lower-triangular, -inf above the diagonal (so its exp is exactly 0 and
    never overflows)."""
    T = cs.shape[-1]
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((T, T), dtype=torch.bool, device=cs.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_scan_ref(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H) fp32, after softplus
    A: torch.Tensor,        # (H,) fp32, negative
    B_mat: torch.Tensor,    # (B, S, G, N)
    C_mat: torch.Tensor,    # (B, S, G, N)
    *,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,     # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 chunked SSD scan -> (y ``(B, S, H, P)`` in x's dtype, final
    state ``(B, H, P, N)`` fp32). Head h reads B/C group ``h // (H / G)``.
    S is zero-padded to the chunk: dt = 0 there, so the decay is 1 and the
    state gains nothing, which makes the padding exact. Everything after the
    inputs is fp32: the intra-chunk ``exp(segsum)``-masked ``C Bᵀ`` term,
    the chunk states, and the inter-chunk recurrence (a loop over chunks).
    As in the TPU kernel, the segment sums are differences of the one
    prefix sum ``dA_cum`` that the state decays use too."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    S_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))
        S += pad
    nc = S // chunk
    rep = H // G

    xc = x.reshape(Bb, nc, chunk, H, P).float()
    dtc = dt.reshape(Bb, nc, chunk, H).float()
    Bc = heads_of_groups(B_mat.reshape(Bb, nc, chunk, G, N).float(), rep)
    Cc = heads_of_groups(C_mat.reshape(Bb, nc, chunk, G, N).float(), rep)

    dA = dtc * A.float()                                       # (B, nc, L, H)
    dA_cum = torch.cumsum(dA, dim=2)
    dtx = xc * dtc[..., None]                                  # (B, nc, L, H, P)

    # intra-chunk (diagonal blocks)
    decay = torch.exp(_segsum(dA_cum.movedim(-1, -2)))         # (B, nc, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * decay, dtx)

    # each chunk's own state contribution
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (B, nc, L, H)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc * decay_states[..., None], dtx)

    # inter-chunk recurrence: h entering chunk c, then the final state
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (B, nc, H)
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B, nc, H, P, N)

    state_decay = torch.exp(dA_cum)                            # (B, nc, L, H)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc * state_decay[..., None], h_prev)

    y = (y_diag + y_off).reshape(Bb, S, H, P)[:, :S_orig]
    return y.to(x.dtype), h
