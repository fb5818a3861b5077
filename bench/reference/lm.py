"""The plain fp32 reference of the decoder-only LMs the benchmark serves
(Qwen1.5-MoE-A2.7B and Minitron-4B), teacher-forced over whole sequences.

It reads the weights the benchmark made (`bench.weights.make_params`) by
name and the sizes of a config file's ``model`` section, and computes the
model as the repo's reference model (the JAX package) defines it, in
float32 with TF32 off: pre-norm residual layers (RMSNorm, or LayerNorm with
a bias), GQA attention with rotary embeddings on the whole head (the NeoX
half rotation), causal; a gated SiLU or squared-ReLU MLP, or the MoE: a
float32 softmax router, top-k, and the grouped capacity rule (below) on
the prompt's tokens; the shared expert added ungated; the LM head over the
real vocabulary.

Departures from the published models, all of the repo's model definition
(the program computes the same): Qwen1.5-MoE's q/k/v biases and its
shared expert's sigmoid gate are absent, the experts are padded to 64
(the four extra never routed), the vocabulary to a multiple of 256 (the
padded logits never read); Minitron-4B's LayerNorm is the plain one (not
"1 + gamma"), and its rotary embedding covers the whole head (published:
half of it).

MoE capacity. A prefill routes its launched tokens (the prompt, padded to
its bucket where it took one) in groups of ``g = min(1024, L)`` tokens;
where ``g > 512`` an expert takes at most ``ceil(g k / E *
capacity_factor)`` (token, slot) pairs of a group, in token order and, in
a token, in the order of its picks, and a pair past that is dropped (its
weight counts 0). The padding follows the prompt, so only the prompt's
own tokens decide its drops; the reference applies the rule to the prompt
with the ``g`` of its launched length. A decode step's group is the batch
of one token a lane (64 or fewer): never a drop.

The control (`precision="fp8"`) computes the same in float8 e4m3: every
matmul's weight and input rounded to it with one scale a tensor (its
largest magnitude to 448), accumulated in float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

GROUP_SIZE = 1024
EXACT_SMALL_G = 512
FP8_MAX = 448.0


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the body (matmuls and convolutions in full fp32)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    to 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _prec(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "fp32":
        return lambda x: x
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"unknown precision {precision!r}")


def capacity(g: int, m: Dict[str, Any]) -> int:
    """Pairs an expert takes of a group of ``g`` tokens."""
    moe = m["moe"]
    if g <= EXACT_SMALL_G:
        return g
    return min(max(1, math.ceil(g * moe["top_k"] / moe["num_experts"]
                                * moe.get("capacity_factor", 1.25))), g)


def keep_mask(idx: torch.Tensor, n_prompt: int, launched: int, m: Dict[str, Any]) -> torch.Tensor:
    """``(N, k)`` bool: which (token, pick) pairs count. ``idx`` ``(N, k)``
    expert ids of a sequence whose first ``n_prompt`` tokens were
    prefilled at the launched length ``launched``; the tokens after them
    were decoded (never dropped)."""
    keep = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    g = min(GROUP_SIZE, launched)
    cap = capacity(g, m)
    if cap >= g:
        return keep
    E, k = m["moe"]["num_experts"], idx.shape[1]
    for s in range(0, n_prompt, g):
        grp = idx[s:min(s + g, n_prompt)]
        one = torch.nn.functional.one_hot(grp.reshape(-1), E).to(torch.int64)
        before = (torch.cumsum(one, dim=0) - one).gather(1, grp.reshape(-1, 1))
        keep[s:s + grp.shape[0]] = (before.reshape(-1, k) < cap)
    return keep


def _norm(m: Dict[str, Any], p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    eps = m.get("norm_eps", 1e-5)
    scale = p["scale"].float()
    if m["norm_type"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * scale + p["bias"].float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` ``(N, H, D)`` at positions 0..N-1, rotated in halves."""
    N, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(N, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(m, p, h, q8) -> torch.Tensor:
    N = h.shape[0]
    hq, hkv, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    hh = q8(h)
    q = _rope((hh @ p["wq"]).reshape(N, hq, D), m["rope_theta"])
    k = _rope((hh @ p["wk"]).reshape(N, hkv, D), m["rope_theta"])
    v = (hh @ p["wv"]).reshape(N, hkv, D)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty(N, hq, D, dtype=torch.float32, device=h.device)
    mask = torch.ones(N, N, dtype=torch.bool, device=h.device).tril()
    for h0 in range(0, hq, 8):              # a few heads at a time: N x N scores each
        hs = slice(h0, min(h0 + 8, hq))
        s = torch.einsum("qhd,khd->hqk", q8(q[:, hs]), q8(k[:, hs])) * D ** -0.5
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[:, hs] = torch.einsum("hqk,khd->qhd", q8(s), q8(v[:, hs]))
    return q8(out.reshape(N, hq * D)) @ p["wo"]


def _act(m, a: torch.Tensor) -> torch.Tensor:
    if m["mlp_act"] == "relu2":
        return torch.relu(a).square()
    if m["mlp_act"] == "silu":
        return torch.nn.functional.silu(a)
    raise ValueError(f"unknown activation {m['mlp_act']!r}")


def _mlp(m, p, h, q8) -> torch.Tensor:
    hh = q8(h)
    if m["mlp_act"] == "silu":
        a = _act(m, hh @ p["w_gate"]) * (hh @ p["w_up"])
    else:
        a = _act(m, hh @ p["w_up"])
    return q8(a) @ p["w_down"]


def _moe(m, p, h, keep_fn, q8) -> torch.Tensor:
    moe = m["moe"]
    probs = torch.softmax(q8(h) @ p["router"], dim=-1)
    w, idx = torch.topk(probs, moe["top_k"], dim=-1)
    if moe.get("norm_topk_prob"):
        w = w / w.sum(-1, keepdim=True)
    w = w * keep_fn(idx).to(w.dtype)
    out = torch.zeros_like(h)
    for e in range(moe["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        pe = {k: p[k][e] for k in ("w_gate", "w_up", "w_down") if k in p}
        out.index_add_(0, tok, _mlp(m, pe, h[tok], q8) * w[tok, slot][:, None])
    if moe.get("num_shared_experts"):
        out = out + _mlp(m, p["shared"], h, q8)
    return out


def _layer_weights(tree: Any, i: int, prec) -> Any:
    """Layer ``i`` of the stacked weights, in float32 (rounded as the
    precision rounds a weight: per expert for the experts' stacks)."""
    if isinstance(tree, dict):
        return {k: _layer_weights(v, i, prec) for k, v in tree.items()}
    w = tree[i].float()
    if w.dim() == 3:                      # (E, in, out): one scale an expert
        return torch.stack([prec(x) for x in w])
    return prec(w) if w.dim() == 2 else w


def logits_at(model: Dict[str, Any], params: Dict[str, Any], seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], n_prompt: Sequence[int],
              launched: Sequence[int], *, precision: str = "fp32",
              on_logits: Optional[Callable[[int, torch.Tensor], None]] = None
              ) -> List[torch.Tensor]:
    """Run each sequence (``(N,)`` token ids, on the weights' device)
    through the model and hand ``on_logits(i, logits)`` the real-vocab
    logits ``(len(positions[i]), V)`` at ``positions[i]`` (returned as
    well when no callback is given). ``n_prompt[i]`` and ``launched[i]``
    set the MoE's capacity (module doc). Layer by layer over all the
    sequences, one layer's weights in float32 at a time."""
    m = model
    q8 = _prec(precision)
    out: List[torch.Tensor] = []
    with full_fp32(), torch.no_grad():
        xs = [params["embed"][s].float() for s in seqs]
        lay = params["layers"]
        for i in range(m["num_layers"]):
            p = _layer_weights(lay, i, q8)
            for j, x in enumerate(xs):
                x = x + _attention(m, p["mixer"], _norm(m, p["mixer_norm"], x), q8)
                h = _norm(m, p["ffn_norm"], x)
                if m.get("moe"):
                    keep = lambda idx, j=j: keep_mask(idx, n_prompt[j], launched[j], m)  # noqa: E731
                    x = x + _moe(m, p["ffn"], h, keep, q8)
                else:
                    x = x + _mlp(m, p["ffn"], h, q8)
                xs[j] = x
            del p
        head = params["lm_head"][:, : m["vocab_size"]].float()
        head = q8(head)
        for j, x in enumerate(xs):
            hf = _norm(m, params["final_norm"], x[positions[j]])
            logits = q8(hf) @ head
            if on_logits is None:
                out.append(logits)
            else:
                on_logits(j, logits)
    return out
