"""Whisper-style encoder-decoder backbone.

The audio frontend (log-mel and conv) is a stub, as in the reference: the
inputs are precomputed frame embeddings ``(B, F, d_model)``. The encoder adds
sinusoidal positions and attends bidirectionally; the decoder adds learned
positions and runs causal self-attention with a KV cache, then
cross-attention whose K/V are computed from the encoder output once, at
prefill, and cached.

Parameters keep the reference's layout: ``enc_layers`` and ``dec_layers``
stacked over their layers. The cache is one flat dict, as the decoder-only
model's: ``self/k``, ``self/v`` ``(L, B, S_max, Hkv, Dh)`` and ``cross/k``,
``cross/v`` ``(L, B, S_enc, Hkv, Dh)``. Causal prefill of the decoder goes
through the flash kernel; the encoder, cross-attention, decode and training
run plain ops, as the reference's do.

In a tensor-parallel step (`sharding.ctx.tp`) every sub-layer follows the
decoder-only models' rule (`lm.tp_groups`): the encoder's attention and
MLP, the decoder's self-attention, cross-attention and MLP each run on this
rank's shard of the tensor axis where the dim they split divides it
(heads, ``d_ff``), each attention on its padded head slots where its heads
do not divide it (the cross cache stays whole over the heads), the
embedding and the tied head on the rank's vocab rows, and each partial
output is summed once at its residual add.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import mlp as ffn
from repro_torch.models.common import (
    dtype_of,
    norm_shapes,
    padded_vocab,
    param_dtype_of,
    sinusoidal_positions,
)
from repro_torch.models.lm import Cache, Leaf, Params
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import constrain


def param_layout(cfg: ModelConfig, max_seq: Optional[int] = None) -> Params:
    """The parameter tree as `Leaf` specs, key for key the reference's
    ``encdec.init_params`` pytree; ``pos_embed`` has ``max_seq`` rows
    (``min(max_seq_len, 32768)`` by default)."""
    pd = param_dtype_of(cfg)
    d = cfg.d_model
    max_seq = max_seq or min(cfg.max_seq_len, 32_768)

    def stack(n, shapes):
        return {k: Leaf((n,) + tuple(s), pd, std, stacked=True) for k, (s, std) in shapes.items()}

    def norm(n=None):
        shapes = {k: (s, "ones" if k == "scale" else "zeros")
                  for k, s in norm_shapes(cfg, d).items()}
        if n is None:
            return {k: Leaf(s, pd, init) for k, (s, init) in shapes.items()}
        return stack(n, shapes)

    L_enc, L_dec = cfg.encdec.num_encoder_layers, cfg.num_layers
    return {
        "embed": Leaf((padded_vocab(cfg.vocab_size), d), pd, "embed"),
        "pos_embed": Leaf((max_seq, d), pd, "embed"),
        "enc_layers": {
            "attn_norm": norm(L_enc),
            "attn": stack(L_enc, attn.gqa_shapes(cfg)),
            "mlp_norm": norm(L_enc),
            "mlp": stack(L_enc, ffn.mlp_shapes(cfg)),
        },
        "enc_norm": norm(),
        "dec_layers": {
            "self_norm": norm(L_dec),
            "self_attn": stack(L_dec, attn.gqa_shapes(cfg)),
            "cross_norm": norm(L_dec),
            "cross_attn": stack(L_dec, attn.cross_attn_shapes(cfg)),
            "mlp_norm": norm(L_dec),
            "mlp": stack(L_dec, ffn.mlp_shapes(cfg)),
        },
        "dec_norm": norm(),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, *, device: torch.device,
                max_seq: Optional[int] = None) -> Params:
    return lm.init_layout(param_layout(cfg, max_seq), gen, device=device)


def _checkpointed(fn, remat: bool):
    """``fn`` recomputed in backward (nothing saved inside) when ``remat``."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _run_stack(cfg: ModelConfig, layers: Params, stack: str, n: int, x, body, *,
               mode: str, remat: bool):
    """``x`` through the ``n`` layers of ``stack`` (``"enc_layers"`` or
    ``"dec_layers"``), ``x = body(lp, x, partial, i)`` for layer ``i``:
    ``partial`` says whether each sub-layer's output is a partial sum over
    the tensor axis (`lm.note_encdec`, counted once per forward). The
    groups of `lm.tp_groups` keep this rank's shard of the tensor axis, or
    its padded head slots (`lm.encdec_cut`); every other leaf is gathered
    whole, in
    serving a layer at a time as it is reached (`lm.layer_params`), in train
    inside the layer's step, recomputed in backward when ``remat``
    (`lm.train_steps`: the backward gathers the layer again, and no
    gathered layer is saved)."""
    groups = lm.tp_groups(cfg)
    cut, axis = lm.encdec_cut(cfg, stack, groups), ctx.tp_axis()
    if mode == "train":
        step = _checkpointed(lambda x, lp, gather, partial, i: body(gather(lp), x, partial, i),
                             remat)
        for i, (lp, gather) in enumerate(lm.train_steps(layers, cut, axis)):
            # TRAP, the recompute: counted here, not in the step that the
            # backward runs again
            x = step(x, lp, gather, lm.note_encdec(stack, groups), i)
        return x
    for i in range(n):
        lp = lm.layer_params(layers, i, cut, axis)
        x = body(lp, x, lm.note_encdec(stack, groups), i)
        del lp      # a gathered layer is freed before the next is gathered
    return x


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat: bool = True, mode: str = "train") -> torch.Tensor:
    """Stub frame embeddings ``(B, F, d)`` -> encoder output ``(B, F, d)``;
    ``mode`` "train" (each layer gathered in its own step, recomputed in
    backward when ``remat``) or "prefill". A sequence-parallel train step
    cuts the residual stream over the frames only where they divide the
    tensor axis (`ctx.sp_on`): else the encoder's stream stays whole while
    the decoder's is cut. Each norm of a cut stream runs on the rank's
    piece (`lm._norm`), the output made whole here (`ctx.sp_gather`;
    `train_loss` instead gathers it into the cross-attentions' shards,
    `_encoder_entry`)."""
    x, sp = _encoder(cfg, params, frames, remat=remat, mode=mode)
    return ctx.sp_gather(x, 1) if sp else x


def _encoder(cfg, params, frames, *, remat, mode) -> Tuple[torch.Tensor, bool]:
    """`encode`'s work: returns (the output after ``enc_norm``, whether the
    stream is cut: the output then this rank's piece of the frames)."""
    B, F_enc, d = frames.shape
    x = frames.to(dtype_of(cfg))
    x = x + sinusoidal_positions(F_enc, d, device=x.device).to(x.dtype)[None]
    positions = torch.arange(F_enc, dtype=torch.int32, device=x.device)
    sp = mode == "train" and ctx.sp_on(F_enc)

    def body(lp, x, partial, i):
        h = lm._enter(lm._norm(cfg, lp["attn_norm"], x, sp), sp, partial[0])
        out, _ = attn.gqa_attention(cfg, lp["attn"], h, positions=positions,
                                    mode="train", causal=False, entered=sp and partial[0])
        x = x + lm._exit(out, partial[0], sp)
        h = lm._enter(lm._norm(cfg, lp["mlp_norm"], x, sp), sp, partial[1])
        out = ffn.mlp(cfg, lp["mlp"], h, entered=sp and partial[1])
        return constrain(x + lm._exit(out, partial[1], sp), "batch", "sp", None)

    if sp:
        x = ctx.sp_cut(x, 1)
    x = _run_stack(cfg, params["enc_layers"], "enc_layers", cfg.encdec.num_encoder_layers, x,
                   body, mode=mode, remat=remat)
    return lm._norm(cfg, params["enc_norm"], x, sp), sp


def _encoder_entry(enc_out: torch.Tensor, enc_sp: bool, enter: bool) -> torch.Tensor:
    """The encoder's output as every decoder layer's cross-attention reads
    it: whole. ``enc_sp``: it is this rank's piece of the frames;
    ``enter``: a sequence-parallel decoder whose cross-attention computes
    its K/V on their shards. The output then enters those shards here, once
    for every layer (`ctx.sp_enter` from the piece, `ctx.tp_enter` where
    the frames stay whole), and no layer enters it again; otherwise the
    piece is gathered (`ctx.sp_gather`) and each layer that reads it on
    its shards enters it itself (K/V computed whole read it as it is)."""
    if enter:
        return ctx.sp_enter(enc_out, 1) if enc_sp else ctx.tp_enter(enc_out)
    return ctx.sp_gather(enc_out, 1) if enc_sp else enc_out


def _dec_layer(cfg, lp, x, *, positions, mode, self_cache, cross_cache, enc_out, pos,
               partial=(False, False, False), sp=False, enc_entered=False):
    """One decoder layer: returns (x, the new self cache, the new cross
    cache). ``partial`` and ``sp`` as `lm._run_layer` takes them, for the
    self-attention, the cross-attention and the MLP: a sub-layer whose
    output is a partial sum reads its normed input on its shards
    (`lm._enter`). ``enc_entered``: ``enc_out`` has entered the shards
    (`_encoder_entry`)."""
    h = lm._enter(lm._norm(cfg, lp["self_norm"], x, sp), sp, partial[0])
    out, new_self = attn.gqa_attention(cfg, lp["self_attn"], h, positions=positions,
                                       mode=mode, cache=self_cache, pos=pos,
                                       entered=sp and partial[0])
    x = x + lm._exit(out, partial[0], sp)
    h = lm._enter(lm._norm(cfg, lp["cross_norm"], x, sp), sp, partial[1])
    out, new_cross = attn.cross_attention(cfg, lp["cross_attn"], h, enc_out=enc_out,
                                          cache=cross_cache, mode=mode,
                                          entered=sp and partial[1], enc_entered=enc_entered)
    x = x + lm._exit(out, partial[1], sp)
    h = lm._enter(lm._norm(cfg, lp["mlp_norm"], x, sp), sp, partial[2])
    out = ffn.mlp(cfg, lp["mlp"], h, entered=sp and partial[2])
    return x + lm._exit(out, partial[2], sp), new_self, new_cross


def decode_stack(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                     # (B, S) int
    *,
    mode: str,                                # train | prefill | decode
    enc_out: Optional[torch.Tensor] = None,   # train, prefill
    cache: Optional[Cache] = None,            # decode
    pos: Optional[torch.Tensor] = None,       # decode position: scalar or (B,)
    remat: bool = True,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The decoder over ``tokens``: returns (hidden after ``dec_norm``,
    cache). Train mode returns no cache, each layer recomputed in backward
    when ``remat``; prefill returns the new cache (self K/V of the prompt and
    the cross K/V of ``enc_out``, in the activation dtype); decode writes
    the new self K/V entry into ``cache`` IN PLACE and returns it.

    In a tensor-parallel step (`ctx.tp`) the embedding may be this rank's
    vocab shard (the masked lookup, `lm._embed_lookup`; ``pos_embed`` stays
    whole), and each layer's groups run on their shards (`_run_stack`), each
    partial output summed once at its residual add (`lm._exit`). A
    sequence-parallel train step norms the rank's piece of the sequence
    and makes the hidden whole here (`ctx.sp_gather`; `train_loss` instead
    gathers it into the LM head's shard, `lm._head_input`).

    Raises:
        ValueError: an unknown ``mode``.
    """
    x, cache, sp = _decoder(cfg, params, tokens, mode=mode, enc_out=enc_out, cache=cache,
                            pos=pos, remat=remat)
    return (ctx.sp_gather(x, 1) if sp else x), cache


def _decoder(cfg, params, tokens, *, mode, enc_out, cache, pos, remat, enc_sp=False
             ) -> Tuple[torch.Tensor, Optional[Cache], bool]:
    """`decode_stack`'s work: returns (the hidden after ``dec_norm``, the
    cache, whether the decoder ran sequence-parallel: the hidden then this
    rank's piece of the sequence). ``enc_sp``: ``enc_out`` is this rank's
    piece of the frames (`_encoder`)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")
    B, S = tokens.shape
    groups = lm.tp_groups(cfg)
    ctx.note_tp("vocab", groups["vocab"])
    sp = mode == "train" and ctx.sp_on(S)
    x = lm._embed_lookup(params, tokens, padded_vocab(cfg.vocab_size), sp).to(dtype_of(cfg))
    if mode == "decode":
        p = torch.as_tensor(pos, device=x.device).long()
        if p.dim() == 0:
            pe = params["pos_embed"][p.reshape(1)][None]     # (1, 1, d)
            positions = p.expand(B)[:, None]
        else:                                                # per-slot positions
            pe = params["pos_embed"][p][:, None]             # (B, 1, d)
            positions = p[:, None]
        x = x + pe.to(x.dtype)
    else:
        pe = params["pos_embed"][:S][None]
        x = x + (ctx.sp_cut(pe, 1) if sp else pe).to(x.dtype)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    enc_entered = sp and groups["attn_kv"] == ctx.LOCAL
    if enc_out is not None:
        enc_out = _encoder_entry(enc_out, enc_sp, enc_entered)
    per_layer = []

    def body(lp, x, partial, i):
        sc = cc = None
        if mode == "decode":
            sc = {k: cache[f"self/{k}"][i] for k in "kv"}
            cc = {k: cache[f"cross/{k}"][i] for k in "kv"}
        x, new_self, new_cross = _dec_layer(
            cfg, lp, x, positions=positions, mode=mode, self_cache=sc, cross_cache=cc,
            enc_out=enc_out, pos=pos, partial=partial, sp=sp, enc_entered=enc_entered)
        if mode == "prefill":
            per_layer.append({**{f"self/{k}": v for k, v in new_self.items()},
                              **{f"cross/{k}": v for k, v in new_cross.items()}})
        return constrain(x, "batch", "sp" if mode == "train" else None, None)

    x = _run_stack(cfg, params["dec_layers"], "dec_layers", cfg.num_layers, x, body,
                   mode=mode, remat=remat)
    x = lm._norm(cfg, params["dec_norm"], x, sp)
    if mode == "prefill":
        cache = {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}
    return x, None if mode == "train" else cache, sp


def cache_shape(cfg: ModelConfig, batch: int, s_max: int, enc_len: int
                ) -> Dict[str, Tuple[int, ...]]:
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    self_shape = (L, batch, s_max, hkv, hd)
    cross_shape = (L, batch, enc_len, hkv, hd)
    return {"self/k": self_shape, "self/v": self_shape,
            "cross/k": cross_shape, "cross/v": cross_shape}


def init_cache(cfg: ModelConfig, batch: int, s_max: int, enc_len: int, *,
               dtype: torch.dtype = torch.bfloat16, device: torch.device) -> Cache:
    """Zeroed decode cache, bf16 by default, as in the reference."""
    return {k: torch.zeros(s, dtype=dtype, device=device)
            for k, s in cache_shape(cfg, batch, s_max, enc_len).items()}


def logits_fn(cfg: ModelConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden`` through the tied embedding's transpose (Whisper ties its
    embeddings): this rank's vocab columns where the embedding is its shard
    (`lm.logits_fn`)."""
    return lm.logits_fn(cfg, params, hidden)


def train_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
               loss_chunk: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch``: ``frames (B, F, d)``, ``tokens (B, S + 1)``, optionally
    ``loss_mask (B, S)``. Returns (ce, ``{"ce", "moe_aux"}``), the aux loss
    a zero scalar."""
    enc_out, enc_sp = _encoder(cfg, params, batch["frames"], remat=True, mode="train")
    tokens = batch["tokens"]
    hidden, _, sp = _decoder(cfg, params, tokens[:, :-1], mode="train", enc_out=enc_out,
                             cache=None, pos=None, remat=True, enc_sp=enc_sp)
    ce = lm.cross_entropy(cfg, params, lm._head_input(cfg, params, hidden, sp), tokens[:, 1:],
                          mask=batch.get("loss_mask"), chunk=loss_chunk, entered=sp)
    return ce, {"ce": ce, "moe_aux": torch.zeros((), dtype=torch.float32, device=ce.device)}


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Cache]:
    """``batch``: ``frames`` and ``tokens (B, S)``. Returns (last-token
    logits ``(B, V_pad)``, cache)."""
    enc_out = encode(cfg, params, batch["frames"], remat=False, mode="prefill")
    hidden, cache = decode_stack(cfg, params, batch["tokens"], mode="prefill",
                                 enc_out=enc_out, remat=False)
    return logits_fn(cfg, params, hidden[:, -1:, :])[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: Cache,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One step over ``tokens (B, 1)`` at ``pos``: returns (logits
    ``(B, V_pad)``, cache updated in place)."""
    hidden, cache = decode_stack(cfg, params, tokens, mode="decode", cache=cache, pos=pos,
                                 remat=False)
    return logits_fn(cfg, params, hidden[:, 0:1, :])[:, 0, :], cache
