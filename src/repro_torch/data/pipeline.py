"""Deterministic synthetic-LM data, made on the device.

Every batch is a pure function of ``(seed, step)``, drawn from the
reference's counter-based threefry stream (`data.threefry`) with its key
law, so the port's batches are the reference's bit for bit: content ids
``2 + (V - 2) u**4`` (a skewed unigram a model can learn), a document
boundary (BOS) at each position with probability ``1 / mean_doc_len``, and
a loss mask over the targets that are not BOS. A restart from a checkpoint
resumes the exact stream (only the step counter is checkpointed).

The draw at each position depends on its flat index alone, so a rank makes
only its own rows of a sharded batch (`SyntheticLM.sharded_batch_at`), and
the rows of every rank, put together, are `SyntheticLM.batch_at`'s.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.data import threefry as tf
from repro_torch.models.common import resolve_device

BOS = 1
Rows = Optional[Tuple[int, int]]


class SyntheticLM:
    """Batches ``{"tokens": (B, S + 1) int32, "loss_mask": (B, S) fp32}``
    on ``device`` (the card unless the caller names the CPU).

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0,
                 mean_doc_len: int = 64, *, device: Union[str, torch.device] = "cuda"):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.mean_doc_len = mean_doc_len
        self.device = resolve_device(device)

    def rows_at(self, step: int, rows: Rows = None) -> Dict[str, torch.Tensor]:
        """Rows ``[lo, hi)`` of step ``step``'s batch (all rows by default),
        drawn from their own flat indices."""
        k_tok, k_doc = tf.split(tf.fold_in(tf.prng_key(self.seed), step))
        shape = (self.global_batch, self.seq_len + 1)
        u = tf.uniform(k_tok, shape, device=self.device, rows=rows)
        tokens = (2 + (self.vocab_size - 2) * tf.pow_unit(u, 4.0)).to(torch.int32)
        tokens = torch.clamp(tokens, 2, self.vocab_size - 1)
        doc = tf.bernoulli(k_doc, 1.0 / self.mean_doc_len, shape, device=self.device, rows=rows)
        tokens = torch.where(doc, BOS, tokens).to(torch.int32)
        loss_mask = (tokens[:, 1:] != BOS).to(torch.float32)
        return {"tokens": tokens, "loss_mask": loss_mask}

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return self.rows_at(step)

    def sharded_batch_at(self, step: int, placements: Dict[str, object]
                         ) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch as DTensors under ``placements``
        (``{"tokens": LeafSharding, "loss_mask": LeafSharding}``, e.g. from
        `launch.steps.named` of `sharding.batch_specs`). Each rank draws
        only its own rows; a rank outside the mesh draws none.

        Raises:
            ValueError: the two leaves shard their rows differently, or a
                leaf shards a dim other than the batch.
        """
        from repro_torch.sharding.ctx import local_range, to_dtensor
        shape = {"tokens": (self.global_batch, self.seq_len + 1),
                 "loss_mask": (self.global_batch, self.seq_len)}
        spans = {k: local_range(shape[k], placements[k], dim=0) for k in shape}
        if spans["tokens"] != spans["loss_mask"]:
            raise ValueError(f"tokens and loss mask shard their rows differently: {spans}")
        local = self.rows_at(step, spans["tokens"])
        return {k: to_dtensor(local[k], placements[k], shape[k]) for k in shape}


def make_batch(cfg, cell, step: int = 0, seed: int = 0, *,
               device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """A full batch for an (arch config, shape cell) pair, with the
    modality stand-ins, as the reference makes them: stub frame embeddings
    ``(B, F, d)`` bf16 (a normal draw under ``fold_in(key(seed + 7), step)``)
    for an enc-dec model, and ``(3, B, S + 1)`` positions for M-RoPE."""
    ds = SyntheticLM(cfg.vocab_size, cell.seq_len, cell.global_batch, seed, device=device)
    batch = ds.batch_at(step)
    if cfg.encdec is not None:
        key = tf.fold_in(tf.prng_key(seed + 7), step)
        batch["frames"] = tf.normal_bf16(
            key, (cell.global_batch, cfg.encdec.encoder_seq_len, cfg.d_model), device=ds.device)
    if cfg.pos_type == "mrope":
        S = cell.seq_len + 1
        batch["positions"] = torch.arange(S, dtype=torch.int32, device=ds.device).expand(
            3, cell.global_batch, S)
    return batch
