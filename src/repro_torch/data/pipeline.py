"""Deterministic synthetic-LM data, made on the device.

Every batch is a pure function of ``(seed, step)``: it is drawn from a
`torch.Generator` seeded from the pair alone, so a restart from a checkpoint
resumes the exact stream (only the step counter is checkpointed). The law is
the reference's: content ids ``2 + (V - 2) u**4`` (a skewed unigram a model
can learn), a document boundary (BOS) at each position with probability
``1 / mean_doc_len``, and a loss mask over the targets that are not BOS.

The stream is not the reference's: that one is threefry with JAX's bit
layout. Tests that compare trajectories feed both packages the reference's
batches.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.models.common import resolve_device

BOS = 1


def _generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator whose stream depends on ``(seed, step)`` alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


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

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        gen = _generator(self.seed, step, self.device)
        shape = (self.global_batch, self.seq_len + 1)
        u = torch.rand(shape, generator=gen, device=self.device)
        tokens = (2 + (self.vocab_size - 2) * u ** 4.0).to(torch.int32)
        tokens = torch.clamp(tokens, 2, self.vocab_size - 1)
        doc = torch.rand(shape, generator=gen, device=self.device) < 1.0 / self.mean_doc_len
        tokens = torch.where(doc, BOS, tokens).to(torch.int32)
        loss_mask = (tokens[:, 1:] != BOS).to(torch.float32)
        return {"tokens": tokens, "loss_mask": loss_mask}


def make_batch(cfg, cell, step: int = 0, seed: int = 0, *,
               device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """A full batch for an (arch config, shape cell) pair, with the
    modality stand-ins: stub frame embeddings ``(B, F, d)`` bf16 for an
    enc-dec model, and ``(3, B, S + 1)`` positions for M-RoPE."""
    ds = SyntheticLM(cfg.vocab_size, cell.seq_len, cell.global_batch, seed, device=device)
    batch = ds.batch_at(step)
    if cfg.encdec is not None:
        gen = _generator(seed + 7, step, ds.device)
        batch["frames"] = torch.randn(
            (cell.global_batch, cfg.encdec.encoder_seq_len, cfg.d_model),
            generator=gen, device=ds.device).to(torch.bfloat16)
    if cfg.pos_type == "mrope":
        S = cell.seq_len + 1
        batch["positions"] = torch.arange(S, dtype=torch.int32, device=ds.device).expand(
            3, cell.global_batch, S)
    return batch
