"""Model facade: one architecture's config and parameters on one device."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import resolve_device


class Model:
    """A decoder-only LM's config and parameters, on the card by default.

    Args:
        cfg: the architecture.
        params: its parameter tree (e.g. from `repro_torch.bridge`); when
            omitted, random weights are made on ``device`` from ``seed``.
        device: where the parameters live and every call runs; ``"cuda"``
            unless the caller names the CPU.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[lm.Params] = None, *,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = self.init_params(
                torch.Generator(device=self.device).manual_seed(seed))
        self.params = params

    def init_params(self, gen: torch.Generator) -> lm.Params:
        return lm.init_params(self.cfg, gen, device=self.device)

    # ---- serving ----
    def prefill(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, lm.Cache]:
        """``batch``: ``tokens (B, S)``; optionally ``true_len`` (a padded
        bucket, see `lm.prefill`) and ``positions``: ``(S,)`` or ``(B, S)``,
        or ``(3, B, S)`` M-RoPE streams for an M-RoPE model (the token
        positions on all three streams when omitted)."""
        return lm.prefill(self.cfg, self.params, batch)

    def decode_step(self, tokens: torch.Tensor, cache: lm.Cache,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, lm.Cache]:
        return lm.decode_step(self.cfg, self.params, tokens, cache, pos)

    def init_cache(self, batch: int, s_max: int,
                   dtype: torch.dtype = torch.bfloat16) -> lm.Cache:
        return lm.init_cache(self.cfg, batch, s_max, dtype=dtype, device=self.device)

    def cache_shapes(self, batch: int, s_max: int) -> Dict[str, Tuple[int, ...]]:
        return lm.cache_shape(self.cfg, batch, s_max)


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
