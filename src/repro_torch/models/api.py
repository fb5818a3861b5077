"""Model facade: one architecture's config and parameters on one device,
over the decoder-only and the enc-dec assemblies."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import resolve_device


class Model:
    """An LM's config and parameters, on the card by default.

    Args:
        cfg: the architecture (decoder-only, or enc-dec with ``cfg.encdec``).
        params: its parameter tree (e.g. from `repro_torch.bridge`); when
            omitted, random weights are made on ``device`` from ``seed``,
            or, on the meta device, the shapes alone (`param_shapes`: no
            random number is drawn).
        device: where the parameters live and every call runs; ``"cuda"``
            unless the caller names the CPU (or ``"meta"``).
        remat_policy: what a decoder-only model's train step saves inside
            each scan step (`lm._remat_context`: "nothing" or "dots").
        loss_chunk: the train loss's sequence chunk (`lm.cross_entropy`).
        shardings: make the random weights as DTensors under this
            `LeafSharding` tree (`sharding.plan_to_shardings`' ``"params"``):
            the same draws as without it, each cut to this rank's shard as
            it is made (`lm.init_layout_sharded`), so a model that no card
            holds whole lives across ranks. Every rank of the world makes
            the model.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[lm.Params] = None, *,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 remat_policy: Optional[str] = "nothing",
                 loss_chunk: Optional[int] = None,
                 shardings: Optional[lm.Params] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat_policy = remat_policy
        self.loss_chunk = loss_chunk
        self._is_encdec = cfg.encdec is not None
        if params is None and self.device.type == "meta":
            params = self.param_shapes()
        elif params is None and shardings is not None:
            layout = encdec.param_layout(cfg) if self._is_encdec else lm.param_layout(cfg)
            params = lm.init_layout_sharded(
                layout, torch.Generator(device=self.device).manual_seed(seed), shardings,
                device=self.device)
        elif params is None:
            params = self.init_params(
                torch.Generator(device=self.device).manual_seed(seed))
        self.params = params

    def param_shapes(self, max_seq: Optional[int] = None) -> lm.Params:
        """The parameter tree as meta tensors, shapes and dtypes alone (the
        reference's ``jax.eval_shape`` of ``init_params``): no memory, no
        random draw. ``max_seq`` sizes an enc-dec model's ``pos_embed``
        (``min(max_seq_len, 32768)`` rows by default)."""
        layout = (encdec.param_layout(self.cfg, max_seq) if self._is_encdec
                  else lm.param_layout(self.cfg))
        return lm.map_layout(
            lambda _, leaf: torch.empty(leaf.shape, dtype=leaf.dtype, device="meta"), layout)

    def init_params(self, gen: torch.Generator) -> lm.Params:
        if self._is_encdec:
            return encdec.init_params(self.cfg, gen, device=self.device)
        return lm.init_params(self.cfg, gen, device=self.device)

    # ---- training ----
    def train_loss(self, batch: Dict[str, Any], params: Optional[lm.Params] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, ``{"ce", "moe_aux"}``) of ``batch`` (`lm.train_loss`,
        `encdec.train_loss`) under ``params`` (this model's by default),
        differentiable through the reference's plain ops."""
        params = self.params if params is None else params
        if self._is_encdec:
            return encdec.train_loss(self.cfg, params, batch, loss_chunk=self.loss_chunk)
        return lm.train_loss(self.cfg, params, batch, loss_chunk=self.loss_chunk,
                             remat_policy=self.remat_policy)

    # ---- serving ----
    def prefill(self, batch: Dict[str, Any], params: Optional[lm.Params] = None
                ) -> Tuple[torch.Tensor, lm.Cache]:
        """``batch``: ``tokens (B, S)``; an enc-dec model also takes
        ``frames (B, F, d)``. A decoder-only model optionally takes
        ``true_len`` (a padded bucket, see `lm.prefill`) and ``positions``:
        ``(S,)`` or ``(B, S)``, or ``(3, B, S)`` M-RoPE streams for an M-RoPE
        model (the token positions on all three streams when omitted).
        ``params``: this model's by default."""
        params = self.params if params is None else params
        if self._is_encdec:
            return encdec.prefill(self.cfg, params, batch)
        return lm.prefill(self.cfg, params, batch)

    def decode_step(self, tokens: torch.Tensor, cache: lm.Cache, pos: torch.Tensor,
                    params: Optional[lm.Params] = None) -> Tuple[torch.Tensor, lm.Cache]:
        params = self.params if params is None else params
        if self._is_encdec:
            return encdec.decode_step(self.cfg, params, tokens, cache, pos)
        return lm.decode_step(self.cfg, params, tokens, cache, pos)

    def init_cache(self, batch: int, s_max: int, dtype: torch.dtype = torch.bfloat16,
                   enc_len: Optional[int] = None) -> lm.Cache:
        if self._is_encdec:
            return encdec.init_cache(self.cfg, batch, s_max,
                                     enc_len or self.cfg.encdec.encoder_seq_len,
                                     dtype=dtype, device=self.device)
        return lm.init_cache(self.cfg, batch, s_max, dtype=dtype, device=self.device)

    def cache_shapes(self, batch: int, s_max: int,
                     enc_len: Optional[int] = None) -> Dict[str, Tuple[int, ...]]:
        if self._is_encdec:
            return encdec.cache_shape(self.cfg, batch, s_max,
                                      enc_len or self.cfg.encdec.encoder_seq_len)
        return lm.cache_shape(self.cfg, batch, s_max)


def build_model(cfg: ModelConfig, **kw) -> Model:
    return Model(cfg, **kw)
