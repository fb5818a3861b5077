"""Carry a reference parameter tree over to the port.

The reference's parameter pytree (and its AdamW state) arrives as nested
dicts of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)`` in a test),
so the port never sees the reference's framework. The layout is kept as it
is: the stacked ``L`` dim, the padded vocab and the padded experts, and an
enc-dec model's ``enc_layers`` / ``dec_layers``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import resolve_device


def _to_tensor(path: str, leaf: lm.Leaf, arr: Any, device: torch.device, *,
               check_dtype: bool = True) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != leaf.shape:
        raise ValueError(f"{path}: shape {tuple(a.shape)}, expected {leaf.shape}")
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits over
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    if check_dtype and t.dtype != leaf.dtype:
        raise ValueError(f"{path}: dtype {t.dtype}, expected {leaf.dtype}")
    return t.to(device)


def _layout(cfg: ModelConfig, tree: Mapping[str, Any]) -> lm.Params:
    if cfg.encdec is None:
        return lm.param_layout(cfg)
    # the learned positions' length is the init's ``max_seq``
    pos = tree.get("pos_embed")
    return encdec.param_layout(cfg, max_seq=None if pos is None else np.shape(pos)[0])


def _check_keys(cfg: ModelConfig, spec, sub, path=""):
    for key in sub:
        where = f"{path}/{key}" if path else key
        if key not in spec:
            raise ValueError(f"{where}: not a parameter of {cfg.name}")
        if isinstance(spec[key], dict):
            _check_keys(cfg, spec[key], sub[key], where)


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], *,
                      device: Union[str, torch.device] = "cuda") -> lm.Params:
    """The port's parameters from the reference's tree of numpy arrays,
    placed on ``device``.

    Raises:
        KeyError: the tree lacks a parameter of ``cfg``'s layout.
        ValueError: a parameter has another shape or dtype, or the tree holds
            a parameter the layout does not know.
        RuntimeError: ``device`` is CUDA and no card is available.
    """
    dev = resolve_device(device)
    layout = _layout(cfg, tree)
    _check_keys(cfg, layout, tree)
    return lm.map_layout(lambda path, leaf, arr: _to_tensor(path, leaf, arr, dev),
                         layout, tree)


def opt_state_from_numpy(cfg: ModelConfig, state: Mapping[str, Any], *,
                         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """The port's AdamW state (`repro_torch.optim.AdamW`) from the
    reference's ``{"m", "v", "count"}`` of numpy arrays: moments of the
    parameter layout's shapes in their own dtype (fp32, or the
    ``state_dtype``), the count an int32 scalar.

    Raises:
        KeyError, ValueError: as `params_from_numpy`, for ``m`` and ``v``.
        RuntimeError: ``device`` is CUDA and no card is available.
    """
    dev = resolve_device(device)
    layout = _layout(cfg, state["m"])
    out: Dict[str, Any] = {}
    for key in ("m", "v"):
        _check_keys(cfg, layout, state[key])
        out[key] = lm.map_layout(
            lambda path, leaf, arr: _to_tensor(f"{key}/{path}", leaf, arr, dev,
                                               check_dtype=False),
            layout, state[key])
    out["count"] = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32, device=dev)
    return out
