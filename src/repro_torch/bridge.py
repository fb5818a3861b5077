"""Carry a reference parameter tree over to the port.

The reference's parameter pytree arrives as nested dicts of numpy arrays
(e.g. ``jax.tree.map(np.asarray, params)`` in a test), so the port never
sees the reference's framework. The layout is kept as it is: the stacked
``L`` dim, the padded vocab and the padded experts.
"""
from __future__ import annotations

from typing import Any, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.common import resolve_device


def _to_tensor(path: str, leaf: lm.Leaf, arr: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if tuple(a.shape) != leaf.shape:
        raise ValueError(f"{path}: shape {tuple(a.shape)}, expected {leaf.shape}")
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits over
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    if t.dtype != leaf.dtype:
        raise ValueError(f"{path}: dtype {t.dtype}, expected {leaf.dtype}")
    return t.to(device)


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
    layout = lm.param_layout(cfg)

    def extra(spec, sub, path=""):
        for key in sub:
            where = f"{path}/{key}" if path else key
            if key not in spec:
                raise ValueError(f"{where}: not a parameter of {cfg.name}")
            if isinstance(spec[key], dict):
                extra(spec[key], sub[key], where)

    extra(layout, tree)
    return lm.map_layout(lambda path, leaf, arr: _to_tensor(path, leaf, arr, dev),
                         layout, tree)
