"""Int8 error-feedback gradient compression (the reference's cross-pod
all-reduce lever): each leaf of ``grads + residual`` is quantized to int8
with a per-tensor fp32 scale, and the quantization error is carried to the
next step. Rounding is half to even, as in the reference."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_util

Tree = Dict[str, Any]


def compress_grads_int8(grads: Tree, residual: Tree) -> Tuple[Tree, Tree, Tree]:
    """Quantize ``grads + residual`` to int8. Returns (q, scales, new_residual)."""

    def one(g, r):
        g32 = g.float() + r
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return q, scale, g32 - q.float() * scale

    out = tree_util.map_tree(lambda _, g, r: one(g, r), grads, residual)
    pick = lambda i: tree_util.map_tree(lambda _, o: o[i], out)  # noqa: E731
    return pick(0), pick(1), pick(2)


def decompress_grads_int8(q: Tree, scales: Tree, dtype: torch.dtype = torch.float32) -> Tree:
    return tree_util.map_tree(lambda _, qq, s: (qq.float() * s).to(dtype), q, scales)


def init_residual(grads_shape: Tree) -> Tree:
    return tree_util.map_tree(
        lambda _, g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_shape)
