"""Hopper MoE top-k gating: the CUDA port of the Pallas `_gate_kernel`.

Source: ``csrc/moe_topk.cu`` (design notes there). This module checks the
arguments and launches the kernel on PyTorch's current stream; the public
entry point, which also takes the plain version for CPU tensors, is
`repro_torch.kernels.ops.moe_topk`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_EXPERTS = 64      # held in the registers of one row's lanes
#: token rows a block takes, BLOCK_WARPS * 32 / LANES of csrc/moe_topk.cu
#: (change both together): T / BLOCK_ROWS blocks, rounded up
BLOCK_ROWS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(logits: torch.Tensor, k: int) -> None:
    """What the kernel takes, checked on metadata alone (so the fake op
    checks it too): ``(T, E)`` fp32 or bf16 logits, contiguous, T > 0 and
    0 < k <= E <= `MAX_EXPERTS`.

    Raises:
        ValueError / TypeError: on what the kernel does not take.
    """
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits dtype {logits.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous (T, E) tensor, got "
                         f"shape {tuple(logits.shape)}")
    T, E = logits.shape
    if not (0 < k <= E <= MAX_EXPERTS) or T == 0:
        raise ValueError(f"need T > 0 and 0 < k <= E <= {MAX_EXPERTS}; "
                         f"got T={T}, E={E}, k={k}")


def moe_topk(logits: torch.Tensor, k: int, *, norm_topk: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` CUDA logits as `check_args` takes them -> (weights
    ``(T, k)`` fp32, ids ``(T, k)`` int32).

    Raises:
        ValueError / TypeError: a device, dtype, shape or contiguity the
            kernel does not take.
        RuntimeError: the launch failed (its CUDA error code).
    """
    if logits.device.type != "cuda":
        raise ValueError(f"logits must lie on a CUDA device, got {logits.device}")
    check_args(logits, k)
    T, E = logits.shape
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    _build.launch("moe_topk_fwd", logits.device, logits.data_ptr(), w.data_ptr(),
                  idx.data_ptr(), T, E, k, int(norm_topk), _DTYPE_CODE[logits.dtype])
    return w, idx


def flops(logits_shape, k: int) -> int:
    """Operations of one gating: the softmax at ~5 a logit (max, subtract,
    exp, sum, divide) and one compare a logit for each of the k picks:
    ``T E (5 + k)``."""
    T, E = logits_shape
    return T * E * (5 + k)
