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

MAX_EXPERTS = 64      # two logits per lane of one warp
MAX_K = 32            # one chosen expert per lane
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def moe_topk(logits: torch.Tensor, k: int, *, norm_topk: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` CUDA logits (fp32 or bf16, contiguous) -> (weights
    ``(T, k)`` fp32, ids ``(T, k)`` int32).

    Raises:
        ValueError / TypeError: a device, dtype, shape or contiguity the
            kernel does not take.
        RuntimeError: the launch failed (its CUDA error code).
    """
    if logits.device.type != "cuda":
        raise ValueError(f"logits must lie on a CUDA device, got {logits.device}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits dtype {logits.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous (T, E) tensor, got "
                         f"shape {tuple(logits.shape)}")
    T, E = logits.shape
    if not (0 < E <= MAX_EXPERTS and 0 < k <= min(E, MAX_K)) or T == 0:
        raise ValueError(f"need T > 0, 0 < k <= min(E, {MAX_K}) and "
                         f"E <= {MAX_EXPERTS}; got T={T}, E={E}, k={k}")
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    lib = _build.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.moe_topk_fwd(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                               T, E, k, int(norm_topk),
                               _DTYPE_CODE[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_topk_fwd launch failed: CUDA error {err}")
    return w, idx
