"""Hopper flash attention: the CUDA port of the Pallas `_flash_kernel`.

Source: ``csrc/flash_attention.cu`` (design notes there). This module checks
the arguments and launches the kernel on PyTorch's current stream; the
public entry point, which also takes the plain version for CPU tensors, is
`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 192)
#: q rows per block of the bf16 kernel: 16 * MW, MW a constant of
#: csrc/flash_attention.cu (change both together)
BF16_Q_TILE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The dtypes, shapes and layouts the kernel takes, checked on the
    tensors' metadata alone (so the fake op checks them too): q ``(B, Sq,
    Hq, D)``, k/v ``(B, Sk, Hkv, D)``, one dtype (fp32 or bf16), contiguous,
    D in `HEAD_DIMS`, Hq a multiple of Hkv, nothing empty.

    Raises:
        ValueError / TypeError: on what the kernel does not take.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes q, k, v "
                            "all float32 or all bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"shape {tuple(t.shape)}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q ``(B, Sq, Hq, D)``, k/v ``(B, Sk, Hkv, D)`` CUDA tensors as
    `check_args` takes them (bf16: 16-byte aligned) -> ``(B, Sq, Hq, D)``
    in q's dtype.

    Raises:
        ValueError / TypeError: a device, dtype, shape or contiguity the
            kernel does not take.
        RuntimeError: the launch failed (its CUDA error code).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
    check_args(q, k, v)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on a 16-byte boundary "
                         "(the kernel copies rows 16 bytes at a time)")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, scale,
                  int(causal), _DTYPE_CODE[q.dtype])
    return out


def flops(q_shape, k_shape, causal: bool) -> int:
    """The multiply-adds of the two products (Q Kᵀ, then P V), 2 operations
    each, over the (q, k) pairs the mask keeps: ``4 B Hq D`` per pair. A
    causal row i keeps ``min(i + 1, Sk)`` keys (the mask is ``k <= q``, as
    the kernel's); the kernel skips every k tile above the diagonal and the
    fully masked 32-column halves of the diagonal tile; this count also
    leaves out the masked entries it still multiplies inside the diagonal
    tiles (at most one tile's upper triangle per q tile). The softmax's
    exponentials are not counted: a FLOP count counts the products."""
    B, Sq, Hq, D = q_shape
    Sk = k_shape[1]
    if causal:
        m = min(Sq, Sk)
        pairs = m * (m + 1) // 2 + (Sq - m) * Sk
    else:
        pairs = Sq * Sk
    return 4 * B * Hq * D * pairs
