"""Hopper Mamba2 SSD chunked scan: the CUDA port of the Pallas `_ssd_kernel`.

Source: ``csrc/ssd_scan.cu`` (design notes there). This module checks the
arguments and launches the kernel on PyTorch's current stream; the public
entry point, which also takes the plain version for CPU tensors, is
`repro_torch.kernels.ops.ssd_scan`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_P = 64            # head dim, split over blocks 16 columns at a time
MAX_N = 128           # state dim: 16 columns of the state per warp, 8 warps
MAX_CHUNK = 1024      # the chunk's dt and prefix sum live in shared memory
#: P columns per block (PT in the source): B * H * P / P_TILE blocks
P_TILE = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B_mat: torch.Tensor, C_mat: torch.Tensor, chunk: int) -> None:
    """What the kernel takes, checked on metadata alone (so the fake op
    checks it too): x ``(B, S, H, P)``, dt ``(B, S, H)`` fp32, A ``(H,)``
    fp32, B/C ``(B, S, G, N)`` in x's dtype (fp32 or bf16), all contiguous;
    P and N multiples of 16 up to `MAX_P` and `MAX_N`, ``chunk`` a multiple
    of 16 up to `MAX_CHUNK`, G dividing H, nothing empty.

    Raises:
        ValueError / TypeError: on what the kernel does not take.
    """
    for name, t, dims in (("x", x, 4), ("dt", dt, 3), ("A", A, 1),
                          ("B_mat", B_mat, 4), ("C_mat", C_mat, 4)):
        if t.dim() != dims or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dims}-d tensor, got "
                             f"shape {tuple(t.shape)}")
    if x.dtype not in _DTYPE_CODE or B_mat.dtype != x.dtype or C_mat.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, B {B_mat.dtype}, C {C_mat.dtype}: the kernel "
                        "takes x, B and C all float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt {dt.dtype}, A {A.dtype}: the kernel takes both float32")
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(B_mat.shape[:2]) != (Bsz, S) or C_mat.shape != B_mat.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B_mat.shape)}, C {tuple(C_mat.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if min(Bsz, S, H) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}")
    if P % 16 or not 0 < P <= MAX_P or N % 16 or not 0 < N <= MAX_N:
        raise ValueError(f"P={P}, N={N}: the kernel takes multiples of 16 up to "
                         f"P={MAX_P}, N={MAX_N}")
    if chunk % 16 or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk}: the kernel takes a multiple of 16 up to {MAX_CHUNK}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tensors as `check_args` takes them (bf16: 16-byte aligned) ->
    (y ``(B, S, H, P)`` in x's dtype, final state ``(B, H, P, N)`` fp32).

    Raises:
        ValueError / TypeError: a device, dtype, shape or contiguity the
            kernel does not take.
        RuntimeError: the launch failed (its CUDA error code).
    """
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B_mat", B_mat), ("C_mat", C_mat)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
    check_args(x, dt, A, B_mat, C_mat, chunk)
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (x, B_mat, C_mat)):
        raise ValueError("bf16 x, B_mat and C_mat must start on a 16-byte boundary "
                         "(the kernel copies rows 16 bytes at a time)")
    y = torch.empty_like(x)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    _build.launch("ssd_scan_fwd", x.device, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                  B_mat.data_ptr(), C_mat.data_ptr(), y.data_ptr(), h.data_ptr(),
                  Bsz, S, H, G, P, N, chunk, _DTYPE_CODE[x.dtype])
    return y, h


def flops(x_shape, N: int, chunk: int) -> int:
    """Operations of one scan: per head and chunk of Lc rows, the causal
    half of the two Lc x Lc products (C Bᵀ, then times dt x) and the two
    state products (C hᵀ, the state update), 2 operations a multiply-add:
    ``sum over chunks of (Lc (Lc + 1) (N + P) + 4 Lc P N)``, times B H."""
    B, S, H, P = x_shape
    ops = 0
    for t0 in range(0, S, chunk):
        Lc = min(chunk, S - t0)
        ops += Lc * (Lc + 1) * (N + P) + 4 * Lc * P * N
    return ops * B * H
