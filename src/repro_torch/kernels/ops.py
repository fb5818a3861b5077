"""Public wrappers of the port's kernels: the device picks the path.

A CPU tensor takes the kernel's plain PyTorch version (`kernels.ref`). A
CUDA tensor launches the hand-written Hopper kernel, or raises on what the
kernel does not take; nothing falls back. `LAUNCHES` counts, per kernel, the
launches made through these wrappers, so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "moe_topk": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention, q ``(B, Sq, Hq, D)``, k/v ``(B, Sk, Hkv, D)`` ->
    ``(B, Sq, Hq, D)`` in q's dtype (replaces Pallas `flash_attention`)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    out = _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    LAUNCHES["flash_attention"] += 1
    return out


def moe_topk(logits: torch.Tensor, k: int, *, norm_topk: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` router logits -> (weights ``(T, k)`` fp32, ids ``(T, k)``
    int32) (replaces Pallas `moe_topk`)."""
    if logits.device.type == "cpu":
        return ref.moe_topk_ref(logits, k, norm_topk=norm_topk)
    out = _moe.moe_topk(logits, k, norm_topk=norm_topk)
    LAUNCHES["moe_topk"] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan from a zero state: x ``(B, S, H, P)``, dt
    ``(B, S, H)`` fp32, A ``(H,)`` fp32, B/C ``(B, S, G, N)`` -> (y ``(B, S,
    H, P)`` in x's dtype, final state ``(B, H, P, N)`` fp32) (replaces
    Pallas `ssd_scan`)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B_mat, C_mat, chunk=chunk)
    out = _ssd.ssd_scan(x, dt, A, B_mat, C_mat, chunk=chunk)
    LAUNCHES["ssd_scan"] += 1
    return out
