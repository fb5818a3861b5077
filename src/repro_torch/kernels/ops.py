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

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "moe_topk": 0}


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
