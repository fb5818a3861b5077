"""Public wrappers of the port's kernels, each over a PyTorch custom op.

Each kernel is a `torch.library` custom op (``repro_torch::flash_attention``,
``repro_torch::moe_topk``, ``repro_torch::ssd_scan``, no input mutated) with
three implementations, and the dispatcher picks by the tensors' device:

  * CPU: the kernel's plain PyTorch version (`kernels.ref`);
  * CUDA: the hand-written Hopper kernel, launched on the current stream
    through ctypes, or a raise on what it does not take; nothing falls back;
  * fake (a `FakeTensorMode` or the meta device, as the dry run runs): the
    output shapes and dtypes, after the CUDA wrapper's own checks of
    dtypes, shapes and layouts (`check_args` of each kernel module), so a
    dry run fails where the card would.

Each op also has a FLOP formula (`torch.utils.flop_counter`), the
operations its kernel does (`flops` of each kernel module).

The wrappers keep two refusals of their own. The Hopper kernels are forward
only, as the reference's Pallas kernels are (none defines a VJP): they fill
their output through ctypes, where autograd would see a constant, so a
wrapper raises on a CUDA input that requires grad while grad mode is on,
rather than give a silent zero gradient. A DTensor argument raises
`TypeError` on any device: a kernel reads raw pointers, which a DTensor does
not define, and the plain path would silently compute on shards (the sharded
steps hand the kernels gathered plain tensors).

A wrapper given no rows to work on (a batch of 0, or no tokens) returns the
empty result without calling its op: a sharded train step leaves a rank
without rows when a microbatch does not split evenly, and no kernel is
launched on an empty tensor.

`LAUNCHES` counts, per kernel, the launches of its CUDA implementation
alone, so a run can show that its path went through the kernels; a fake
call never raises it. A PREPARE worker thread launches kernels while the
serving thread does, so a count is raised under a lock. A launch made while
a CUDA graph is captured is recorded, not run: inside `captured_launches`
the calling thread's launches go to the graph's own tally instead, and
each replay of the graph adds that tally to `LAUNCHES` (`add_launches`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_dispatch as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.sharding.ctx import is_dtensor

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "moe_topk": 0, "ssd_scan": 0}
_LAUNCHES_LOCK = threading.Lock()
# the tally of the graph this thread is capturing, if any
_CAPTURING = threading.local()


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` to `LAUNCHES`: a replayed graph's captured launches."""
    with _LAUNCHES_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Count the calling thread's launches into the yielded dict, not into
    `LAUNCHES`, while a CUDA graph is captured (another thread's launches
    still count where they run)."""
    tally = {name: 0 for name in LAUNCHES}
    outer = getattr(_CAPTURING, "tally", None)
    _CAPTURING.tally = tally
    try:
        yield tally
    finally:
        _CAPTURING.tally = outer


def _count(name: str) -> None:
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              scale: Optional[float]) -> torch.Tensor:
    return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale).contiguous()


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, scale):
    out = _fa.flash_attention(q, k, v, causal=causal, scale=scale)
    _count("flash_attention")
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, scale):
    _fa.check_args(q, k, v)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, scale, *, out_shape=None, **kw):
    return _fa.flops(q_shape, k_shape, causal)


@torch.library.custom_op("repro_torch::moe_topk", mutates_args=(), device_types="cpu")
def _moe_op(logits: torch.Tensor, k: int, norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    w, idx = ref.moe_topk_ref(logits, k, norm_topk=norm_topk)
    return w.contiguous(), idx.contiguous()


@_moe_op.register_kernel("cuda")
def _moe_cuda(logits, k, norm_topk):
    out = _moe.moe_topk(logits, k, norm_topk=norm_topk)
    _count("moe_topk")
    return out


@_moe_op.register_fake
def _moe_fake(logits, k, norm_topk):
    _moe.check_args(logits, k)
    T = logits.shape[0]
    return (logits.new_empty((T, k), dtype=torch.float32),
            logits.new_empty((T, k), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.moe_topk)
def _moe_flops(logits_shape, k, norm_topk, *, out_shape=None, **kw):
    return _moe.flops(logits_shape, k)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cpu")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_mat: torch.Tensor,
            C_mat: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    y, h = ref.ssd_scan_ref(x, dt, A, B_mat, C_mat, chunk=chunk)
    return y.contiguous(), h.contiguous()


@_ssd_op.register_kernel("cuda")
def _ssd_cuda(x, dt, A, B_mat, C_mat, chunk):
    out = _ssd.ssd_scan(x, dt, A, B_mat, C_mat, chunk=chunk)
    _count("ssd_scan")
    return out


@_ssd_op.register_fake
def _ssd_fake(x, dt, A, B_mat, C_mat, chunk):
    _ssd.check_args(x, dt, A, B_mat, C_mat, chunk)
    Bsz, _, H, P = x.shape
    return x.new_empty(x.shape), x.new_empty((Bsz, H, P, B_mat.shape[3]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *, out_shape=None, **kw):
    return _ssd.flops(x_shape, B_shape[3], chunk)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _refuse_dtensor(name: str, *tensors: torch.Tensor) -> None:
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: a DTensor argument; the kernels take plain tensors "
                        "(gather the shards first, as the sharded steps do)")


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    if (torch.is_grad_enabled() and any(t.device.type == "cuda" for t in tensors)
            and any(t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{name}: the Hopper kernels are forward-only, as the reference's Pallas "
            "kernels are; differentiate through the plain ops (the models' train mode)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention, q ``(B, Sq, Hq, D)``, k/v ``(B, Sk, Hkv, D)`` ->
    ``(B, Sq, Hq, D)`` in q's dtype (replaces Pallas `flash_attention`)."""
    _refuse_dtensor("flash_attention", q, k, v)
    _refuse_autograd("flash_attention", q, k, v)
    if q.numel() == 0:
        return q.new_empty(q.shape)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, scale)


def moe_topk(logits: torch.Tensor, k: int, *, norm_topk: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, E)`` router logits -> (weights ``(T, k)`` fp32, ids ``(T, k)``
    int32) (replaces Pallas `moe_topk`)."""
    _refuse_dtensor("moe_topk", logits)
    _refuse_autograd("moe_topk", logits)
    if logits.shape[0] == 0:
        return (logits.new_empty((0, k), dtype=torch.float32),
                logits.new_empty((0, k), dtype=torch.int32))
    return torch.ops.repro_torch.moe_topk(logits, k, norm_topk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C_mat: torch.Tensor, *, chunk: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan from a zero state: x ``(B, S, H, P)``, dt
    ``(B, S, H)`` fp32, A ``(H,)`` fp32, B/C ``(B, S, G, N)`` -> (y ``(B, S,
    H, P)`` in x's dtype, final state ``(B, H, P, N)`` fp32) (replaces
    Pallas `ssd_scan`)."""
    _refuse_dtensor("ssd_scan", x, dt, A, B_mat, C_mat)
    _refuse_autograd("ssd_scan", x, dt, A, B_mat, C_mat)
    if x.shape[0] == 0:
        Bsz, _, H, P = x.shape
        return x.new_empty(x.shape), x.new_zeros((Bsz, H, P, B_mat.shape[3]),
                                                 dtype=torch.float32)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, B_mat, C_mat, chunk)
