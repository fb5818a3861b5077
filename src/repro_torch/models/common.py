"""Shared model primitives: device choice, norms (the gated Mamba2 one
included), activations, rotary embeddings and init."""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# device and dtypes
# ---------------------------------------------------------------------------


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    is used only when the caller names it.

    Raises:
        RuntimeError: a CUDA device is asked for and none is available.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.activ_dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab_size: int) -> int:
    m = VOCAB_PAD_MULTIPLE
    return (vocab_size + m - 1) // m * m


def vocab_mask(vocab_size: int, padded: int, *, device=None) -> torch.Tensor:
    """``(padded,)`` fp32 additive mask: 0 for real ids, -1e30 for padding."""
    ids = torch.arange(padded, device=device)
    return torch.where(ids < vocab_size, 0.0, -1e30).to(torch.float32)


# ---------------------------------------------------------------------------
# norms (fp32 accumulation, cast back to input dtype)
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 RMSNormGated: rmsnorm(x * silu(z)) * scale."""
    xf = x.float() * F.silu(z.float())
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def norm_shapes(cfg: ModelConfig, dim: int) -> dict:
    shapes = {"scale": (dim,)}
    if cfg.norm_type == "layernorm":
        shapes["bias"] = (dim,)
    return shapes


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":           # jax.nn.gelu's default: the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# rotary embeddings (NeoX half-rotation convention)
# ---------------------------------------------------------------------------


def rope_freqs(rot_dim: int, theta: float, device=None) -> torch.Tensor:
    """(rot_dim/2,) inverse frequencies, fp32."""
    exponents = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape ``positions.shape + (rot_dim/2,)``, fp32."""
    inv = rope_freqs(rot_dim, theta, device=positions.device)
    angles = positions.float()[..., None] * inv
    return torch.cos(angles), torch.sin(angles)


def mrope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float,
                  sections: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE over ``(3, B, S)`` position streams (temporal,
    height, width): frequency index ``i`` takes the stream of its section.
    Returns cos/sin ``(B, S, rot_dim/2)``, fp32.

    Raises:
        ValueError: the sections do not cover ``rot_dim / 2`` frequencies.
    """
    if sum(sections) != rot_dim // 2:
        raise ValueError(f"sections {sections} do not sum to rot_dim/2 = {rot_dim // 2}")
    inv = rope_freqs(rot_dim, theta, device=positions.device)
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.long, device=positions.device)
                         for i, s in enumerate(sections)])          # (rot/2,)
    pos_sel = positions.index_select(0, sec_ids).movedim(0, -1)    # (B, S, rot/2)
    angles = pos_sel.float() * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``(B, S, H, D)`` with rotary applied to the leading ``2 *
    cos.shape[-1]`` dims of D; cos/sin ``(B, S, rot/2)`` or ``(S, rot/2)``."""
    rot = cos.shape[-1] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    if cos.dim() == 2:            # (S, rot/2): broadcast over batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                         # (B, S, rot/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def sinusoidal_positions(length: int, dim: int, *, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings, ``(length, dim)`` fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=device) / (half - 1))
    args = torch.arange(length, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
               scale: Optional[float] = None, *, device: torch.device) -> torch.Tensor:
    """Normal weights with the reference's std rule: ``fan_in = shape[0]``
    (so ``(E_pad, d, ff)`` expert weights get std ``E_pad ** -0.5``)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
               *, device: torch.device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)
