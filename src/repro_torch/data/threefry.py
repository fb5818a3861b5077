"""Threefry-2x32 counter-based random bits, laid out as the reference draws
them, so the port's synthetic stream is the reference's bit for bit.

The law (the reference's PRNG with partitionable threefry):

  * a key is a pair of 32-bit words; ``prng_key(s)`` is ``(0, s)`` (a
    32-bit seed);
  * ``fold_in(k, d)`` is ``threefry(k, (0, d))``;
  * ``split(k)`` gives ``threefry(k, (0, i))`` for ``i = 0, 1``;
  * the 32 bits at flat index ``i`` of a shape are ``x0 ^ x1`` of
    ``threefry(k, (i >> 32, i & M))``, so any slice of an array is drawn from
    its own flat indices alone;
  * an fp32 uniform in [0, 1) is ``((bits >> 9) | 0x3F800000)`` viewed as
    fp32, minus 1; ``bernoulli(p)`` is ``uniform < p``;
  * a bf16 normal takes the low 8 bits ``b``, forms ``(b >> 1) | 0x3F80`` as
    bf16 minus 1, scales it in bf16 onto [nextafter(-1, 0), 1), then
    ``erfinv`` in fp32 rounded to bf16, times bf16 sqrt(2) in bf16.

Words are held in int64 tensors masked to 32 bits (torch has no uint32
arithmetic on every device), on the device of the caller's choosing.

The stream's tokens take ``u ** 4.0`` of an fp32 uniform, which the
reference computes with the C library's ``powf`` (0.82 ulp at worst, so
not always correctly rounded), and torch's ``pow`` rounds otherwise, and
differently on the CPU and the card. `pow_unit` is that ``powf``'s
algorithm (the ARM optimized-routines one glibc ships: ``log2`` from a
16-entry table and a degree-5 polynomial, ``exp2`` from a 32-entry table
and a cubic, in float64) in float64 torch ops, one rounding each, so every
device gives the reference's float bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` (int64
    tensors holding 32-bit values) under ``key``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _words(key: Key, x0: int, x1: int) -> Key:
    a, b = threefry2x32(key, torch.tensor([x0], dtype=torch.int64),
                        torch.tensor([x1], dtype=torch.int64))
    return int(a[0]), int(b[0])


def prng_key(seed: int) -> Key:
    """The key of a 32-bit seed (a negative one wraps, as an int32 does).

    Raises:
        ValueError: ``seed`` does not fit 32 bits.
    """
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return 0, seed & M32


def fold_in(key: Key, data: int) -> Key:
    return _words(key, (data >> 32) & M32, data & M32)


def split(key: Key) -> Tuple[Key, Key]:
    a = _words(key, 0, 0)
    b = _words(key, 0, 1)
    return a, b


def bits32(key: Key, flat: torch.Tensor) -> torch.Tensor:
    """The 32 random bits (int64) at the flat indices ``flat`` of an array."""
    x0, x1 = threefry2x32(key, flat >> 32, flat & M32)
    return x0 ^ x1


def _flat(shape, device, rows: Tuple[int, int] = None) -> torch.Tensor:
    """Flat indices of ``shape`` (int64), or of rows ``[lo, hi)`` of its
    leading axis only."""
    inner = math.prod(shape[1:])
    lo, hi = rows if rows is not None else (0, shape[0])
    idx = torch.arange(lo * inner, hi * inner, dtype=torch.int64, device=device)
    return idx.reshape((hi - lo,) + tuple(shape[1:]))


def uniform(key: Key, shape, *, device, rows: Tuple[int, int] = None) -> torch.Tensor:
    """fp32 uniform in [0, 1) of ``shape`` (or its rows ``[lo, hi)``)."""
    bits = bits32(key, _flat(shape, device, rows))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def bernoulli(key: Key, p: float, shape, *, device, rows: Tuple[int, int] = None
              ) -> torch.Tensor:
    return uniform(key, shape, device=device, rows=rows) < torch.tensor(p, dtype=torch.float32)


_H = float.fromhex
#: powf's log2 table: (1/c, log2(c)) for each of 16 subintervals of [OFF, 2 OFF)
_LOG2_TAB = tuple((_H(a), _H(b)) for a, b in (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
))
_LOG2_POLY = tuple(_H(x) for x in ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
                                   "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
                                   "0x1.71547652ab82bp+0"))
#: exp2's table: the bits of 2^(i/32), less i << 47
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2_POLY = tuple(_H(x) for x in ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                                   "0x1.62e42ff0c52d6p-1"))
_EXP2_SHIFT = _H("0x1.8p+47")     # 1.5 * 2^52 / 32: rounds x to k/32


def _signed32(w: torch.Tensor) -> torch.Tensor:
    """A 32-bit word (int64 in [0, 2^32)) as the int32 it stands for."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w)


def pow_unit(x: torch.Tensor, y: float) -> torch.Tensor:
    """``powf(x, y)`` of the C library for an fp32 ``x`` in [0, 1) and a
    small positive ``y``: ``exp2(y log2(x))`` in float64, rounded to fp32
    once, as the library's algorithm computes it (so the reference's
    ``u ** 4.0`` on every device). Other inputs (negative, subnormal,
    non-finite) are not its domain."""
    dev = x.device
    ix = x.view(torch.int32).to(torch.int64)
    # x = 2^k z with z in [OFF, 2 OFF), in subinterval i
    tmp = ix - 0x3F330000
    i = (tmp >> 19) % 16
    top = tmp & 0xFF800000
    k = (_signed32(top) >> 23).double()
    z = _signed32((ix - top) & M32).to(torch.int32).view(torch.float32).double()
    tab = torch.tensor(_LOG2_TAB, dtype=torch.float64, device=dev)
    a = _LOG2_POLY
    r = z * tab[i, 0] - 1.0
    r2 = r * r
    r4 = r2 * r2
    q = a[4] * r + (tab[i, 1] + k)
    q = (a[2] * r + a[3]) * r2 + q
    ylogx = y * ((a[0] * r + a[1]) * r4 + q)
    # exp2(ylogx) = 2^(n/32) 2^r
    kd = ylogx + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    r = ylogx - (kd - _EXP2_SHIFT)
    t = torch.tensor(_EXP2_TAB, dtype=torch.int64, device=dev)[ki % 32] + (ki << 47)
    c = _EXP2_POLY
    out = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * t.view(torch.float64)
    return torch.where(x == 0, torch.zeros_like(x), out.float())


@functools.lru_cache(maxsize=None)
def _normal_bf16_table() -> torch.Tensor:
    """The bf16 normal of each of the 128 values a 7-bit code gives, made
    once on the CPU (so every device reads the same ``erfinv``)."""
    code = torch.arange(128, dtype=torch.int64)
    f = (code | 0x3F80).to(torch.int16).view(torch.bfloat16)
    lo = torch.nextafter(torch.tensor(-1.0, dtype=torch.bfloat16),
                         torch.tensor(0.0, dtype=torch.bfloat16))
    u = torch.maximum((f - 1.0) * (1.0 - lo) + lo, lo)
    z = torch.erfinv(u.float()).to(torch.bfloat16)
    return z * torch.tensor(math.sqrt(2), dtype=torch.bfloat16)


def normal_bf16(key: Key, shape, *, device, rows: Tuple[int, int] = None) -> torch.Tensor:
    """Standard normal in bf16 of ``shape`` (or its rows ``[lo, hi)``): the
    low 8 bits of each draw, shifted right once, index the 128 values of
    `_normal_bf16_table`."""
    code = (bits32(key, _flat(shape, device, rows)) & 0xFF) >> 1
    return _normal_bf16_table().to(device)[code]
