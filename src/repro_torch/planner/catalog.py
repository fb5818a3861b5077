"""Heterogeneous device catalog: the roofline parameters of the pools a
serving configuration can be placed on.

The paper's testbed mixes A100s and L40s-class accelerators; choosing "the
optimal pipeline configuration" requires knowing how the SAME compiled
module costs differently on each. A `DeviceProfile` is the minimal
roofline description of one device class — peak FLOP/s, HBM bandwidth,
memory capacity, interconnect bandwidth — attachable per engine or mesh
slice (`pool(n)` scales a profile to an n-device slice under the ideal-
scaling approximation the estimator documents).

Three profile sources:

  * shipped datasheet profiles (`A100`, `L40S`) — dense-BF16 peak, HBM
    stream bandwidth, per-device capacity, per-device interconnect;
  * `calibrate_host_profile()` — a measured profile of one device of
    THIS host (the card by default), from a probe matmul (FLOP/s) and a
    probe elementwise stream (bytes/s), so estimator rankings can be
    validated against wall-clock latencies on the device that serves;
  * `scaled()` variants — same roofline SHAPE, scaled magnitudes, so
    benchmarks can make a tiny test model "heavy" relative to the device
    without distorting the A100:L40s ratios that drive configuration
    choices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Union

import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Roofline description of one device class (per single device).

    Attributes:
        name: catalog key (``"a100"``, ``"l40s"``, ``"host"``, ...).
        peak_flops: dense peak FLOP/s in the serving dtype.
        hbm_bw: HBM/DRAM stream bandwidth, bytes/s.
        mem_bytes: on-device memory capacity, bytes.
        link_bw: per-device interconnect bandwidth, bytes/s — the wire
            collectives cross (NVLink / PCIe / host loopback).
        n_devices: devices in the attached mesh slice (see `pool`).
        cost_rate: relative cost of running one device for one second —
            the search objective's engine-seconds weight (an L40s hour is
            cheaper than an A100 hour).
    """

    name: str
    peak_flops: float
    hbm_bw: float
    mem_bytes: float
    link_bw: float
    n_devices: int = 1
    cost_rate: float = 1.0

    def pool(self, n: int) -> "DeviceProfile":
        """An ``n``-device mesh slice of this device class.

        Ideal-scaling approximation (documented, deliberate): compute and
        HBM bandwidth scale by ``n``; ``link_bw`` stays per-device (the
        wire is the non-scaling resource — that is exactly why the
        estimator routes collective bytes through it separately).

        Raises:
            ValueError: ``n`` < 1.
        """
        if n < 1:
            raise ValueError(f"pool size must be >= 1, got {n}")
        if n == self.n_devices:
            return self
        base = self.per_device()
        return dataclasses.replace(base, n_devices=n)

    def per_device(self) -> "DeviceProfile":
        """This profile normalized back to a single device."""
        if self.n_devices == 1:
            return self
        return dataclasses.replace(self, n_devices=1)

    # pooled totals (what the estimator divides by) -------------------
    @property
    def total_flops(self) -> float:
        """Pooled peak FLOP/s over the slice."""
        return self.peak_flops * self.n_devices

    @property
    def total_hbm_bw(self) -> float:
        """Pooled HBM bandwidth over the slice."""
        return self.hbm_bw * self.n_devices

    @property
    def total_mem_bytes(self) -> float:
        """Pooled memory capacity over the slice."""
        return self.mem_bytes * self.n_devices

    def scaled(self, factor: float) -> "DeviceProfile":
        """Same roofline shape, magnitudes scaled by ``factor`` — for
        benchmarks that must make a tiny CI model saturate a "device"
        without distorting inter-profile ratios. Capacity and cost are
        NOT scaled (they are not rates).

        Raises:
            ValueError: ``factor`` is not positive.
        """
        if factor <= 0:
            raise ValueError(f"scale factor must be positive, got {factor}")
        return dataclasses.replace(
            self, name=f"{self.name}@{factor:g}",
            peak_flops=self.peak_flops * factor,
            hbm_bw=self.hbm_bw * factor,
            link_bw=self.link_bw * factor)


# ---------------------------------------------------------------------------
# shipped datasheet profiles (dense BF16, per device)
# ---------------------------------------------------------------------------

A100 = DeviceProfile(
    name="a100",
    peak_flops=312e12,       # dense BF16
    hbm_bw=2.039e12,         # HBM2e, 80 GB SXM
    mem_bytes=80e9,
    link_bw=600e9,           # NVLink 3
    cost_rate=1.0,
)

L40S = DeviceProfile(
    name="l40s",
    peak_flops=181e12,       # dense BF16 (no sparsity)
    hbm_bw=0.864e12,         # GDDR6
    mem_bytes=48e9,
    link_bw=64e9,            # PCIe Gen4 x16
    cost_rate=0.45,
)

DEVICE_CATALOG: Dict[str, DeviceProfile] = {p.name: p for p in (A100, L40S)}


def get_profile(name: str) -> DeviceProfile:
    """Look up a catalog profile by name.

    Raises:
        KeyError: unknown profile name (lists the known ones).
    """
    try:
        return DEVICE_CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r} "
                       f"(catalog: {sorted(DEVICE_CATALOG)})") from None


def register_profile(profile: DeviceProfile) -> None:
    """Add/replace a catalog entry (deployments register their own
    measured fleets)."""
    DEVICE_CATALOG[profile.name] = profile


# ---------------------------------------------------------------------------
# host calibration (measured profile of one device of THIS machine)
# ---------------------------------------------------------------------------

# one measured profile per device ("cuda:0", "cpu", ...)
_HOST_CACHE: Dict[str, DeviceProfile] = {}
_CPU_MEM_BYTES = 8 << 30          # the reference's fallback capacity


def calibrate_host_profile(*, device: Union[str, torch.device] = "cuda",
                           probe_dim: int = 384,
                           stream_mib: int = 32,
                           repeats: int = 5,
                           force: bool = False) -> DeviceProfile:
    """Measure a `DeviceProfile` for ``device`` (the card unless the caller
    names the CPU).

    Two probes, each timed over the median of ``repeats`` runs after a
    warm-up call (first-use costs never pollute the measurement); every
    timed call ends in a device synchronisation:

      * FLOP/s: a ``(d, d) x (d, d)`` fp32 matmul — ``2 d^3`` FLOPs;
      * bytes/s: an elementwise ``x + 1`` over a ``stream_mib`` MiB fp32
        tensor — reads + writes the buffer once each.

    ``link_bw`` is set to the measured stream bandwidth (a single-host
    "interconnect" is memory), and ``mem_bytes`` is the card's total
    memory (8 GiB on the CPU, as the reference falls back to).

    The result is cached per device for the process (``force=True``
    re-measures).

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if key in _HOST_CACHE and not force:
        return _HOST_CACHE[key]

    def median_s(fn) -> float:
        fn()                                    # warm-up, outside the clock
        _sync(dev)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append(time.perf_counter() - t0)
        return max(_median(times), 1e-9)

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((probe_dim, probe_dim), generator=gen, device=dev)
    flops = 2.0 * probe_dim**3 / median_s(lambda: a @ a)

    n = (stream_mib << 20) // 4
    x = torch.zeros((n,), dtype=torch.float32, device=dev)
    bw = 2.0 * n * 4 / median_s(lambda: x + 1.0)

    mem = (torch.cuda.get_device_properties(dev).total_memory
           if dev.type == "cuda" else _CPU_MEM_BYTES)
    name = "host" if dev.type == "cpu" else f"host:{key}"
    _HOST_CACHE[key] = DeviceProfile(
        name=name, peak_flops=flops, hbm_bw=bw,
        mem_bytes=float(mem), link_bw=bw)
    return _HOST_CACHE[key]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median(xs) -> float:
    s = sorted(xs)
    return s[len(s) // 2]
