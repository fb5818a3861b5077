"""Meshes of the dry run, and the card's roofline figures.

`make_production_mesh` lays the reference's production meshes, 16 x 16
``("data", "model")`` and 2 x 16 x 16 ``("pod", "data", "model")``, over
the ranks of a FAKE world (`fake_world`: the ``"fake"`` process-group
backend, which moves nothing), so that the port's plans and spec trees
divide over 256 or 512 ranks as they do over the reference's placeholder
devices, in one process, with no card and no network. `make_host_mesh` is
a small mesh over the real local devices.

Hardware model: one NVIDIA H100 SXM 80 GB per rank, 8 cards to a node,
the nodes joined by InfiniBand. Ranks are laid out row-major over the mesh
and fill the nodes in order (ranks 8n .. 8n + 7 share node n). So a group
of the 16-wide ``model`` axis spans two nodes, and a ring over it crosses
InfiniBand twice; a ``data`` or ``pod`` group has each rank on its own
node. Every axis of the production meshes is therefore bound by
InfiniBand's rate (`axis_links`); NVLink would bind an axis only if its
groups fit inside one node.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# the card's roofline figures (NVIDIA's H100 SXM data sheet, dense, at the
# full 700 W power limit)
H100_PEAK_FLOPS_BF16 = 989e12     # FLOP/s, tensor cores, dense
H100_HBM_BW = 3.35e12             # B/s
#: device memory as ``torch.cuda.get_device_properties(0).total_memory``
#: reads on an NVIDIA H100 80GB HBM3 (PERF.md)
H100_HBM_BYTES = 85_017_493_504
# links: assumed data-sheet rates, per card and direction
H100_NVLINK_BW = 450e9            # NVLink 4 within an 8-card node
H100_IB_BW = 50e9                 # InfiniBand NDR (400 Gb/s), one NIC per card
GPUS_PER_NODE = 8

SINGLE_POD = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake world of ``world_size`` ranks
    (the ``"fake"`` backend of `torch.testing._internal.distributed.fake_pg`:
    every collective returns at once and moves nothing), or keep the fake
    world already made if it holds as many ranks or more. A smaller fake
    world is torn down first, with the meshes made over it.

    Raises:
        RuntimeError: a process group of another backend exists: the dry
            run never runs over a real one, nor tears one down.
    """
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(f"a {backend} process group exists in this process; the "
                               "dry run makes its own fake world (run it in a process "
                               "of its own)")
        if dist.get_world_size() >= world_size:
            return
        from repro_torch.sharding import plan as plan_lib
        plan_lib._DEVICE_MESHES.clear()
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def fake_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: Union[str, torch.device] = "cuda"):
    """A `Mesh` over ranks ``0 .. prod(shape) - 1`` of a fake world
    (`fake_world`, made here if needed), laid out row-major, every rank on
    ``device``. This process is rank 0, the mesh's first coordinate."""
    from repro_torch.sharding.plan import Mesh
    n = int(np.prod(shape))
    fake_world(n)
    ranks = np.arange(n).reshape(tuple(shape))
    devs = np.empty(ranks.shape, dtype=object)
    for idx in np.ndindex(ranks.shape):
        devs[idx] = torch.device(device)
    return Mesh(devs, tuple(axis_names), ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """The reference's production mesh over a fake world: 16 x 16
    ``("data", "model")``, or 2 x 16 x 16 ``("pod", "data", "model")``."""
    if multi_pod:
        return fake_mesh(MULTI_POD, MULTI_POD_AXES, device=device)
    return fake_mesh(SINGLE_POD, SINGLE_POD_AXES, device=device)


def make_host_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model"), *,
                   device: Union[str, torch.device] = "cuda"):
    """A small `Mesh` over the real local devices: the first ``prod(shape)``
    cards (or the CPU, once per coordinate, when the caller names it).

    Raises:
        RuntimeError: fewer cards than the mesh needs, or none.
    """
    from repro_torch.models.common import resolve_device
    from repro_torch.sharding.plan import Mesh
    dev = resolve_device(device)
    n = int(np.prod(shape))
    devs = np.empty(tuple(shape), dtype=object)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"mesh {tuple(shape)} needs {n} cards, have {have}")
        for i, idx in enumerate(np.ndindex(devs.shape)):
            devs[idx] = torch.device("cuda", i)
    else:
        for idx in np.ndindex(devs.shape):
            devs[idx] = dev
    return Mesh(devs, tuple(axes))


def axis_links(shape: Sequence[int], axis_names: Sequence[str],
               gpus_per_node: int = GPUS_PER_NODE) -> Dict[str, str]:
    """The link each axis's groups cross under row-major ranks, nodes of
    ``gpus_per_node`` consecutive ranks: ``"nvlink"`` when every group of
    the axis lies inside one node, ``"infiniband"`` when a group spans
    nodes (a ring over it then runs at the slowest hop's rate), ``"none"``
    for an axis of one rank."""
    ranks = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    out = {}
    for ax, name in enumerate(axis_names):
        if shape[ax] == 1:
            out[name] = "none"
            continue
        groups = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        nodes = groups // gpus_per_node
        out[name] = "nvlink" if bool((nodes == nodes[:, :1]).all()) else "infiniband"
    return out


LINK_BW = {"nvlink": H100_NVLINK_BW, "infiniband": H100_IB_BW}


def axis_bandwidth(shape: Sequence[int], axis_names: Sequence[str]) -> Dict[str, Optional[float]]:
    """Bytes per second a rank moves over each axis's binding link (None
    for an axis of one rank)."""
    return {name: LINK_BW.get(link) for name, link in axis_links(shape, axis_names).items()}


def mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(str(n) for n in shape)
