"""Checkpoints in the reference's format, so either package loads the
other's.

A checkpoint is ``<dir>/step_%08d/`` holding ``leaves.npz`` (entries
``leaf_i``, the tree's leaves in sorted-key order) and ``manifest.json``
(step, time, and each leaf's path name, such as
``params/layers/mixer/wq``, dtype and shape). bf16 leaves are stored as
fp32 and cast back on restore. A save writes a temporary directory and
renames it into place, and keeps the last ``keep`` steps.

Sharded state (DTensor leaves) saves whole: every rank calls the save, each
leaf is gathered, rank 0 writes and prunes, and the others wait at a
barrier. A restore places each leaf under the shardings it is given, on any
mesh, the one that saved or another (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.models.common import resolve_device
from repro_torch.sharding.ctx import full, is_dtensor, place

Tree = Dict[str, Any]

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.int32: "int32", torch.int64: "int64", torch.int8: "int8"}


def _remove(directory: Path) -> None:
    for f in directory.iterdir():
        f.unlink()
    directory.rmdir()


def save_checkpoint(ckpt_dir: Union[str, Path], step: int, tree: Tree, *,
                    keep: int = 3) -> Path:
    """Write ``tree`` (nested dicts of tensors) as step ``step``; returns
    its directory. If that step is saved already, the existing one stays.

    With DTensor leaves every rank must call this: gathering a leaf is a
    collective. Rank 0 writes; every rank returns after it has."""
    ckpt_dir = Path(ckpt_dir)
    flat = list(tree_util.items(tree))
    final = ckpt_dir / f"step_{step:08d}"

    def to_np(leaf: torch.Tensor) -> np.ndarray:
        leaf = full(leaf.detach())
        if leaf.dtype == torch.bfloat16:      # npz cannot hold bf16: store fp32
            leaf = leaf.float()
        return leaf.cpu().numpy()

    if any(is_dtensor(leaf) for _, leaf in flat):
        import torch.distributed as dist
        arrays = [to_np(leaf) for _, leaf in flat]
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, flat, arrays, keep)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, flat, [to_np(leaf) for _, leaf in flat], keep)


def _write(ckpt_dir: Path, step: int, flat: list, arrays: list, keep: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    np.savez(tmp / "leaves.npz", **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "time": time.time(),
        "names": [name for name, _ in flat],
        "dtypes": [_DTYPE_NAMES[leaf.dtype] for _, leaf in flat],
        "shapes": [list(leaf.shape) for _, leaf in flat],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        # already saved (a restart raced it): keep the existing one
        _remove(tmp)
        return final
    os.rename(tmp, final)

    ckpts = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for old in ckpts[:-keep]:
        _remove(old)
    return final


def latest_step(ckpt_dir: Union[str, Path]) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: Union[str, Path], like: Tree, *,
                    step: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda",
                    shardings: Optional[Tree] = None) -> Tuple[int, Tree]:
    """Restore step ``step`` (the latest by default) into the structure and
    dtypes of ``like``, with every leaf on ``device`` (the card unless the
    caller names the CPU). Returns (step, tree).

    ``shardings``, a tree of `LeafSharding` congruent with ``like`` (e.g.
    from `launch.steps.named` or `sharding.plan_to_shardings`), places each
    leaf as a DTensor under its sharding: each rank reads the checkpoint
    and keeps its own shards, on any mesh of ``device``'s type.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
        FileNotFoundError: the directory holds no checkpoint.
        KeyError: the checkpoint lacks a leaf of ``like``.
        ValueError: a sharding's mesh is not of ``device``'s type.
    """
    dev = resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    index = {name: i for i, name in enumerate(manifest["names"])}
    with np.load(d / "leaves.npz") as data:
        def restore(name, leaf):
            if name not in index:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[f"leaf_{index[name]}"]
            return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)

        if shardings is None:
            return step, tree_util.map_tree(restore, like)

        def restore_sharded(name, leaf, sh):
            if sh.mesh.device_type != dev.type:
                raise ValueError(f"{name}: a {sh.mesh.device_type} mesh, restoring to {dev}")
            return place(restore(name, leaf), sh)

        return step, tree_util.map_tree(restore_sharded, like, shardings)
