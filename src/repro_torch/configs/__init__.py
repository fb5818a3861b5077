"""Architecture config registry of the port.

Each architecture lives in its own module exposing ``CONFIG`` (the published
configuration) and ``reduced()`` (a tiny same-family config for CPU tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    EncDecConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SHAPE_CELLS,
    ShapeCell,
    SSMConfig,
    get_shape_cell,
)

#: the reference's architectures (`repro.configs.ARCH_IDS`)
ARCH_IDS: List[str] = [
    "whisper_large_v3",
    "minicpm3_4b",
    "nemotron_4_340b",
    "minitron_4b",
    "deepseek_coder_33b",
    "qwen2_vl_2b",
    "qwen2_moe_a2_7b",
    "moonshot_v1_16b_a3b",
    "jamba_v0_1_52b",
    "mamba2_370m",
]

#: the architectures this port can build: all of the reference's
PORTED: List[str] = list(ARCH_IDS)

_ALIASES: Dict[str, str] = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
})


def _module(arch: str):
    key = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    """Every architecture's published config, by module name."""
    return {a: importlib.import_module(f"repro_torch.configs.{a}").CONFIG for a in ARCH_IDS}


def applicable_cells(cfg: ModelConfig) -> List[ShapeCell]:
    """Shape cells that actually run for this architecture (the
    reference's rule).

    ``long_500k`` requires sub-quadratic sequence mixing and runs only for
    the SSM and hybrid families; the full-attention architectures skip it.
    """
    return [c for c in SHAPE_CELLS
            if c.name != "long_500k" or cfg.family in ("ssm", "hybrid")]
