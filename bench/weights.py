"""The served weights, made by the benchmark on the device from ``--seed``,
and the port's configuration object built from a config file's ``model``
section. The same tensors go to the program (`repro_torch.models.Model`'s
``params``) and to the plain reference (`bench.reference.lm`)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from bench.traffic.generator import seed_key


def model_config(model: Dict[str, Any]):
    """The port's `ModelConfig` of a config file's ``model`` section."""
    from repro_torch.configs.base import MoEConfig, ModelConfig
    kw = dict(model)
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def make_params(cfg, seed: int, device) -> Dict[str, Any]:
    """Random weights in the port's parameter layout (its keys and
    shapes, `repro_torch.models.lm.param_layout`), each leaf one draw of a
    `torch.Generator` on ``device`` in the dtype it is served in (a leaf
    stacks every layer, so a model takes a dozen or so calls): normal with
    the layout's std where it names one, else ``fan_in ** -0.5`` over the
    leaf's input dimension (the one before last); the embedding and the LM
    head 0.02; norm scales 1, biases 0."""
    from repro_torch.models import lm
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_key(seed))

    def make(_, leaf):
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
        if leaf.init == "embed":
            std = 0.02
        elif isinstance(leaf.init, float):
            std = leaf.init
        elif leaf.init is None:
            std = leaf.shape[-2] ** -0.5
        else:
            raise ValueError(f"no draw for a leaf initialised as {leaf.init!r}")
        w = torch.randn(leaf.shape, generator=gen, dtype=leaf.dtype, device=device)
        return w.mul_(std)

    return lm.map_layout(make, lm.param_layout(cfg))
