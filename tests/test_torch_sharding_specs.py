"""The port's spec trees against the reference's `PartitionSpec`s.

`param_specs`, `opt_state_specs`, `cache_specs`, `batch_specs` and
`prune_spec` are pure functions of (config, plan). On every reduced config
and every plan below, each port spec must equal the reference's, leaf by
leaf, matched by path name. The reference nests a hybrid or enc-dec cache
(``{"pos0": {"k": ...}}``); the port's cache is flat (``"pos0/k"``), so its
names are the reference's paths joined by ``/``. Every spec must also fit
its leaf: a rank no larger than the leaf's, as `tests/test_system.py`
holds for the reference.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_reduced_config as jax_reduced
from repro.configs import get_shape_cell as jax_cell
from repro.sharding import plan as jplan
from repro_torch import tree as tree_util
from repro_torch.configs import ARCH_IDS, get_reduced_config, get_shape_cell
from repro_torch.models import encdec, lm
from repro_torch.sharding import plan as tplan

PLANS = {
    "default": lambda m: m.ShardingPlan(),
    "seq_model": lambda m: m.ShardingPlan(seq_axis="model"),
    "multi_pod": lambda m: m.default_plan(multi_pod=True),
    "no_tp": lambda m: m.ShardingPlan(tp_axis=None, shard_vocab=False, shard_attn_heads=False),
}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in flat}


def _port_flat(tree):
    return {name: tuple(spec) for name, spec in tree_util.items(tree)}


def _param_shapes(cfg):
    layout = (encdec.param_layout(cfg, max_seq=64) if cfg.encdec is not None
              else lm.param_layout(cfg))
    return {name: leaf.shape for name, leaf in tree_util.items(
        lm.map_layout(lambda _, leaf: leaf, layout))}


def _cache_shapes(cfg, batch):
    if cfg.encdec is not None:
        return encdec.cache_shape(cfg, batch, 32, 16)
    return lm.cache_shape(cfg, batch, 32)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, plan):
    ref = _ref_flat(jplan.param_specs(jax_reduced(arch), PLANS[plan](jplan)))
    cfg = get_reduced_config(arch)
    port = _port_flat(tplan.param_specs(cfg, PLANS[plan](tplan)))
    assert port == ref
    shapes = _param_shapes(cfg)
    assert set(shapes) == set(port)
    for name, spec in port.items():
        assert len(spec) <= len(shapes[name]), (name, spec, shapes[name])


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_match_reference(arch, plan):
    jp, tp = PLANS[plan](jplan), PLANS[plan](tplan)
    ref = _ref_flat(jplan.opt_state_specs(jplan.param_specs(jax_reduced(arch), jp)))
    port = _port_flat(tplan.opt_state_specs(tplan.param_specs(get_reduced_config(arch), tp)))
    assert port == ref
    assert port["count"] == ()


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, plan, batch):
    ref = _ref_flat(jplan.cache_specs(jax_reduced(arch), PLANS[plan](jplan), batch=batch))
    cfg = get_reduced_config(arch)
    port = _port_flat(tplan.cache_specs(cfg, PLANS[plan](tplan), batch=batch))
    assert port == ref
    shapes = _cache_shapes(cfg, batch)
    assert set(shapes) == set(port)
    for name, spec in port.items():
        assert len(spec) <= len(shapes[name]), (name, spec, shapes[name])
        if batch == 1:
            assert spec[1] is None


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_reference(arch, cell):
    for name, make in PLANS.items():
        ref = {k: tuple(v) for k, v in jplan.batch_specs(
            jax_reduced(arch), make(jplan), jax_cell(cell)).items()}
        port = {k: tuple(v) for k, v in tplan.batch_specs(
            get_reduced_config(arch), make(tplan), get_shape_cell(cell)).items()}
        assert port == ref, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prune_spec_matches_reference(arch):
    axes = ("data", "model")
    for make in PLANS.values():
        ref = _ref_flat(jplan.param_specs(jax_reduced(arch), make(jplan)))
        port = _port_flat(tplan.param_specs(get_reduced_config(arch), make(tplan)))
        for name, spec in port.items():
            got = tuple(tplan.prune_spec(tplan.P(*spec), axes))
            assert got == tuple(jplan.prune_spec(JP(*ref[name]), axes)), name
            assert all(e is None or e in axes or set(e) <= set(axes) for e in got)


def test_partition_spec_is_normalised_as_the_reference():
    P = tplan.PartitionSpec
    assert tuple(P(("data",), "model")) == tuple(JP(("data",), "model")) == ("data", "model")
    assert tuple(P((), "model")) == (None, "model")
    assert tuple(P(("pod", "data"))) == (("pod", "data"),)
    assert P(("data",)).axes(0) == ("data",) and P(("pod", "data")).axes(0) == ("pod", "data")
    assert P(None).axes(0) == () and P().axes(3) == ()
    with pytest.raises(TypeError):
        P(3)


def test_spec_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    P = tplan.PartitionSpec
    axes = tplan.AXIS_NAMES
    assert tplan.spec_placements(P(("pod", "data"), None), axes) == (Shard(0), Shard(0), Replicate())
    assert tplan.spec_placements(P(None, "data", "model"), axes) == (Replicate(), Shard(1), Shard(2))
    assert tplan.spec_placements(P(), axes) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tplan.spec_placements(P("data", "data"), axes)
