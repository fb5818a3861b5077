"""The sharding helpers in one process on the CPU: a one-rank gloo group
(over a FileStore, no network) and a (1, 1, 1) mesh of it.

The kernel wrappers refuse a DTensor with a `TypeError` on any device;
`constrain` is the identity outside a context and redistributes a DTensor
inside one; `rank_mesh` refuses what it cannot build; a one-rank DTensor
gathers a layer, steps AdamW and places a tensor exactly as the plain path
does; the MoE layer refuses a row split whose dispatch groups would not be
the global ones.
"""
import dataclasses
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree as tree_util
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step, named
from repro_torch.models import Model
from repro_torch.models import lm
from repro_torch.models import mlp as ffn
from repro_torch.optim import AdamW
from repro_torch.sharding import (
    P,
    default_plan,
    param_specs,
    plan_to_placement,
    rank_mesh,
    single_device_mesh,
)
from repro_torch.sharding import ctx


def test_rank_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="process group"):
        rank_mesh((1, 1, 1), device="cpu")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = dist.FileStore(os.fspath(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield rank_mesh((1, 1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def _fp32(arch):
    return dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                               activ_dtype="float32")


def _dt(mesh, x, spec):
    return ctx.place(x, named(mesh, {"x": spec})["x"])


@pytest.mark.parametrize("kernel", ["flash_attention", "moe_topk", "ssd_scan"])
def test_kernel_wrappers_refuse_a_dtensor(mesh, kernel):
    g = torch.Generator().manual_seed(0)
    q = _dt(mesh, torch.randn(1, 8, 2, 16, generator=g), P("data", None, None, None))
    if kernel == "flash_attention":
        call = lambda: ops.flash_attention(q, q, q)  # noqa: E731
    elif kernel == "moe_topk":
        call = lambda: ops.moe_topk(_dt(mesh, torch.randn(8, 4), P("data", None)), 2)  # noqa: E731
    else:
        dt = torch.rand(1, 8, 2)
        A = -torch.rand(2)
        Bm = torch.randn(1, 8, 1, 4)
        call = lambda: ops.ssd_scan(q, dt, A, Bm, _dt(mesh, Bm, P(None)), chunk=4)  # noqa: E731
    before = dict(ops.LAUNCHES)
    with pytest.raises(TypeError, match="DTensor"):
        call()
    assert ops.LAUNCHES == before


def test_rank_mesh_refuses_what_it_cannot_build(mesh):
    with pytest.raises(ValueError, match="does not hold"):
        rank_mesh((2, 1, 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_mesh((1, 1, 1))
    assert mesh.device_mesh() is mesh.device_mesh()          # made once
    assert mesh.device_mesh().mesh_dim_names == ("pod", "data", "model")


def test_plan_to_placement_still_places_an_engine_on_one_device():
    import numpy as np
    devs = np.empty((1, 2, 1), dtype=object)
    devs[0, 0, 0], devs[0, 1, 0] = torch.device("cpu"), torch.device("meta")
    from repro_torch.sharding import Mesh
    with pytest.raises(ValueError, match="2 devices"):
        plan_to_placement(default_plan(), Mesh(devs))
    pinned = default_plan().with_(device_constraints=(("data", 1),))
    assert plan_to_placement(pinned, Mesh(devs)) == {"params": torch.device("meta"),
                                                     "cache": torch.device("meta")}
    assert plan_to_placement(default_plan(), single_device_mesh("cpu"))["cache"].type == "cpu"


def test_constrain_outside_and_inside_a_context(mesh):
    x = torch.randn(4, 6)
    assert ctx.constrain(x, "batch", None) is x and ctx.current() is None
    d = _dt(mesh, x, P())
    with ctx.activation_sharding(mesh, default_plan()):
        assert ctx.current() == (mesh, default_plan())
        assert ctx.constrain(x, "batch", None) is x                # a rank's own rows
        y = ctx.constrain(d, "batch", "tp")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Replicate(), Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), x)
        with pytest.raises(ValueError, match="constrain"):
            ctx.constrain(x, "batch")
        with pytest.raises(ValueError, match="unknown logical axis"):
            ctx.constrain(x, "heads", None)
        assert ctx.row_shards() == 1 and torch.equal(ctx.batch_sum(x), x)
    assert ctx.current() is None


def test_layer_slice_and_place_on_one_rank(mesh):
    cfg = _fp32("minitron_4b")
    model = Model(cfg, device="cpu")
    params = ctx.place_tree(model.params, named(mesh, param_specs(cfg, default_plan())))
    w = model.params["layers"]["mixer"]["wq"]
    dw = params["layers"]["mixer"]["wq"]
    assert dw.to_local().data_ptr() == w.data_ptr()           # one rank: a view, no copy
    assert torch.equal(lm.layer_slice(dw, 1), w[1])
    assert all(torch.equal(lm.layer_params(params["layers"], i)["mixer"]["wq"],
                           lm.layer_params(model.params["layers"], i)["mixer"]["wq"])
               for i in range(cfg.num_layers))


def test_adamw_on_dtensors_equals_plain_adamw(mesh):
    cfg = _fp32("qwen2_moe_a2_7b")
    opt = AdamW(lr=1e-3, clip_norm=0.5)
    plain = Model(cfg, device="cpu").params
    sharded = ctx.place_tree(Model(cfg, device="cpu").params,
                             named(mesh, param_specs(cfg, default_plan())))
    g = torch.Generator().manual_seed(1)
    grads = tree_util.map_tree(lambda _, p: torch.randn(p.shape, generator=g), plain)
    s_plain, s_sharded = opt.init(plain), opt.init(sharded)
    assert isinstance(s_sharded["count"], DTensor)
    opt.update(grads, s_plain, plain)
    opt.update(ctx.place_tree(grads, named(mesh, param_specs(cfg, default_plan()))),
               s_sharded, sharded)
    for tree_a, tree_b in ((plain, sharded), (s_plain["m"], s_sharded["m"]),
                           (s_plain["v"], s_sharded["v"])):
        for (name, a), (_, b) in zip(tree_util.items(tree_a), tree_util.items(tree_b)):
            assert torch.equal(a, b.full_tensor()), name


def test_sharded_train_step_needs_a_plan(mesh):
    model = Model(_fp32("minitron_4b"), device="cpu")
    with pytest.raises(ValueError, match="plan"):
        make_train_step(model, AdamW(), mesh=mesh)


class _TwoWay:
    """A mesh stand-in whose data axis is two ranks wide (the grouping
    check reads the extent alone)."""

    shape = {"pod": 1, "data": 2, "model": 1}


@pytest.mark.parametrize("tokens,ok", [(8, True), (256, True), (1024, True), (600, False)])
def test_moe_refuses_a_row_split_that_regroups_tokens(tokens, ok):
    cfg = _fp32("qwen2_moe_a2_7b")
    p = lm.layer_params(Model(cfg, device="cpu").params["layers"], 0)["ffn"]
    x = torch.randn(1, tokens, cfg.d_model)
    with ctx.activation_sharding(_TwoWay(), default_plan(), row_axes=("data",)):
        if ok:
            out, _ = ffn.moe_ffn(cfg, p, x, kernel=False)
            assert out.shape == x.shape
        else:
            with pytest.raises(ValueError, match="dispatch groups"):
                ffn.moe_ffn(cfg, p, x, kernel=False)
