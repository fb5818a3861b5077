"""Sharding across ranks on a real 4-rank gloo mesh on the CPU.

One job (`_torch_dist_jobs.sharding_job`) runs once for the module on four
spawned ranks (one thread each, killed when no part finishes for 300 s,
or after 1200 s in all; ~30 s alone, 90 s beside the other five workers
of the whole suite's `-n 6` run), over two meshes of
``("pod", "data", "model")``: ``(1, 2, 2)`` under `default_plan()` and
``(2, 2, 1)`` under `default_plan(multi_pod=True)`. The tests below assert
on what each rank found:

  * `plan_to_shardings`: each leaf's local shape is DTensor's chunk of its
    spec at the rank's coordinates, the shards put together are the leaf;
    a pinned plan's sub-mesh is made on every rank, cached, and empty on the
    ranks outside it;
  * `SyntheticLM.sharded_batch_at`: each rank's rows, put together, are
    `batch_at` (batches of 4, 6 and 1 rows);
  * `jit_prefill` / `jit_decode_step` on reduced fp32 Minitron, Qwen-MoE,
    Mamba2, Jamba and Whisper (tensor-parallel over the model axis of 2 on
    ``(1, 2, 2)``, Whisper's layers gathered): logits and the prefill
    cache within atol
    1e-5 + rtol 1e-5 of the one-device model's, greedy streams equal (the
    MoE tokens a rank holds form drop-free groups, as the global ones do:
    `moe_ffn` refuses a split where they would not);
  * `jit_train_step`, accumulation 1 and 2, gradients reduce-scattered or
    all-reduced: the loss and metrics within 1e-5 relative of the
    one-device step's, params and moments within
    `tests/test_torch_train_step.py`'s tolerance and its 0.1 % sign-flip
    allowance;
  * a `TrainRunner` checkpoint saved on ``(1, 2, 2)`` restores on ``(2, 2,
    1)`` under that mesh's shardings, equal to the saved state;
  * the collectives traced from one sharded decode step cross ``data``
    (and ``model`` on ``(1, 2, 2)``), never ``pod``;
    `ServingCluster.verify_engine_collectives` passes them for a route
    forbidding ``pod`` and fails closed for one forbidding an axis they
    cross.
"""
import dataclasses
import math

import pytest
from _torch_dist_jobs import ARCHS, TRAIN_ARCHS, run_job

from repro_torch.configs import get_reduced_config
from repro_torch.core.validator import axes_crossed
from repro_torch.models import Model
from repro_torch.serving import ServingCluster, ServingEngine
from repro_torch.sharding import AXIS_NAMES, default_plan

MESHES = {"1x2x2": (1, 2, 2), "2x2x1": (2, 2, 1)}


@pytest.fixture(scope="module")
def ranks():
    return run_job("sharding_job", world=4, timeout=1200.0, stall=300.0)


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), result.get("error")
    return result


def _chunk(size, n, i):
    """DTensor's (torch.chunk's) size of chunk ``i`` of ``n``."""
    c = math.ceil(size / n)
    return max(0, min(c, size - i * c))


def _expected_local(shape, spec, coord, mesh_shape):
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n, idx = 1, 0
        for a in axes:
            k = AXIS_NAMES.index(a)
            idx = idx * mesh_shape[k] + coord[k]
            n *= mesh_shape[k]
        out.append(_chunk(size, n, idx))
    return tuple(out)


@pytest.mark.parametrize("arch", ["minitron_4b", "mamba2_370m"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plan_to_shardings_local_shapes_and_reassembly(ranks, mesh, arch):
    n = 0
    for r in ranks:
        for (m, a, kind, name), got in _ok(r["shardings"]).items():
            if (m, a) != (mesh, arch):
                continue
            n += 1
            assert got["equal"], (r["rank"], kind, name)
            assert got["local"] == _expected_local(got["shape"], got["spec"], got["coord"],
                                                   MESHES[mesh]), (r["rank"], kind, name, got)
    assert n > 0


def test_pinned_plan_makes_its_sub_mesh_on_every_rank(ranks):
    for r in ranks:
        got = _ok(r["restricted"])
        assert got["sub_ranks"] == [2, 3] and got["cached"]
        if r["rank"] in (2, 3):
            assert got["coord"] == (0, 0, r["rank"] - 2)
            assert got["range"] == ((0, 12) if r["rank"] == 2 else (12, 24))
        else:
            assert got["coord"] is None and got["range"] == (0, 0) and got["local"] == (0,)


@pytest.mark.parametrize("batch", [4, 6, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_batch_reassembles_to_batch_at(ranks, mesh, batch):
    shards = math.prod(MESHES[mesh][:2]) if mesh == "2x2x1" else 2
    rows = []
    for r in ranks:
        got = _ok(r["batch"])[(mesh, batch)]
        assert got["equal"]
        rows.append(got["local_rows"])
    if batch == 1:
        assert rows == [1] * 4
    else:
        assert max(rows) == math.ceil(batch / shards)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_one_device(ranks, arch, mesh):
    for r in ranks:
        got = _ok(r[f"serve/{arch}/{mesh}"])
        assert got["tokens_equal"], (r["rank"], got)
        assert got["logit_excess"] <= 0, got
        assert got["cache_err"] <= 0, got
        assert got["dtensor_cache"]
        want = ("(Replicate(), Shard(dim=0), Shard(dim=1))" if mesh == "1x2x2"
                else "(Shard(dim=0), Shard(dim=0), Shard(dim=1))")
        assert got["logits_placements"] == want


@pytest.mark.parametrize("shard_grads", [True, False])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_one_device(ranks, arch, mesh, accum, shard_grads):
    for r in ranks:
        got = _ok(r[f"train/{arch}/{mesh}/{accum}/{shard_grads}"])
        assert got["loss"] == pytest.approx(got["ref_loss"], rel=1e-5)
        for k, v in got["ref_metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        p = got["params"]
        assert p["bad"] == 0 and p["flips"] <= 1e-3 * p["total"], p
        assert got["m"]["bad"] == 0 and got["v"]["bad"] == 0, (got["m"], got["v"])
        assert got["count"] == 1 and got["state_placed"]
        assert got["loss_placements"] == "(Replicate(), Replicate(), Replicate())"


def test_checkpoint_saved_on_one_mesh_restores_on_another(ranks):
    losses = None
    for r in ranks:
        got = _ok(r["checkpoint"])
        assert got["restored"] and got["step"] == 3 and got["load_step"] == 3
        assert got["equal"] and got["direct_equal"] and got["placed"]
        assert got["losses"][-1] < got["losses"][0]
        losses = losses or got["losses"]
        assert got["losses"] == losses                 # every rank saw one loss
        assert got["resumed"] == (4, 1)              # recover_and_run under shardings
        assert got["resumed_loss"] == pytest.approx(got["losses"][-1], rel=0.05)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_collectives_cross_data_not_pod(ranks, mesh):
    want = {"data", "model"} if mesh == "1x2x2" else {"data"}
    for r in ranks:
        colls = _ok(r["collectives"])[mesh]
        assert colls and all(c.ranks is not None for c in colls)
        crossed = set()
        for c in colls:
            crossed |= set(axes_crossed(c.ranks, MESHES[mesh], AXIS_NAMES))
        assert crossed == want, (r["rank"], crossed)


def _cluster(forbidden):
    cfg = dataclasses.replace(get_reduced_config("minitron_4b"),
                              param_dtype="float32", activ_dtype="float32")
    plan = default_plan().with_(forbidden_collective_axes=(forbidden,))
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", plan)
    cluster.register("e0", ServingEngine(Model(cfg, device="cpu"), n_slots=2, s_max=16,
                                         device="cpu"), plan=plan)
    return cluster


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_verify_engine_collectives_over_real_groups(ranks, mesh):
    colls = _ok(ranks[0]["collectives"])[mesh]
    topo = dict(mesh_shape=MESHES[mesh], axis_names=AXIS_NAMES)
    detail = _cluster("pod").verify_engine_collectives("e0", collectives=colls, **topo)
    assert f"{len(colls)} collectives checked" in detail
    crossed = "model" if mesh == "1x2x2" else "data"
    with pytest.raises(ValueError, match="fail-closed"):
        _cluster(crossed).verify_engine_collectives("e0", collectives=colls, **topo)


def test_every_part_of_the_job_ran(ranks):
    for r in ranks:
        errors = {k: v["error"] for k, v in r.items()
                  if isinstance(v, dict) and "error" in v}
        assert not errors, errors
        assert sum(r["seconds"].values()) < 150
