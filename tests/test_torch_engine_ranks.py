"""A `ServingEngine` whose params and pool span several ranks, and the
sharded train step on an uneven microbatch split, on a 4-rank gloo mesh on
the CPU, against the reference on four placeholder JAX devices.

The module fixture starts everything at once (~60 s of wall time alone,
several times that beside the rest of the suite on a loaded machine):

  * ONE job of 4 gloo ranks (`_torch_engine_ranks_jobs.engine_ranks_job`,
    one thread each, killed when no part finishes for `STALL_S` or after
    `LIMIT_S` in all), over meshes ``(1, 2, 2)`` under `default_plan()`
    and ``(2, 2, 1)`` under `default_plan(multi_pod=True)`; the plan's
    model axis of 2 on ``(1, 2, 2)`` runs the serving steps tensor-parallel;
  * the reference's `ServingCluster` doing the same serving steps in child
    processes (`_torch_engine_ranks_ref.py`, ``XLA_FLAGS`` for 4 host
    devices and one intra-op thread set before JAX starts), one per
    architecture and mesh group;
  * the reduced Nemotron-4-340B's multi-pod ``train_4k`` dry run with
    ``accum_steps=16`` on the fake 2 x 16 x 16 world (its own process).

Both sides serve the same weights (the port's seeded init of reduced fp32
Minitron-4B (paged), Qwen1.5-MoE (paged, MoE) and Jamba (slot pool,
hybrid), written once by the fixture): six requests on one engine, swapped
from one device to every rank, to pod 0, and back to every rank under a
plan claiming a route that forbids ``pod``, with requests resident; one
lane exported and imported; served to the end. Held equal: the greedy
streams, migrated bytes, executables compiled in PREPARE, residents and
completions at each swap, the validator's verdicts, the migration's bytes,
and free pages, queue and residents after every step.

On ``(1, 2, 2)`` the reference faults (ROADMAP, reference faults): its AOT
decode executable hands back the store in the sharding XLA propagated, and
its next call refuses it. There the port is held to the reference up to the
fault, and after it to the reference's mesh-independent records of ``(2,
2, 1)`` and to its own one-device engine.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
from _torch_dist_jobs import _fp32, run_job
from _torch_engine_ranks_jobs import ENGINE_ARCHS, UNEVEN

from repro_torch.models import Model
from repro_torch.sharding.ctx import activation_sharding

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("1x2x2", "2x2x1")
REF_GROUPS = ("minitron_4b:1x2x2,minitron_4b:2x2x1,qwen2_moe_a2_7b:1x2x2,qwen2_moe_a2_7b:2x2x1",
              "jamba_v0_1_52b:1x2x2", "jamba_v0_1_52b:2x2x1")
#: the fixture's limits: the rank job is killed when no part finishes for
#: STALL_S seconds (a rank that raised inside a collective leaves the others
#: waiting; the longest part takes ~15 s alone); every process is given
#: LIMIT_S in all. The fixture takes ~60 s alone and took 380 s beside the
#: other five workers of the whole suite's `-n 6` run on 8 cores.
STALL_S = 300
LIMIT_S = 1200


def _write_weights(out):
    """The port's seeded weights of each config, as the numpy tree both
    packages load."""
    from repro_torch import tree as tree_util
    for arch in ENGINE_ARCHS:
        params = Model(_fp32(arch), device="cpu").params
        tree = tree_util.map_tree(lambda _, x: x.numpy(), params)
        with open(os.path.join(out, f"{arch}.pkl"), "wb") as f:
            pickle.dump(tree, f)


def _popen(args, env):
    return subprocess.Popen([sys.executable] + args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


@pytest.fixture(scope="module")
def jobs():
    tmp = tempfile.mkdtemp()
    _write_weights(tmp)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    refs = [_popen([str(ROOT / "tests" / "_torch_engine_ranks_ref.py"), tmp, g], env)
            for g in REF_GROUPS]
    dry = _popen(["-c", "import json; from repro_torch.configs import get_reduced_config; "
                  "from repro_torch.launch import dryrun; "
                  "r = dryrun.dry_run_cell('nemotron-4-340b', 'train_4k', multi_pod=True, "
                  "device='cpu', accum_steps=16, config_fn=get_reduced_config); "
                  "print(json.dumps({'status': 'ok', 'accum_steps': r['accum_steps'], "
                  "'mesh': r.get('mesh'), 'argument_bytes': r['memory']['argument_bytes']}))"],
                 env)
    deadline = time.monotonic() + LIMIT_S
    old = os.environ.get("ENGINE_WEIGHTS")
    os.environ["ENGINE_WEIGHTS"] = tmp
    try:
        ranks = run_job("engine_ranks_job", world=4, timeout=LIMIT_S, stall=STALL_S,
                        module="_torch_engine_ranks_jobs")
    finally:
        if old is None:
            os.environ.pop("ENGINE_WEIGHTS", None)
        else:
            os.environ["ENGINE_WEIGHTS"] = old
    ref = {}
    for p in refs:
        try:
            stdout, stderr = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            p.kill()
        assert p.returncode == 0, f"reference failed:\n{stderr[-3000:]}"
        ref.update(json.loads(stdout.strip().splitlines()[-1]))
    try:
        stdout, stderr = dry.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        dry.kill()
    assert dry.returncode == 0, f"dry run failed:\n{stderr[-3000:]}"
    return {"ranks": ranks, "ref": ref, "dryrun": json.loads(stdout.strip().splitlines()[-1])}


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), result.get("error")
    return result


# ---------------------------------------------------------------------------
# A: the uneven microbatch split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(UNEVEN))
@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b"])
def test_uneven_microbatch_matches_one_device_step(jobs, arch, mesh):
    """2 rows a microbatch over 4 ranks (two ranks without rows) and 3 over
    2: the loss, metrics, params and moments within the sharded train step's
    tolerances of the one-device step's, on every rank."""
    for out in jobs["ranks"]:
        r = _ok(out[f"uneven/{arch}/{mesh}"])
        assert r["micro_rows"] in (2, 3)
        assert abs(r["loss"] - r["ref_loss"]) <= 1e-5 * abs(r["ref_loss"])
        for k, v in r["ref_metrics"].items():
            assert abs(r["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k
        assert r["params"]["bad"] == 0
        assert r["params"]["flips"] <= 1e-3 * r["params"]["total"]
        assert r["m"]["bad"] == 0 and r["v"]["bad"] == 0


def test_nemotron_multi_pod_train_dry_run_records(jobs):
    """Reduced Nemotron-4-340B's ``train_4k`` with 16 microbatches of 16
    rows over ("pod", "data"), 32 ways, runs to a record on the fake 2 x
    16 x 16 world (it raised before)."""
    d = jobs["dryrun"]
    assert d["status"] == "ok" and d["accum_steps"] == 16
    assert d["argument_bytes"] > 0


@pytest.mark.parametrize("rows,S,raises", [(3, 200, True), (2, 256, False), (4, 512, False),
                                           (3, 512, True), (2, 100, False)])
def test_moe_refuses_groups_that_would_differ(rows, S, raises):
    """A rank's tokens form the reference's global dispatch groups only
    when every group is drop-free, or every rank starts on a group boundary
    and fills whole groups; otherwise `moe_ffn` raises with that reason."""
    import torch

    from repro_torch.models import mlp
    from repro_torch.sharding.plan import Mesh, default_plan
    devs = np.empty((1, 2, 1), dtype=object)
    devs[...] = torch.device("cpu")
    with activation_sharding(Mesh(devs), default_plan(), row_axes=("data",), rows=rows):
        chunk = -(-rows // 2)
        if raises:
            with pytest.raises(ValueError, match="dispatch groups are not the global ones"):
                mlp._check_grouping(chunk, S)
        else:
            mlp._check_grouping(chunk, S)
            mlp._check_grouping(rows - chunk, S)


def test_kernel_wrappers_return_empty_results_without_their_op(monkeypatch):
    """A rank without rows: each wrapper returns the empty result before
    its op (on the card, before the launch)."""
    import torch

    from repro_torch.kernels import ops

    def boom(*a, **k):
        raise AssertionError("op called on an empty input")

    for name in ("flash_attention_ref", "moe_topk_ref", "ssd_scan_ref"):
        monkeypatch.setattr(ops.ref, name, boom)
    q = torch.zeros((0, 8, 4, 16))
    assert ops.flash_attention(q, q[:, :, :2], q[:, :, :2]).shape == q.shape
    w, i = ops.moe_topk(torch.zeros((0, 8)), 2)
    assert w.shape == (0, 2) and w.dtype == torch.float32 and i.dtype == torch.int32
    x = torch.zeros((0, 16, 4, 8))
    y, h = ops.ssd_scan(x, torch.zeros((0, 16, 4)), torch.zeros(4), torch.zeros((0, 16, 1, 6)),
                        torch.zeros((0, 16, 1, 6)), chunk=8)
    assert y.shape == x.shape and h.shape == (0, 4, 8, 6)


# ---------------------------------------------------------------------------
# B: the engine across ranks against the reference
# ---------------------------------------------------------------------------


def _port(jobs, arch, mesh, rank=0):
    return _ok(jobs["ranks"][rank][f"engine/{arch}/{mesh}"])


def _ref(jobs, arch, mesh):
    r = jobs["ref"][f"{arch}:{mesh}"]
    assert "trace" not in r, r.get("trace")
    return r


def _streams(d):
    return {int(k): list(v) for k, v in d.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_across_ranks_matches_reference(jobs, arch, mesh):
    """Per step, swap and migration, the port's 4-rank engine records what
    the reference's 4-device engine records (up to the reference's fault on
    ``(1, 2, 2)``, its mesh-independent ``(2, 2, 1)`` records after it)."""
    port, ref = _port(jobs, arch, mesh), _ref(jobs, arch, mesh)
    full = ref if "fault" not in ref else _ref(jobs, arch, "2x2x1")
    n = ref["fault"]["at_step"] if "fault" in ref else len(ref["steps"])
    assert port["steps"][:n] == ref["steps"][:n]
    if "fault" not in ref:
        assert port["steps"] == ref["steps"]
    for got, want in zip(port["reports"], full["reports"]):
        assert got == want
    assert len(port["reports"]) == len(full["reports"]) == 3
    assert port["migration"] == full["migration"]
    assert _streams(port["streams"]) == _streams(full["streams"])
    assert _streams(port["streams"]) == _streams(port["solo_streams"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_validator_verdicts_match_reference(jobs, arch, mesh):
    """A route forbidding ``pod``: the plan pinned to pod 0 passes; the plan
    spanning both pods fails where the reference's HLO check fails it (on
    ``(2, 2, 1)``) and passes on ``(1, 2, 2)``, whose pod axis has one
    coordinate. Equal on every rank."""
    ref = _ref(jobs, arch, mesh)
    full = _ref(jobs, arch, "2x2x1")
    verdicts = [_port(jobs, arch, mesh, r)["verdicts"] for r in range(4)]
    assert all(v == verdicts[0] for v in verdicts)
    got = {k: v.split(":")[0] for k, v in verdicts[0].items()}
    assert got["all"] == ref["verdicts"]["all"].split(":")[0] == "pass"
    if mesh == "2x2x1":
        assert got == {k: v.split(":")[0] for k, v in full["verdicts"].items()}
        assert got["pod0"] == "pass" and got["nopod"] == "fail"
    else:
        assert got == {"all": "pass", "pod0": "pass", "nopod": "pass"}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_layouts_and_host_state_across_ranks(jobs, arch, mesh):
    """Every rank keeps the same host state (steps, reports, migration);
    the layouts span every rank, then pod 0's (both ranks on ``(1, 2, 2)``'s
    single pod: all four), then every rank; a rank outside pod 0 holds no
    shard, and every rank holds its chunk of each leaf under the plan's
    specs (its model-axis shard included), no more; decode ran eagerly across ranks by design, on each rank's
    model-axis shards on ``(1, 2, 2)`` (every group of these configs
    divides its model axis of 2, so none ran gathered), with nothing to
    split on ``(2, 2, 1)``'s model axis of one rank."""
    outs = [_port(jobs, arch, mesh, r) for r in range(4)]
    for o in outs[1:]:
        assert o["steps"] == outs[0]["steps"]
        assert o["reports"] == outs[0]["reports"]
        assert o["migration"] == outs[0]["migration"]
    pod0 = [0, 1] if mesh == "2x2x1" else [0, 1, 2, 3]
    for r, o in enumerate(outs):
        members = [lay["members"] for lay in o["layouts"]]
        assert members == [[0, 1, 2, 3], pod0, [0, 1, 2, 3]]
        if r not in pod0:
            assert o["layouts"][1]["local_params"] == 0
        else:
            assert o["layouts"][1]["local_params"] > 0
        for lay in o["layouts"]:
            assert lay["local_params"] == lay["shard_params"]
        assert o["stats"]["multi_rank_eager"] > 0 and o["stats"]["replays"] == 0
        if mesh == "1x2x2":
            assert o["stats"]["tp_local"] > 0 and o["stats"]["tp_gathered"] == 0
        else:
            assert o["stats"]["tp_local"] == o["stats"]["tp_gathered"] == 0


def test_reference_fault_on_the_single_pod_mesh(jobs):
    """The reference's fault, pinned: on ``(1, 2, 2)`` its decode executable
    refuses the store its own previous call returned (ROADMAP)."""
    for arch in ENGINE_ARCHS:
        fault = _ref(jobs, arch, "1x2x2").get("fault")
        assert fault is not None and "shardings that disagree" in fault["error"]
        assert fault["at_step"] == 2


def test_layouts_the_reference_refuses_are_refused_at_prepare(jobs):
    """2 decode lanes, or a pool of 18 pages, over the 4-way (pod, data)
    split: PREPARE refuses the plan with the reference's reason (its jit
    refuses an uneven input), on every rank, and the engine stays on one
    device."""
    for out in jobs["ranks"]:
        r = _ok(out["refuse/minitron_4b/2x2x1"])
        assert "decode tokens: dim 0 of shape (2, 1) does not divide" in r["lanes"]
        assert "cache/" in r["pages"] and "does not divide" in r["pages"]
        assert r["lanes_layout"] and r["pages_layout"]
