"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's.

  * `applicable_cells`, `all_configs`, `plan_for_cell` (every arch x cell x
    mesh x profile, field by field) and the resolved accumulation equal the
    reference's;
  * `param_struct`, `batch_struct` and `decode_struct` equal the
    reference's `ShapeDtypeStruct`s leaf by leaf (shape and dtype) for all
    ten archs at full width, every applicable cell (the reference nests a
    hybrid or enc-dec cache, the port's is flat: its names are the
    reference's paths joined by ``/``);
  * at reduced size, in two processes of their own (the reference's
    `lower_cell` over 512 placeholder devices, ``XLA_FLAGS`` set before JAX
    starts; the port's fake world of 256 ranks on ``device="cpu"``): the
    status, the argument bytes, the model FLOPs and the parameter counts of
    five cells (`CELLS`; the last under the ``optimized`` profile, its KV
    cache in fp8). Reduced Mamba2-370m's ``train_4k`` fails on both sides,
    as its 8 SSM heads do not split over the model axis of 16;
  * on a 2 x 2 fake mesh, the collectives of one tensor-parallel layer
    against a reckoning by hand from the spec trees; reduced Minitron's
    ``decode_32k`` on the fake world with its tensor-parallel counts, its
    attention over each rank's piece of the cache's sequence;
    reduced Minitron's and Qwen1.5-MoE's train step, which never holds the
    whole parameter tree; the model-axis collectives of reduced Minitron's,
    Qwen1.5-MoE's and MiniCPM3's sequence-parallel train step against a
    reckoning by hand (the norms on the rank's piece, each normed piece
    gathered into the shards with a reduce-scatter backward).

The processes run at once, from one module fixture (~25 s).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import build_model as jax_build_model
from repro_torch import tree as tree_util
from repro_torch.configs import (
    ARCH_IDS,
    ShapeCell,
    all_configs,
    applicable_cells,
    get_config,
    get_reduced_config,
)
from repro_torch.launch import dryrun, steps
from repro_torch.models import Model, lm
from repro_torch.models.common import torch_dtype
from repro_torch.sharding.plan import default_plan, param_specs

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("minitron_4b:decode_32k", "qwen2_moe_a2_7b:prefill_32k", "minitron_4b:train_4k",
         "mamba2_370m:train_4k", "minitron_4b:decode_32k:optimized")
JOB_TIMEOUT_S = 240


def _spawn(side):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dryrun_jobs.py"), side,
                             ",".join(CELLS)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))


@pytest.fixture(scope="module")
def jobs():
    procs = {side: _spawn(side) for side in ("reference", "port", "mesh2x2", "train2x2")}
    out = {}
    for side, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=JOB_TIMEOUT_S)
        finally:
            p.kill()
        assert p.returncode == 0, f"{side} job failed:\n{stderr[-3000:]}"
        out[side] = json.loads(stdout.strip().splitlines()[-1])
    return out


# ---------------------------------------------------------------------------
# configs, cells, plans, accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_cells_and_configs_match_reference(arch):
    ref = jconfigs.all_configs()[arch]
    port = all_configs()[arch]
    assert set(all_configs()) == set(jconfigs.all_configs())
    assert port.name == ref.name and port.param_count() == ref.param_count()
    assert [c.name for c in applicable_cells(port)] == [c.name for c in
                                                       jconfigs.applicable_cells(ref)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_and_accumulation_match_reference(jobs, arch):
    ref = jobs["reference"]
    assert dryrun.TRAIN_ACCUM == ref["train_accum"]
    assert [c.name for c in applicable_cells(get_config(arch))] == ref["cells"][arch]
    cfg = get_config(arch)
    for cell in applicable_cells(cfg):
        for mp in (False, True):
            for profile in sorted(dryrun.PROFILES):
                want = ref["plans"][f"{arch}:{cell.name}:{int(mp)}:{profile}"]
                plan = dryrun.plan_for_cell(cfg, cell, mp, None, profile)
                got = json.loads(json.dumps(dataclasses.asdict(plan)))
                assert got == want["plan"], (cell.name, mp, profile)
                n = 512 if mp else 256
                assert dryrun.resolve_accum(cfg, cell, plan, n) == want["accum"]


# ---------------------------------------------------------------------------
# the stand-ins at full width
# ---------------------------------------------------------------------------


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _port_leaves(tree):
    return {name: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for name, x in tree_util.items(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_structs_match_reference_at_full_width(arch):
    jcfg, cfg = jconfigs.get_config(arch), get_config(arch)
    jmodel, model = jax_build_model(jcfg), Model(cfg, device="meta")
    for cell in applicable_cells(cfg):
        jcell = jconfigs.get_shape_cell(cell.name)
        params = steps.param_struct(model, cell)
        assert all(p.is_meta for p in tree_util.leaves(params))
        assert _port_leaves(params) == _ref_leaves(jsteps.param_struct(jmodel, jcell)), cell
        assert (_port_leaves(steps.batch_struct(cfg, cell))
                == _ref_leaves(jsteps.batch_struct(jcfg, jcell))), cell
        if cell.kind == "decode":
            tokens, cache, pos = steps.decode_struct(model, cell, torch_dtype("bfloat16"))
            jt, jc, jp = jsteps.decode_struct(jmodel, jcell)
            assert _port_leaves({"t": tokens, "p": pos}) == _ref_leaves({"t": jt, "p": jp})
            assert _port_leaves(cache) == _ref_leaves(jc), cell


# ---------------------------------------------------------------------------
# reduced cells against the reference's compiled ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_reduced_cell_matches_reference(jobs, cell):
    ref, port = jobs["reference"]["records"][cell], jobs["port"]["records"][cell]
    assert port["status"] == ref["status"], (port.get("error"), ref.get("error"))
    if ref["status"] == "error":
        # both refuse a split that does not divide (the reference names its
        # first such leaf, the port its own)
        assert "divisible" in ref["error"] and "does not divide" in port["error"]
        return
    # XLA counts each argument leaf's local shard once; so does the port
    assert port["argument_bytes"] == ref["argument_bytes"]
    assert port["model_flops"] == ref["model_flops"]
    assert port["params"] == ref["params"]
    assert port["accum_steps"] == ref["accum_steps"]


def test_reduced_prefill_runs_the_kernels_as_fake_ops(jobs):
    cfg = get_reduced_config("qwen2_moe_a2_7b")
    rec = jobs["port"]["records"]["qwen2_moe_a2_7b:prefill_32k"]
    assert rec["kernel_calls"] == {"flash_attention": cfg.num_layers,
                                   "moe_topk": cfg.num_layers}


# ---------------------------------------------------------------------------
# collectives on a 2 x 2 fake mesh, by hand
# ---------------------------------------------------------------------------


def test_collectives_of_one_gathered_layer_on_2x2(jobs):
    """The tensor-parallel prefill of one layer (B = 2, S = 8) by hand.
    Each parameter leaf that shards over ``data`` is gathered over it once,
    its result the leaf's ``model`` shard (every model-axis dim of reduced
    Minitron divides 2, so none is gathered over ``model``). Over ``model``:
    an all-gather of the new K and of the new V heads (the cache keeps every
    head), and an all-reduce at the embedding's masked lookup and at each
    sub-layer's residual add (attention, MLP) of a rank's ``(1, 8, d)``
    rows. A ring of two moves half an all-gather's result and an
    all-reduce's operand once."""
    cfg = dataclasses.replace(get_reduced_config("minitron_4b"), num_layers=1)
    specs = dict(tree_util.items(param_specs(cfg, default_plan())))
    layout = dict(tree_util.items(lm.map_layout(lambda _, leaf: leaf, lm.param_layout(cfg))))
    count = {"data": 0, "model": 0}
    wire = {"data": 0.0, "model": 0.0}
    kinds = {"all-gather": 0, "all-reduce": 0}
    for name, leaf in layout.items():
        nbytes = leaf.dtype.itemsize
        for n in leaf.shape:
            nbytes *= n
        axes = {a for d in range(len(specs[name])) for a in specs[name].axes(d)}
        if "data" in axes:
            count["data"] += 1
            kinds["all-gather"] += 1
            wire["data"] += nbytes / (2 if "model" in axes else 1) / 2
    act = torch_dtype(cfg.activ_dtype).itemsize
    kv = 1 * 8 * (cfg.num_kv_heads // 2) * cfg.resolved_head_dim * act    # a rank's heads
    rows = 1 * 8 * cfg.d_model * act
    count["model"] += 2 + 3
    kinds["all-gather"] += 2
    kinds["all-reduce"] += 3
    wire["model"] += 2 * kv + 3 * rows
    got = jobs["mesh2x2"]
    per_axis = {a: sum(1 for c in got["collectives"] if c["axis"] == a) for a in count}
    assert per_axis == count
    assert got["summary"]["collectives"]["by_kind"] == kinds
    assert got["summary"]["collectives"]["wire_bytes_by_axis"] == wire
    assert got["tp"] == {"vocab:local": 1, "attn:local": 1, "attn_kv:local": 1,
                         "mlp:local": 1, "tp_local": 4}


def test_reduced_decode_tensor_parallel_on_the_fake_world(jobs):
    """Reduced Minitron-4B's ``decode_32k`` on the fake 16 x 16 world: its
    4 q heads (and 2 K/V heads) do not divide the model axis of 16, so its
    attention runs padded (16 head slots, one a rank, ranks 4-15 padding
    alone), counted so; the MLP's 192 columns and the vocab's 256 run on
    their shards. The plan shards the cache's sequence
    over the model axis, and each rank attends over its own 2,048 of the
    32,768 positions (``attn:seq_local``): FLOPs a rank within 2x of the
    reference's partitioned step's (the gathered sequence counted 18.8x),
    and a peak below the arguments plus one more rank's piece of the cache
    (the gathered sequence peaked at 138.4 MB). The fp8 cache of the
    ``optimized`` profile takes the same step."""
    cfg = get_reduced_config("minitron_4b")
    L = cfg.num_layers
    ref = jobs["reference"]["records"]["minitron_4b:decode_32k"]
    for cell in ("minitron_4b:decode_32k", "minitron_4b:decode_32k:optimized"):
        rec = jobs["port"]["records"][cell]
        assert rec["tp"] == {"vocab:local": 1, "attn:padded": L, "attn_kv:padded": L,
                             "mlp:local": L, "tp_local": 1 + L, "tp_padded": 2 * L,
                             "attn:seq_local": L}
        assert rec["flops"] <= 2 * ref["flops"]
    rec = jobs["port"]["records"]["minitron_4b:decode_32k"]
    rows = 128 // 16                                        # over the data axis
    piece = 2 * L * rows * (32_768 // 16) * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    assert rec["peak_bytes"] < rec["argument_bytes"] + piece
    # the all-reduces of the softmax cross the model axis, which cuts the sequence
    assert rec["by_kind"]["all-reduce"] >= 2 * L
    assert rec["wire_bytes_by_axis"]["model"] > 0


@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b"])
def test_train_step_never_gathers_the_whole_tree(jobs, arch):
    """Reduced Minitron-4B's and Qwen1.5-MoE's train step (B = 2, S = 16,
    sequence-parallel as `plan_for_cell` sets it) on a 2 x 2 fake mesh: the
    live bytes rank 0's step adds to its arguments peak below one whole copy
    of the parameter tree (a step that gathered the tree would hold that
    copy, and its gradients, at once), every all-gather's result is at most
    one layer and at most the largest leaf of one layer (or outside the
    layers), and the layers ran on their model-axis shards."""
    r = jobs["train2x2"][arch]
    assert r["sequence_parallel"]
    assert r["peak_bytes"] - r["argument_bytes"] < r["whole_tree"]
    assert r["all_gathers"] and max(r["all_gathers"]) <= r["one_layer"]
    assert max(r["all_gathers"]) <= max(r["largest_layer_leaf"], r["largest_other"])
    assert r["tp"]["tp_local"] > 0 and "tp_gathered" not in r["tp"]


def _sp_train_model_axis(cfg) -> dict:
    """The model-axis collectives of reduced ``cfg``'s train step on the
    2 x 2 fake mesh (B = 2, S = 16: one row a rank; sequence-parallel, every
    group and the vocab on its shard), by hand: ``{kind: [(operand bytes,
    count)]}``. ``A``, a rank's ``(1, 16, d)`` activation; the layers run
    under `torch.utils.checkpoint`, whose recompute stops at the last
    tensor the backward needs (a layer's last residual sum is not
    recomputed).

      * all-gather of ``A / 2`` (the piece) into ``A``: each sub-layer's
        entry (`ctx.sp_enter`, or MLA's `ctx.sp_gather`) in the forward and
        the recompute, the LM head's entry once; the backward of each
        sub-layer's exit (`ctx.sp_scatter`) and of the embedding's;
      * reduce-scatter of ``A``: the embedding's masked lookup, each exit
        in the forward, the mixer's exit again in the recompute; the
        backward of each `ctx.sp_enter` (the attention and the MLP or the
        MoE, not MLA) and of the head's;
      * all-reduce, never of an activation: each norm leaf's gradient (the
        norm runs on the piece, `ctx.tp_enter` of its params), the loss's
        three ``(1, 16)`` fp32 sums, the MoE's routing weights entering the
        experts, MLA's query latent and ``ckv`` / ``kpe`` entering the
        heads, and AdamW's sums of squares (one fp32 a model-sharded leaf,
        a vector for each set of mesh axes that shards them)."""
    from repro_torch.models.common import norm_shapes
    L, d, S = cfg.num_layers, cfg.d_model, 16
    a = torch_dtype(cfg.activ_dtype).itemsize
    pb = torch_dtype(cfg.param_dtype).itemsize
    A = S * d * a
    mla = cfg.attn_type == "mla"
    enters = 1 if mla else 2                    # the sub-layers a layer enters by `sp_enter`
    gathers = (2 * L + 1) + 2 * L + 2 * L + 1
    scatters = 1 + 2 * L + L + enters * L + 1
    reduces = [(d * pb, len(norm_shapes(cfg, d)) * (2 * L + 1)), (S * 4, 3)]
    if cfg.moe is not None:
        from repro_torch.models.mlp import padded_experts
        reduces.append((S * padded_experts(cfg.moe.num_experts) * 4, L))
    if mla:
        m = cfg.mla
        reduces += [(S * r * a, L) for r in (m.q_lora_rank, m.kv_lora_rank, m.qk_rope_head_dim)]
    plan = dryrun.plan_for_cell(cfg, ShapeCell("train_16", "train", 16, 2), False)
    sets: dict = {}
    for _, spec in tree_util.items(param_specs(cfg, plan)):
        axes = frozenset(x for dim in range(len(spec)) for x in spec.axes(dim))
        if axes:
            sets[axes] = sets.get(axes, 0) + 1
    reduces += [(4 * k, 1) for axes, k in sets.items() if "model" in axes]
    return {"all-gather": [(A // 2, gathers)], "reduce-scatter": [(A, scatters)],
            "all-reduce": reduces}, A


@pytest.mark.parametrize("arch", ["minitron_4b", "qwen2_moe_a2_7b", "minicpm3_4b"])
def test_sp_train_step_reduce_scatters_the_normed_input(jobs, arch):
    """The sequence-parallel train step of reduced Minitron-4B (GQA),
    Qwen1.5-MoE (experts and shared expert on their shards) and MiniCPM3
    (MLA) on the 2 x 2 fake mesh, laid out as the reference lays it out:
    no model-axis all-reduce is as large as a rank's ``(rows, S, d)``
    activation or its gradient (the normed input enters the shards by an
    all-gather whose backward is a reduce-scatter, the embedding's sum is a
    reduce-scatter), and the model-axis collectives, their count, bytes and
    wire bytes, are the reckoning by hand (`_sp_train_model_axis`)."""
    cfg = get_reduced_config(arch)
    r = jobs["train2x2"][arch]
    want, A = _sp_train_model_axis(cfg)
    got: dict = {}
    for c in r["model"]:
        got.setdefault(c["kind"], {}).setdefault(c["operand_bytes"], 0)
        got[c["kind"]][c["operand_bytes"]] += 1
    assert all(c["operand_bytes"] < A for c in r["model"] if c["kind"] == "all-reduce")
    tally: dict = {}
    for kind, terms in want.items():
        for nbytes, count in terms:
            tally.setdefault(kind, {}).setdefault(nbytes, 0)
            tally[kind][nbytes] += count
    assert got == tally
    # a ring of two: an all-reduce moves its operand once, an all-gather
    # half its result (its operand), a reduce-scatter half its operand
    wire = sum(count * (nbytes / 2 if kind == "reduce-scatter" else nbytes)
               for kind, terms in want.items() for nbytes, count in terms)
    assert r["wire_model"] == wire
