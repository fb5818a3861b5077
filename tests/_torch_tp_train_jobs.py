"""The job `tests/test_torch_tp_train.py` runs on a 4-rank gloo mesh on the
CPU (`_torch_dist_jobs.run_job` with ``module="_torch_tp_train_jobs"``),
one spawned process per rank. Nothing here imports JAX.

  * ``step``: one `jit_train_step` of a reduced fp32 config from the weights
    the test module wrote, on ``(1, 2, 2)`` under `default_plan()` with
    ``sequence_parallel`` as the dry run's `plan_for_cell` sets it for a
    train cell (or forced off), or on ``(2, 2, 1)`` under
    `default_plan(multi_pod=True)`, beside the one-device port's step on
    the same batch: the loss and metrics, every parameter and moment put
    together (rank 0), the moments of the leaves the model axis replicates
    as each rank holds them, the tensor-parallel counts (`ctx.tp_counts`)
    and the sequence lengths the sharded step's norms saw (``norm_rows``);
  * ``step`` of ``odd_minitron_4b`` and ``odd_whisper_large_v3``: the
    configs cut to 3 heads (`_torch_tp_jobs.odd_config`), which do not
    divide the model axis of 2: attention runs on each rank's padded head
    slots, its leaves' gradients summed over the axis;
  * ``frames``: the ``step`` of Whisper on ``(1, 2, 2)`` with sequence
    parallelism, its encoder fed `ODD_FRAMES` frames, which do not divide
    the model axis: the encoder's residual stream stays whole while the
    decoder's is cut (each stack's `ctx.sp_on` verdict recorded);
  * ``ops``: each autograd collective of `sharding.ctx` (forward and
    backward) on the model axis of 2 against the same function on one
    device, and the wrong backward of each all-reduce beside it; the
    reference's SP layout (a norm on the piece, `ctx.sp_enter`), and a
    replicated branch read through `ctx.tp_once` against the same branch
    without it; a padded leaf's cut (`ctx.slot_cut`) and the sum of its
    gradient over the axis, against the cut backward.

To debug a part alone: ``DIST_JOB_TRACE=1`` prints each part as a rank
enters it, and ``TP_TRAIN_PARTS=step:minitron_4b:1x2x2:sp:1:fp32,ops`` picks
the parts.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from _torch_dist_jobs import LR, WD, _fp32, _full, _meshes, _part, _train_check
from _torch_tp_jobs import arch_config

TRAIN_ARCHS = ("minitron_4b", "qwen2_moe_a2_7b", "mamba2_370m", "jamba_v0_1_52b",
               "minicpm3_4b", "qwen2_vl_2b", "whisper_large_v3")
B, S = 8, 16

#: the configs cut to 3 heads (`_torch_tp_jobs.odd_config`) a case trains
#: as ``odd_<arch>``
ODD_TRAIN = ("minitron_4b", "whisper_large_v3")
#: (arch, mesh, sequence parallelism: "sp" as `plan_for_cell` sets it, "nosp"
#: forced off; accumulation steps; the gradients' reduce dtype)
CASES = ([(a, "1x2x2", "sp", 1, "fp32") for a in TRAIN_ARCHS]
         + [(a, "1x2x2", "sp", 2, "fp32") for a in ("minitron_4b", "qwen2_moe_a2_7b")]
         + [("minitron_4b", "1x2x2", "nosp", 1, "fp32")]
         + [(a, "2x2x1", "sp", 1, "fp32") for a in ("minitron_4b", "qwen2_moe_a2_7b",
                                                     "mamba2_370m")]
         + [("minitron_4b", "2x2x1", "sp", 2, "fp32"),
            ("minitron_4b", "1x2x2", "sp", 2, "bfloat16")]
         + [(f"odd_{a}", "1x2x2", "sp", 1, "fp32") for a in ODD_TRAIN])


#: the encoder frames of the ``frames`` part: odd, so that a model axis of 2
#: cannot cut them
ODD_FRAMES = 33


def case_name(case) -> str:
    return ":".join(str(c) for c in case)


def train_batch(cfg) -> dict:
    """The batch both packages train on: ``B`` rows of ``S + 1`` tokens
    (seeded), one target masked; Whisper's frames, an M-RoPE model's three
    position streams."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    tokens[1, 4] = 1
    out = {"tokens": tokens, "loss_mask": (tokens[:, 1:] != 1).astype(np.float32)}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.pos_type == "mrope":
        a = np.arange(S + 1)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([a, a // 2, a % 3])[:, None], (3, B, S + 1)).astype(np.int32))
    return out


def plan_of(cfg, mname: str, sp: str, plans: dict):
    """The case's plan: the mesh's default plan, with ``sequence_parallel``
    as `plan_for_cell` sets it for a train cell ("sp") or off ("nosp")."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.dryrun import plan_for_cell
    on = plan_for_cell(cfg, ShapeCell("t", "train", S, B), False).sequence_parallel
    return plans[mname].with_(sequence_parallel=on and sp == "sp")


def _parts():
    spec = os.environ.get("TP_TRAIN_PARTS")
    if spec:
        return [tuple(p.split(":")) for p in spec.split(",")]
    return ([("step",) + tuple(str(c) for c in case) for case in CASES]
            + [("frames",), ("ops",)])


def tp_train_job(rank: int, world: int) -> dict:
    meshes = _meshes()
    out: dict = {"rank": rank}
    for part in _parts():
        if part[0] == "step":
            _, arch, mname, sp, accum, dtype = part
            _part(out, ":".join(part[1:]), _step_part, arch, mname, sp, int(accum), dtype,
                  meshes)
        elif part[0] == "frames":
            _part(out, "frames", _frames_part, meshes)
        else:
            _part(out, "ops", _ops_part, *meshes["1x2x2"])
    return out


def _model(cfg, arch):
    import pickle

    from repro_torch import bridge
    from repro_torch.models import Model
    with open(os.path.join(os.environ["TP_TRAIN_WEIGHTS"], f"{arch}.pkl"), "rb") as f:
        return Model(cfg, bridge.params_from_numpy(cfg, pickle.load(f), device="cpu"),
                     device="cpu")


def _frames_part(meshes):
    """`_step_part` of Whisper fed `ODD_FRAMES` encoder frames (module
    notes), with each `ctx.sp_on` verdict of the sharded step's forward:
    ``(sequence length, on)``."""
    import dataclasses

    from repro_torch.sharding import ctx
    cfg = _fp32("whisper_large_v3")
    cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(cfg.encdec,
                                                              encoder_seq_len=ODD_FRAMES))
    seen, sp_on = [], ctx.sp_on

    def recorded(seq_len):
        on = sp_on(seq_len)
        if ctx.tp()[0] > 1:
            seen.append((seq_len, on))
        return on

    ctx.sp_on = recorded
    try:
        out = _step_part("whisper_large_v3", "1x2x2", "sp", 1, "fp32", meshes, cfg=cfg)
    finally:
        ctx.sp_on = sp_on
    out["sp_on"] = seen
    return out


def _step_part(arch, mname, sp, accum, dtype, meshes, cfg=None):
    """One sharded train step and one on one device, from the same weights
    and batch; see the module's notes. ``cfg``: ``arch``'s reduced fp32
    config by default."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.steps import jit_train_step, make_train_step, named
    from repro_torch.optim import AdamW
    from repro_torch.sharding import batch_specs, ctx, param_specs
    mesh, _ = meshes[mname]
    cfg = cfg or arch_config(arch)
    plan = plan_of(cfg, mname, sp, {m: p for m, (_, p) in meshes.items()})
    reduce_dtype = None if dtype == "fp32" else dtype
    opt = AdamW(lr=LR, weight_decay=WD)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    one = _model(cfg, arch)
    one_state = opt.init(one.params)
    _, _, one_loss, one_metrics = make_train_step(
        one, opt, accum_steps=accum, grad_reduce_dtype=reduce_dtype)(
        one.params, one_state, dict(batch))

    model = _model(cfg, arch)
    cell = ShapeCell("t", "train", S, B)
    params = ctx.place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    state = opt.init(params)
    step = jit_train_step(model, opt, mesh, plan, cell, accum_steps=accum,
                          grad_reduce_dtype=reduce_dtype)
    placed = ctx.place_tree(batch, named(mesh, batch_specs(cfg, plan, cell)))
    ctx.reset_tp_counts()
    with _norm_rows() as rows:
        params, state, loss, metrics = step(params, state, placed)
    counts = ctx.tp_counts()
    model_dim = mesh.axis_names.index("model")
    replicated = {name: ctx.local_shard(m).numpy().copy()
                  for name, m in tree_util.items(state["m"])
                  if isinstance(m.placements[model_dim], Replicate)}
    full = {key: {name: _full(x).numpy() for name, x in tree_util.items(tree)}
            for key, tree in (("params", params), ("m", state["m"]), ("v", state["v"]))}
    out = {
        "loss": float(_full(loss)), "one_loss": float(one_loss),
        "metrics": {k: float(_full(v)) for k, v in metrics.items()},
        "one_metrics": {k: float(v) for k, v in one_metrics.items()},
        "params_check": _train_check(params, one.params, moments=False),
        "m_check": _train_check(state["m"], one_state["m"], moments=True),
        "v_check": _train_check(state["v"], one_state["v"], moments=True),
        "m_bf16_excess": _bf16_excess(state, one_state) if reduce_dtype else None,
        "sequence_parallel": plan.sequence_parallel, "norm_rows": sorted(set(rows)),
        "counts": counts, "replicated_m": replicated}
    if dist.get_rank() == 0:
        out["trees"] = full
    return out


@contextlib.contextmanager
def _norm_rows():
    """The sequence length (dim 1) of every input a sub-layer's or a
    final norm sees in a tensor-parallel step inside the block (`lm._norm`
    and the serving path call `lm.apply_norm`; Whisper's stacks go through
    `lm._norm`), forward and recompute alike."""
    from repro_torch.models import lm
    from repro_torch.sharding import ctx
    rows, apply_norm = [], lm.apply_norm

    def recorded(cfg, p, x):
        if ctx.tp()[0] > 1:
            rows.append(x.shape[1])
        return apply_norm(cfg, p, x)

    lm.apply_norm = recorded
    try:
        yield rows
    finally:
        lm.apply_norm = apply_norm


#: a moment of a step whose gradients were reduced in bf16 is held within
#: this share of its leaf's largest value (m a gradient, v its square)
BF16_SHARE = {"m": 2.0 ** -6, "v": 2.0 ** -4}


def bf16_excess(got, want, share: float) -> float:
    """How far ``got`` lies outside ``share`` of ``want``'s largest
    magnitude (<= 0: within). Each element of a gradient reduced in bf16 is
    a sum of partials rounded apart, and a sum of partials of both signs
    has no relative bound of its own: the bound is the leaf's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() - share * np.abs(want).max())


def _bf16_excess(state, one_state) -> float:
    """`bf16_excess` of every moment leaf against the one-device step's,
    at its worst (<= 0: every leaf within `BF16_SHARE`)."""
    from repro_torch import tree as tree_util
    worst = -1.0
    for key, share in BF16_SHARE.items():
        for (_, g), (_, w) in zip(tree_util.items(state[key]), tree_util.items(one_state[key])):
            worst = max(worst, bf16_excess(_full(g).numpy(), w.numpy(), share))
    return worst


# ---------------------------------------------------------------------------
# the autograd collectives, one by one
# ---------------------------------------------------------------------------


def _weights(shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.linspace(-1.0, 2.0, n, dtype=torch.float64).reshape(shape)


def _grads(fn, *xs, w=None):
    """``fn(*xs)`` and the gradients of ``sum(fn(*xs) * w)`` (``w`` fixed
    weights of the output's shape by default)."""
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    y = fn(*xs)
    w = _weights(y.shape).to(y.dtype) if w is None else w.to(y.dtype)
    gs = torch.autograd.grad((y * w).sum(), xs)
    return y.detach(), [g.detach() for g in gs]


def _err(a, b) -> float:
    return float((a - b).detach().abs().max())


def _ops_part(mesh, plan):
    """Each autograd collective against the one-device function, on the
    model axis of 2 (ranks 2r and 2r + 1 share their batch rows): errors of
    the forward and of each input's gradient (put together over the axis
    where a rank holds a shard), and the errors of the wrong backward."""
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import P, leaf_sharding
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 8, 6), generator=g, dtype=torch.float64)
    w1 = torch.randn((6, 10), generator=g, dtype=torch.float64)
    w2 = torch.randn((10, 6), generator=g, dtype=torch.float64)
    z = torch.randn((2, 8, 10), generator=g, dtype=torch.float64)
    out = {}
    with ctx.activation_sharding(mesh, plan, tensor_parallel=True):
        n, r = ctx.tp()
        cols = slice(r * 5, r * 5 + 5)

        def piece(t, dim):
            w = t.shape[dim] // n
            return t.narrow(dim, r * w, w)

        # tp_enter / tp_reduce: a column-then-row split MLP
        def mlp_one(x, w1, w2):
            return torch.tanh(x @ w1) @ w2

        def mlp_tp(x, w1c, w2r, reduce=ctx.tp_reduce):
            return reduce(torch.tanh(ctx.tp_enter(x) @ w1c) @ w2r)

        y1, (gx1, gw11, gw21) = _grads(mlp_one, x, w1, w2)
        y2, (gx2, gw12, gw22) = _grads(mlp_tp, x, w1[:, cols], w2[cols])
        out["enter_reduce"] = [_err(y2, y1), _err(gx2, gx1),
                               _err(ctx.tp_gather(gw12, 1), gw11),
                               _err(ctx.tp_gather(gw22, 0), gw21)]
        # the residual sum with an all-reduce backward: n times the gradient
        _, (gx3, _, _) = _grads(lambda *a: mlp_tp(*a, reduce=ctx.tp_sum_shard),
                                x, w1[:, cols], w2[cols])
        out["reduce_wrong"] = _err(gx3, gx1)

        # tp_sum_shard: the gated norm's variance on each rank's channels
        def norm_one(y, z):
            yf = y * torch.nn.functional.silu(z)
            return yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-5)

        def norm_tp(y, z, total=ctx.tp_sum_shard):
            yf = y * torch.nn.functional.silu(z)
            var = total(yf.square().sum(dim=-1, keepdim=True)) / 10
            return yf * torch.rsqrt(var + 1e-5)

        y = torch.randn((2, 8, 10), generator=g, dtype=torch.float64)
        y1, (gy1, gz1) = _grads(norm_one, y, z)
        w = _weights((2, 8, 10))[..., cols]
        y2, (gy2, gz2) = _grads(norm_tp, y[..., cols], z[..., cols], w=w)
        out["sum_shard"] = [_err(ctx.tp_gather(y2, 2), y1), _err(ctx.tp_gather(gy2, 2), gy1),
                            _err(ctx.tp_gather(gz2, 2), gz1)]
        # the variance with an identity backward drops the other rank's part
        _, (gy3, _) = _grads(lambda *a: norm_tp(*a, total=ctx.tp_reduce),
                             y[..., cols], z[..., cols], w=w)
        out["sum_shard_wrong"] = _err(ctx.tp_gather(gy3, 2), gy1)

        # sp_cut / sp_gather / sp_scatter: a residual stream on sequence pieces
        def res_one(x, w1, w2):
            h = torch.nn.functional.layer_norm(x, (6,))
            return x + mlp_one(h, w1, w2)

        def res_sp(x, w1c, w2r):
            xp = ctx.sp_cut(x, 1)
            h = torch.nn.functional.layer_norm(ctx.sp_gather(xp, 1), (6,))
            xp = xp + ctx.sp_scatter(torch.tanh(ctx.tp_enter(h) @ w1c) @ w2r, 1)
            return ctx.sp_gather(xp, 1)

        y1, (gx1, gw11, gw21) = _grads(res_one, x, w1, w2)
        y2, (gx2, gw12, gw22) = _grads(res_sp, x, w1[:, cols], w2[cols])
        out["sp"] = [_err(y2, y1), _err(gx2, gx1), _err(ctx.tp_gather(gw12, 1), gw11),
                     _err(ctx.tp_gather(gw22, 0), gw21)]

        # the reference's SP layout: the norm on the piece (its gain
        # entering it), the normed piece gathered into the shards with a
        # reduce-scatter backward
        gain = torch.randn((6,), generator=g, dtype=torch.float64)

        def gain_one(x, w1, w2, gain):
            return x + mlp_one(torch.nn.functional.layer_norm(x, (6,), weight=gain), w1, w2)

        def gain_sp(x, w1c, w2r, gain):
            xp = ctx.sp_cut(x, 1)
            h = torch.nn.functional.layer_norm(xp, (6,), weight=ctx.tp_enter(gain))
            h = ctx.sp_enter(h, 1)
            xp = xp + ctx.sp_scatter(torch.tanh(h @ w1c) @ w2r, 1)
            return ctx.sp_gather(xp, 1)

        y1, (gx1, gw11, gw21, gg1) = _grads(gain_one, x, w1, w2, gain)
        y2, (gx2, gw12, gw22, gg2) = _grads(gain_sp, x, w1[:, cols], w2[cols], gain)
        out["sp_enter"] = [_err(y2, y1), _err(gx2, gx1), _err(ctx.tp_gather(gw12, 1), gw11),
                           _err(ctx.tp_gather(gw22, 0), gw21), _err(gg2, gg1)]
        out.update(_once_part(x, w1, w2, cols, g))

        # tp_max: the elementwise maximum over the axis, no gradient
        m = ctx.tp_max(piece(x, 2).amax(dim=-1))
        out["max"] = _err(m, x.amax(dim=-1))

    # gather_shard: a leaf sharded over data and model, rows split over
    # data; its gradient summed over the data ranks and cut, each way
    rows = x[:, 0, :]
    lo, hi = ctx.my_rows(mesh.device_mesh(), ("data",), 2)
    res = {}
    for shard_grads in (True, False):
        with ctx.activation_sharding(mesh, plan, row_axes=("data",), rows=2,
                                     tensor_parallel=True, shard_grads=shard_grads):
            sh = leaf_sharding(mesh, P("data", "model"))
            wp = ctx.place(w1, sh)
            local = ctx.local_shard(wp).detach().clone().requires_grad_(True)
            kept = ctx.gather_shard(local, ctx.gather_plan(wp, "model", stacked=False))
            yl = torch.tanh(rows[lo:hi] @ kept)
            gl, = torch.autograd.grad((yl * yl).sum(), [local])
        wv = w1.clone().requires_grad_(True)
        every = torch.tanh(rows @ wv)
        gw, = torch.autograd.grad((every * every).sum(), [wv])
        r0 = ctx.local_range(w1.shape, sh, dim=0)[0]
        c0 = ctx.local_range(w1.shape, sh, dim=1)[0]
        res[shard_grads] = [list(kept.shape), _err(kept, w1[:, c0:c0 + 5]),
                            _err(gl, gw[r0:r0 + 3, c0:c0 + 5])]
    out["gather_shard"] = res
    out["padded"] = _padded_part(mesh, plan)
    return out


def _once_part(x, w1, w2, cols, g):
    """A replicated branch inside a sub-layer whose normed input entered
    through `ctx.sp_enter`: ``k = h @ wr`` computed whole on every rank,
    entering the shard's product (`ctx.tp_enter`), each rank reading its
    columns. ``once``: errors of the forward and of each input's gradient
    against one device, the branch's input read through `ctx.tp_once`;
    ``once_wrong``: the input's gradient error with the branch read as it
    is (the reduce-scatter then sums its whole gradient from every rank);
    ``once_excess``: how far that wrong gradient's excess is from ``n - 1``
    times the branch's own part of the gradient (the gradient without the
    branch's path, ``h`` detached there, taken away)."""
    from repro_torch.sharding import ctx
    n, _ = ctx.tp()
    wr = torch.randn((6, 10), generator=g, dtype=torch.float64)

    def one(x, w1, w2, wr):
        h = torch.nn.functional.layer_norm(x, (6,))
        return x + torch.tanh(h @ w1 + h @ wr) @ w2

    def sp(x, w1c, w2r, wr, read=ctx.tp_once):
        xp = ctx.sp_cut(x, 1)
        h = ctx.sp_enter(torch.nn.functional.layer_norm(xp, (6,)), 1)
        k = ctx.tp_enter(read(h) @ wr)
        xp = xp + ctx.sp_scatter(torch.tanh(h @ w1c + k[..., cols]) @ w2r, 1)
        return ctx.sp_gather(xp, 1)

    y1, (gx1, gw11, gw21, gr1) = _grads(one, x, w1, w2, wr)
    y2, (gx2, gw12, gw22, gr2) = _grads(sp, x, w1[:, cols], w2[cols], wr)
    _, (gx3, _, _, _) = _grads(lambda *a: sp(*a, read=lambda t: t), x, w1[:, cols], w2[cols], wr)
    _, (gx4, _, _, _) = _grads(lambda *a: sp(*a, read=lambda t: t.detach()),
                               x, w1[:, cols], w2[cols], wr)
    return {"once": [_err(y2, y1), _err(gx2, gx1), _err(ctx.tp_gather(gw12, 1), gw11),
                     _err(ctx.tp_gather(gw22, 0), gw21), _err(gr2, gr1)],
            "once_wrong": _err(gx3, gx1),
            "once_excess": _err(gx3 - gx2, (n - 1) * (gx2 - gx4))}


def _padded_part(mesh, plan):
    """A padded head group's leaves on the model axis of 2: 3 heads of
    width 2, stored as the plan stores them (``wq`` columns and ``wo`` rows
    split 3 and 3 over the axis, 1.5 heads a rank), each gathered whole and
    cut to the rank's 2 head slots (`ctx.slot_cut`; rank 1's second slot
    padding), the rank's partial product summed over the axis. Errors of
    the forward and of ``wq``'s and ``wo``'s gradients (each rank's shard
    put together) against one device, with the gradient summed over the
    axis (``summed``) and with the gathered leaf's backward cut, as a
    replicated leaf's is."""
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import P, leaf_sharding
    g = torch.Generator().manual_seed(12)
    x = torch.randn((4, 5), generator=g, dtype=torch.float64)
    wq = torch.randn((5, 6), generator=g, dtype=torch.float64)
    wo = torch.randn((6, 5), generator=g, dtype=torch.float64)
    wq1, wo1 = wq.clone().requires_grad_(True), wo.clone().requires_grad_(True)
    y1 = torch.tanh(x @ wq1) @ wo1
    gq1, go1 = torch.autograd.grad((y1 * y1).sum(), [wq1, wo1])
    out = {}
    with ctx.activation_sharding(mesh, plan, tensor_parallel=True):
        for how in ("summed", "cut"):
            leaves = []
            for w, spec, dim in ((wq, P(None, "model"), 1), (wo, P("model", None), 0)):
                wp = ctx.place(w, leaf_sharding(mesh, spec))
                local = ctx.local_shard(wp).detach().clone().requires_grad_(True)
                plan_w = ctx.gather_plan(wp, None, stacked=False,
                                         summed="model" if how == "summed" else None)
                whole = ctx.gather_shard(local, plan_w)
                leaves.append((local, ctx.slot_cut(whole, ctx.SlotCut(dim, 2, 3))))
            (lq, q), (lo, o) = leaves
            y = ctx.tp_reduce(torch.tanh(ctx.tp_enter(x) @ q) @ o)
            gq, go = torch.autograd.grad((y * y).sum(), [lq, lo])
            out[how] = [_err(y, y1), _err(ctx.tp_gather(gq, 1), gq1),
                        _err(ctx.tp_gather(go, 0), go1)]
        out["slots"] = list(q.shape)
    return out
