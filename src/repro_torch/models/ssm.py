"""Mamba2 (SSD, state-space duality) block.

Prefill runs the chunked SSD scan through `kernels.ops.ssd_scan` (the Hopper
kernel on the card, its plain version on the CPU); training runs the plain
`ssd_scan_ref` (the kernel has no backward, as in the reference); decode
runs the O(1) recurrent update `ssd_step_ref` in plain ops, as the reference
does (it has no decode kernel).

Projections are split (w_z / w_x / w_B / w_C / w_dt), as in the reference.
State per layer:
  {"conv_x": (B, K-1, d_in), "conv_B": (B, K-1, G*N), "conv_C": (B, K-1, G*N),
   "ssm": (B, H, P, N) fp32}

In a tensor-parallel step (`sharding.ctx.tp`), a block whose
``w_z``/``w_x``/``w_dt`` columns, per-head vectors and ``out_proj`` rows
are this rank's head shard (`lm.tp_groups`; read off ``w_dt``'s width)
runs the scan (or the recurrent step) on those heads alone, over its own
``conv_x`` channels and ``ssm`` heads of the state, and returns its
partial output projection. B and C stay whole (one group), and the gated
norm's mean of squares is taken over the whole ``d_inner``: summed over
the tensor axis and divided by the global width.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import heads_of_groups, ssd_scan_ref
from repro_torch.models.common import gated_rmsnorm
from repro_torch.sharding import ctx

State = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_dim, d_state, conv_dim)."""
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, s.head_dim, s.d_state, conv_dim


def ssm_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], object, Optional[torch.dtype]]]:
    """Per-layer ``{name: (shape, init, dtype)}`` in the reference's key
    order (``init_ssm``). ``init`` is a std, ``None`` for the fan-in rule,
    or "zeros" / "ones" / "a_log" (``log(linspace(1, 16, H))``); ``dtype``
    None is the parameter dtype, and ``dt_bias``, ``A_log`` and ``D`` are
    fp32 whatever it is."""
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in, H, _, N, _ = ssm_dims(cfg)
    gn = s.n_groups * N
    f32 = torch.float32
    conv_std = s.d_conv ** -0.5
    return {
        "w_z": ((d, d_in), None, None),
        "w_x": ((d, d_in), None, None),
        "w_B": ((d, gn), None, None),
        "w_C": ((d, gn), None, None),
        "w_dt": ((d, H), None, None),
        "conv_x_w": ((s.d_conv, d_in), conv_std, None),
        "conv_x_b": ((d_in,), "zeros", None),
        "conv_B_w": ((s.d_conv, gn), conv_std, None),
        "conv_B_b": ((gn,), "zeros", None),
        "conv_C_w": ((s.d_conv, gn), conv_std, None),
        "conv_C_b": ((gn,), "zeros", None),
        "dt_bias": ((H,), "zeros", f32),
        "A_log": ((H,), "a_log", f32),
        "D": ((H,), "ones", f32),
        "norm_scale": ((d_in,), "ones", None),
        "out_proj": ((d_in, d), d_in ** -0.5, None),
    }


def a_log_init(H: int, *, device: torch.device) -> torch.Tensor:
    """``A_log = log(linspace(1, 16, H))`` fp32: A = -exp(A_log) spans
    [-16, -1] across the heads."""
    return torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# the recurrent step (decode)
# ---------------------------------------------------------------------------


def ssd_step_ref(
    x: torch.Tensor,        # (B, H, P)
    dt: torch.Tensor,       # (B, H)
    A: torch.Tensor,        # (H,)
    B_vec: torch.Tensor,    # (B, G, N)
    C_vec: torch.Tensor,    # (B, G, N)
    h: torch.Tensor,        # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step -> (y ``(B, H, P)`` in x's dtype, new state)."""
    rep = x.shape[1] // B_vec.shape[1]
    Bh = heads_of_groups(B_vec, rep).float()                  # (B, H, N)
    Ch = heads_of_groups(C_vec, rep).float()
    dtf = dt.float()
    dA = torch.exp(dtf * A)                                   # (B, H)
    h_new = h * dA[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dtf, x.float(), Bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv + silu. seq ``(B, S, C)``, w ``(K, C)``,
    history ``(B, K-1, C)`` (zeros when None), cast to seq's dtype."""
    K = w.shape[0]
    if history is None:
        pad = torch.zeros((seq.shape[0], K - 1, seq.shape[2]), dtype=seq.dtype,
                          device=seq.device)
    else:
        pad = history.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)                       # (B, S+K-1, C)
    S = seq.shape[1]
    out = sum(full[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(out + b[None, None, :])


def _conv_history(seq: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 raw inputs (before the conv), zero-filled in front of a
    shorter sequence: the decode conv state."""
    B, S, C = seq.shape
    if S >= K - 1:
        return seq[:, S - (K - 1):, :]
    zero = torch.zeros((B, K - 1 - S, C), dtype=seq.dtype, device=seq.device)
    return torch.cat([zero, seq], dim=1)


def ssm_block(
    cfg: ModelConfig,
    p: dict,
    xin: torch.Tensor,                  # (B, S, d)
    *,
    mode: str = "prefill",              # train | prefill | decode
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Returns (out ``(B, S, d)``, state). Train mode starts from a zero
    state and returns none. Prefill starts from a zero state and returns the
    new one (conv histories in the activation dtype, ``ssm`` fp32). Decode (S == 1) reads ``state`` and updates its leaves IN PLACE
    (the conv histories keep their own dtype, bf16 in a serving cache, as
    the reference's casts do), and returns it."""
    s = cfg.ssm or SSMConfig()
    Bb, S, _ = xin.shape
    d_full, H_full, P, N, _ = ssm_dims(cfg)
    G, K = s.n_groups, s.d_conv
    H = p["w_dt"].shape[-1]         # this rank's heads: all, or its shard
    d_in = H * P
    # the replicated input enters the heads' shard (`ctx.tp_enter`); B and C
    # are computed whole, on every rank alike
    xs = ctx.tp_enter(xin) if H < H_full else xin

    z = xs @ p["w_z"]
    x_raw = xs @ p["w_x"]
    B_raw = xin @ p["w_B"]
    C_raw = xin @ p["w_C"]
    dt_raw = xs @ p["w_dt"]                                   # (B, S, H)

    raws = {"conv_x": x_raw, "conv_B": B_raw, "conv_C": C_raw}
    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode needs a state and one token per row")
        acts = {k: _causal_conv(r, p[f"{k}_w"], p[f"{k}_b"], state[k])
                for k, r in raws.items()}
        for k, r in raws.items():                             # shift in the new column
            hist = state[k]
            hist[:, :-1] = hist[:, 1:].clone()
            hist[:, -1] = r[:, 0].to(hist.dtype)
    elif mode in ("train", "prefill"):
        acts = {k: _causal_conv(r, p[f"{k}_w"], p[f"{k}_b"]) for k, r in raws.items()}
    else:
        raise ValueError(f"unknown mode {mode!r} (train | prefill | decode)")

    x = acts["conv_x"].reshape(Bb, S, H, P)
    B_mat = acts["conv_B"].reshape(Bb, S, G, N)
    C_mat = acts["conv_C"].reshape(Bb, S, G, N)
    if H < H_full:                  # the whole B and C enter the heads' shard
        B_mat, C_mat = ctx.tp_enter(B_mat), ctx.tp_enter(C_mat)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                # (H,) negative

    if mode == "decode":
        y_core, h_new = ssd_step_ref(x[:, 0], dt[:, 0], A, B_mat[:, 0], C_mat[:, 0],
                                     state["ssm"])
        y_core = y_core[:, None]                              # (B, 1, H, P)
        state["ssm"].copy_(h_new)
        new_state = state
    elif mode == "train":
        y_core, _ = ssd_scan_ref(x, dt, A, B_mat, C_mat, chunk=s.chunk_size)
        new_state = None
    else:
        y_core, h_new = kops.ssd_scan(x, dt, A, B_mat, C_mat, chunk=s.chunk_size)
        new_state = {k: _conv_history(r, K) for k, r in raws.items()}
        new_state["ssm"] = h_new

    y = y_core + x * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(Bb, S, d_in).to(xin.dtype)
    if H == H_full:
        y = gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    else:
        y = gated_rmsnorm_shard(y, z, p["norm_scale"], cfg.norm_eps, d_full)
    return y @ p["out_proj"], new_state


def gated_rmsnorm_shard(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float,
                        width: int) -> torch.Tensor:
    """`gated_rmsnorm` of a row whose ``width`` channels are split over the
    tensor axis, on this rank's channels: the mean of squares is the sum
    over every rank's channels over ``width``, as one device takes it over
    the whole row. TRAP, two backwards for one all-reduce: each rank divides
    its own channels by that sum, so its gradient is summed over the axis
    too (`ctx.tp_sum_shard`)."""
    xf = x.float() * F.silu(z.float())
    var = ctx.tp_sum_shard(xf.square().sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def state_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one layer's decode state leaves."""
    s = cfg.ssm or SSMConfig()
    d_in, H, P, N, _ = ssm_dims(cfg)
    gn = s.n_groups * N
    return {"conv_x": (batch, s.d_conv - 1, d_in),
            "conv_B": (batch, s.d_conv - 1, gn),
            "conv_C": (batch, s.d_conv - 1, gn),
            "ssm": (batch, H, P, N)}


def state_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """A state leaf's dtype in a cache of ``dtype``: the recurrent ``ssm``
    state is always fp32, the conv histories take the cache's dtype."""
    return torch.float32 if name == "ssm" else dtype


def init_ssm_state(cfg: ModelConfig, batch: int, *, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device) -> State:
    """Zeroed decode state of one layer: conv histories in ``dtype`` (bf16
    by default, as in the reference), ``ssm`` fp32."""
    return {k: torch.zeros(shape, dtype=state_dtype(k, dtype), device=device)
            for k, shape in state_shapes(cfg, batch).items()}
