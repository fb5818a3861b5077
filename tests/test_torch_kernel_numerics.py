"""The rounding of the port's bf16 tensor-core kernels, modelled in plain
torch on the CPU and held against the Pallas kernels.

`csrc/flash_attention.cu` and `csrc/ssd_scan.cu` run their bf16 products on
`mma.sync` (bf16 operands, fp32 accumulators, one 16-deep k-step at a time).
Where the Pallas body keeps an operand in fp32 (flash's softmax weights P,
the SSD scan's dt·x, scores and state), the kernels split it into
hi = bf16(v) and lo = bf16(v - hi) and issue one product per pair of parts.
The models below round exactly there and follow the kernels' order of
operations as far as it changes a rounding: flash's two warp groups, each
with its own online softmax over alternate 64-row k tiles, merged at the
end, and its hi and lo PV products into one accumulator k-step by k-step;
the SSD scan's 128-row tiles, with one accumulator per split product
(hi·hi, lo·hi, hi·lo for y; hi and lo for C hᵀ and for each column tile's
state update) summed only at the end, as the kernel sums them. What they do
not model is the order of the 16 products inside one `mma.sync`, which the
hardware fixes: each k-step here is one fp32 matmul. Nothing ties the
models to the CUDA sources mechanically; a change of either kernel's
tiling, split or summation order has to be made here too.

They are held against the Pallas kernels (`repro.kernels.ops`, interpret
mode, as `tests/test_kernels.py` runs them) at the bf16 tolerances of
``chip_smoke.py``: flash atol = rtol = 2e-2 (the output rounds to bf16); the
SSD scan y at 2e-2 and its fp32 final state at 1e-3. Against a float64
evaluation of the same bf16 inputs, each split keeps the kernel's own error
far inside those: the tests below state by how much, and that the
alternative the kernel does not use (one bf16 P; TF32 products) would lose
more than 10x as much.

`csrc/moe_topk.cu` has no bf16 products; its model (last section) follows
what decides its ids and the last bits of its weights: which lane holds
which experts, the order of the partial max and exp-sums (each lane's
pairwise tree, then the butterfly across lanes), each lane's best key and
the merge of the lanes' bests, with either merge the kernel can be built
with. It is held to the Pallas kernel exactly in the ids and within 1e-6
in the weights, the tolerance of ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

FLASH_TOL = 2e-2                  # chip_smoke.FLASH_TOL["bfloat16"]
SSD_TOL_Y, SSD_TOL_H = 2e-2, 1e-3  # chip_smoke.SSD_TOL["bfloat16"]
K_STEP = 16                       # depth of one mma.sync m16n8k16
FLASH_K_TILE = 64                 # MBK in flash_attention.cu
FLASH_GROUPS = 2                  # KSPLIT: warp groups walking alternate k tiles
SSD_TILE = 128                    # ST in ssd_scan.cu: row and column tiles


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to fp32."""
    return t.bfloat16().float()


def split(t: torch.Tensor):
    """fp32 -> (hi, lo), both bf16 values: hi = bf16(t), lo = bf16(t - hi)."""
    hi = bf16(t)
    return hi, bf16(t - hi)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32's 10-bit mantissa (to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mma(a: torch.Tensor, b: torch.Tensor, acc=0) -> torch.Tensor:
    """acc + a (..., M, K) @ b (..., K, N) of bf16 values, added into the
    fp32 accumulator one 16-deep k-step at a time, as `mma.sync` does."""
    for k0 in range(0, a.shape[-1], K_STEP):
        acc = acc + a[..., k0:k0 + K_STEP] @ b[..., k0:k0 + K_STEP, :]
    return acc


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_model(q, k, v, *, causal: bool, p_parts: int = 2):
    """The bf16 kernel's arithmetic: q, k, v (B, S, H, D) of bf16 values in
    fp32 -> fp32 output before its rounding to bf16. Warp group g walks the
    64-row k tiles g, g + 2, ... with its own (m, l, acc): QKᵀ on bf16
    operands, the scale on the fp32 logits, the online softmax, then PV
    with P as hi + lo (``p_parts`` = 2: the hi and the lo product of each
    16-deep k-step go into one accumulator in turn) or as one bf16 (1). A
    tile wholly above a row (causal) is skipped for it, as the kernel skips
    it for the warp. The groups merge as m = max(m_g), l = sum l_g e^(m_g -
    m), acc likewise, and the output is acc times 1 / max(l, 1e-30)."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    qh = q.permute(0, 2, 1, 3)                                  # (B, Hq, S, D)
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    q_pos = torch.arange(S)[:, None]
    groups = []
    for grp in range(FLASH_GROUPS):
        m = torch.full((B, Hq, S, 1), -1e30)
        l = torch.zeros((B, Hq, S, 1))
        acc = torch.zeros((B, Hq, S, D))
        for k0 in range(grp * FLASH_K_TILE, S, FLASH_GROUPS * FLASH_K_TILE):
            kt, vt = kh[:, :, k0:k0 + FLASH_K_TILE], vh[:, :, k0:k0 + FLASH_K_TILE]
            s = mma(qh, kt.transpose(-1, -2)) * D ** -0.5
            k_pos = k0 + torch.arange(kt.shape[2])[None, :]
            ok = k_pos < S
            if causal:
                ok = ok & (k_pos <= q_pos)
            s = torch.where(ok, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            acc_new = acc * corr
            if p_parts == 1:
                acc_new = mma(bf16(p), vt, acc_new)
            else:
                ph, pl = split(p)
                for c0 in range(0, p.shape[-1], K_STEP):
                    for part in (ph, pl):
                        acc_new = acc_new + part[..., c0:c0 + K_STEP] @ vt[..., c0:c0 + K_STEP, :]
            takes = (q_pos >= k0) if causal else torch.ones(S, 1, dtype=torch.bool)
            m = torch.where(takes, m_new, m)
            l = torch.where(takes, l * corr + p.sum(-1, keepdim=True), l)
            acc = torch.where(takes, acc_new, acc)
        groups.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = groups
    mm = torch.maximum(m0, m1)
    c0, c1 = torch.exp(m0 - mm), torch.exp(m1 - mm)
    l = l0 * c0 + l1 * c1
    acc = a0 * c0 + a1 * c1
    return (acc * (1.0 / torch.clamp_min(l, 1e-30))).permute(0, 2, 1, 3)


def exact_attention(q, k, v, *, causal: bool):
    """float64 attention of the same inputs: the yardstick of rounding."""
    G = q.shape[2] // k.shape[2]
    qd, kd, vd = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    kd, vd = kd.repeat_interleave(G, dim=1), vd.repeat_interleave(G, dim=1)
    s = qd @ kd.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    return (torch.softmax(s, -1) @ vd).permute(0, 2, 1, 3)


def _bf16_inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [bf16(torch.as_tensor(rng.standard_normal(s).astype(np.float32))) for s in shapes]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("shape", [(1, 77, 4, 2, 32), (2, 130, 2, 2, 64), (1, 17, 2, 1, 16)],
                         ids=["gqa_s77_d32", "s130_d64", "s17_d16"])
def test_flash_model_matches_pallas_kernel(shape, causal):
    """The model of the bf16 kernel, output rounded to bf16, against the
    Pallas kernel on the same bf16 inputs: atol = rtol = 2e-2."""
    B, S, Hq, Hkv, D = shape
    q, k, v = _bf16_inputs([(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)], seed=S + D)
    gold = jops.flash_attention(*(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v)),
                                causal=causal, q_block=64, k_block=64)
    out = bf16(flash_model(q, k, v, causal=causal))
    np.testing.assert_allclose(out.numpy(), np.asarray(gold, np.float32),
                               atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_flash_p_split_error(causal):
    """Before the output's rounding, P as hi + lo stays within 2e-5 of the
    float64 result (fp32 sums and ~2^-16 of P); one bf16 P moves it ~2^-9
    relative per weight, an order of magnitude more."""
    q, k, v = _bf16_inputs([(1, 200, 2, 64), (1, 200, 2, 64), (1, 200, 2, 64)], seed=7)
    exact = exact_attention(q, k, v, causal=causal)
    err_split = (flash_model(q, k, v, causal=causal).double() - exact).abs().max().item()
    err_one = (flash_model(q, k, v, causal=causal, p_parts=1).double() - exact).abs().max().item()
    assert err_split < 2e-5
    assert err_one > 10 * err_split


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def ssd_model(x, dt, A, Bm, Cm, *, chunk: int, rounding: str = "split"):
    """The bf16 kernel's arithmetic: x, B, C (bf16 values in fp32), dt, A
    fp32 -> (y fp32 before its rounding to bf16, final state fp32). Per
    chunk, per 128-row tile i, over the column tiles j <= i: the scores
    C_i B_jᵀ exact on bf16 operands, times the decay; y_i's three split
    products hi·hi, lo·hi and hi·lo of S_ij (dt x)_j, each in its own
    accumulator across the tiles j; then y_i = (yhh + ylh + yhl) + exp(cum_i)
    (C_i hhᵀ + C_i hlᵀ) from the state's hi/lo parts. The state decays by
    exp(cum_last), and each column tile j adds its two products (dt x
    decay)ᵀ B_j, hi and lo, summed before they are added. ``rounding`` =
    "tf32" models TF32 products for the three with an fp32 operand
    instead."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    xh = x.permute(0, 2, 1, 3)                                  # (B, H, S, P)
    Bh = Bm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)   # (B, H, S, N)
    Ch = Cm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dth = dt.permute(0, 2, 1)                                   # (B, H, S)
    tf = rounding == "tf32"

    def parts(v):                # the operand parts of one split product
        return (tf32(v), None) if tf else split(v)

    def prod(pairs):             # one accumulator per product
        return [mma(tf32(a) if tf else a, tf32(b) if tf else b) for a, b in pairs]

    h = torch.zeros((Bsz, H, P, N))
    ys = []
    for t0 in range(0, S, chunk):
        xc, Bc, Cc = xh[:, :, t0:t0 + chunk], Bh[:, :, t0:t0 + chunk], Ch[:, :, t0:t0 + chunk]
        dtc = dth[:, :, t0:t0 + chunk]
        Lc = xc.shape[2]
        cum = torch.cumsum(dtc * A[None, :, None], dim=-1)      # (B, H, Lc)
        dtx = xc * dtc[..., None]
        xdec = dtx * torch.exp(cum[..., -1:] - cum)[..., None]
        hh, hl = parts(h)
        tiles = range(0, Lc, SSD_TILE)
        y = torch.zeros((Bsz, H, Lc, P))
        for i0 in tiles:
            ri = slice(i0, i0 + SSD_TILE)
            acc = 0
            for j0 in tiles:
                if j0 > i0:
                    break
                rj = slice(j0, j0 + SSD_TILE)
                seg = cum[..., ri, None] - cum[..., None, rj]
                low = (i0 + torch.arange(seg.shape[-2]))[:, None] >= (
                    j0 + torch.arange(seg.shape[-1]))[None, :]
                decay = torch.exp(torch.where(low, seg, torch.tensor(float("-inf"))))
                sc = mma(Cc[..., ri, :], Bc[..., rj, :].transpose(-1, -2)) * decay
                sh, sl = parts(sc)
                xhi, xlo = parts(dtx[..., rj, :])
                if tf:
                    acc = acc + prod([(sh, xhi)])[0]
                else:
                    acc = acc + torch.stack(prod([(sh, xhi), (sl, xhi), (sh, xlo)]))
            yt = acc if tf else acc[0] + acc[1] + acc[2]
            ct = Cc[..., ri, :]
            oh = prod([(ct, hh.transpose(-1, -2))] + ([] if tf else [(ct, hl.transpose(-1, -2))]))
            y[..., ri, :] = yt + torch.exp(cum[..., ri])[..., None] * (
                oh[0] if tf else oh[0] + oh[1])
        h = h * torch.exp(cum[..., -1])[..., None, None]
        for j0 in tiles:
            rj = slice(j0, j0 + SSD_TILE)
            dh, dl = parts(xdec[..., rj, :].transpose(-1, -2))
            th = prod([(dh, Bc[..., rj, :])] + ([] if tf else [(dl, Bc[..., rj, :])]))
            h = h + (th[0] if tf else th[0] + th[1])
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), h


def exact_ssd(x, dt, A, Bm, Cm):
    """float64 recurrence h_t = h_{t-1} exp(dt_t A) + (dt_t x_t) B_tᵀ,
    y_t = C_t h_t: the yardstick of rounding."""
    Bsz, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.double().repeat_interleave(rep, dim=2)
    Ch = Cm.double().repeat_interleave(rep, dim=2)
    h = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t].double() * A.double())          # (B, H)
        h = h * dA[..., None, None] + (dt[:, t].double()[..., None] * x[:, t].double()
                                       )[..., None] * Bh[:, t, :, None, :]
        ys.append((h * Ch[:, t, :, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h


def _ssd_inputs(B, S, H, P, G, N, seed):
    """bf16-valued x, B, C and fp32 dt (after softplus) and A = -exp(0.5 z),
    as `tests/test_kernels.py` draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x, Bm, Cm = _bf16_inputs([(B, S, H, P), (B, S, G, N), (B, S, G, N)], seed)
    dt = torch.as_tensor(np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f))
    A = torch.as_tensor((-np.exp(0.5 * rng.standard_normal(H))).astype(f))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", [(1, 77, 4, 16, 1, 32, 32), (1, 130, 4, 32, 2, 64, 64),
                                   (2, 40, 2, 16, 1, 128, 32)],
                         ids=["s77_chunk32", "grouped_s130_chunk64", "n128_b2"])
def test_ssd_model_matches_pallas_kernel(shape):
    """The model of the bf16 kernel against the Pallas kernel on the same
    bf16 inputs: y (rounded to bf16) at atol = rtol = 2e-2, the fp32 final
    state at 1e-3."""
    B, S, H, P, G, N, chunk = shape
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, G, N, seed=S + N)
    jx, jB, jC = (jnp.asarray(t.numpy(), jnp.bfloat16) for t in (x, Bm, Cm))
    gy, gh = jops.ssd_scan(jx, jnp.asarray(dt.numpy()), jnp.asarray(A.numpy()), jB, jC,
                           chunk=chunk)
    y, h = ssd_model(x, dt, A, Bm, Cm, chunk=chunk)
    np.testing.assert_allclose(bf16(y).numpy(), np.asarray(gy, np.float32),
                               atol=SSD_TOL_Y, rtol=SSD_TOL_Y)
    np.testing.assert_allclose(h.numpy(), np.asarray(gh), atol=SSD_TOL_H, rtol=SSD_TOL_H)


def test_ssd_split_products_hold_the_state_tolerance():
    """Against float64, the split products keep the fp32 state 100x inside
    its 1e-3 tolerance (atol + rtol |h|); TF32 products would use more than
    10x as much of it."""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 200, 4, 16, 1, 64, seed=3)
    y_ex, h_ex = exact_ssd(x, dt, A, Bm, Cm)

    def used(rounding):          # max of |err| / (atol + rtol |ref|), for y and h
        y, h = ssd_model(x, dt, A, Bm, Cm, chunk=64, rounding=rounding)
        return [((a.double() - e).abs() / (tol + tol * e.abs())).max().item()
                for a, e, tol in ((y, y_ex, SSD_TOL_Y), (h, h_ex, SSD_TOL_H))]

    (y_split, h_split), (_, h_tf32) = used("split"), used("tf32")
    assert y_split < 1e-2 and h_split < 1e-2
    assert h_tf32 > 10 * h_split


# ---------------------------------------------------------------------------
# MoE top-k gating
# ---------------------------------------------------------------------------

MOE_MAX_E = 64                    # MAX_E in moe_topk.cu
MOE_W_TOL = 1e-6                  # chip_smoke.MOE_W_TOL
MOE_SHAPES = [(60, 4), (64, 6), (16, 2), (8, 2), (8, 3), (4, 2)]


def moe_layout(lanes: int, *, interleaved: bool = False) -> torch.Tensor:
    """``(lanes, 64 // lanes)`` expert ids: register c of group lane g holds
    expert g * (64 // lanes) + c, the kernel's layout, so lane order is
    expert order; ids >= E are absent. ``interleaved``: the layout the
    kernel does not use, lane g's loads of VEC = min(4, 64 // lanes) at
    (s * lanes + g) * VEC, which breaks that order."""
    per = MOE_MAX_E // lanes
    c, g = torch.arange(per), torch.arange(lanes)
    if not interleaved:
        return g[:, None] * per + c[None]
    vec = min(per, 4)
    return ((c[None] // vec) * lanes + g[:, None]) * vec + c[None] % vec


def _pairwise(t, op):
    """A lane's tree over its registers (last dim): adjacent pairs, level by
    level, as `lane_max` / `lane_sum` pair them."""
    while t.shape[-1] > 1:
        t = op(t[..., 0::2], t[..., 1::2])
    return t[..., 0]


def _butterfly(t, op):
    """The exchange across a row's lanes (last dim): at offsets L/2, ..., 1
    each lane combines its value with that of lane ``g ^ offset``; every
    lane ends with the same result."""
    lanes = torch.arange(t.shape[-1])
    o = t.shape[-1] // 2
    while o:
        t = op(t, t[..., lanes ^ o])
        o //= 2
    return t


def moe_topk_model(x: torch.Tensor, k: int, *, norm_topk: bool, lanes: int,
                   interleaved: bool = False):
    """The kernel's arithmetic and order: ``(T, E)`` logits -> (weights fp32,
    ids int64). Each lane reduces its registers first (pairwise), then the
    lanes exchange (the max, then the exp-sum in the kernel's order). Each
    expert's key is bits(p) + 1 (0: taken or absent); a lane's best is its
    largest key, its lowest register among equals. A sweep takes the
    group's largest key, and the lowest lane whose best equals it holds the
    pick: it zeroes that key and takes its next best. The weights' sum for
    ``norm_topk`` runs in pick order."""
    T, E = x.shape
    ex = moe_layout(lanes, interleaved=interleaved)
    present = ex < E
    v = torch.full((T, *ex.shape), float("-inf"))
    v[:, present] = x.float()[:, ex[present]]
    mx = _butterfly(_pairwise(v, torch.maximum), torch.maximum)
    e = torch.exp(v - mx[..., None])
    denom = _butterfly(_pairwise(e, torch.add), torch.add)
    p = e / denom[..., None]
    key = torch.where(present, p.view(torch.int32).long() + 1, 0)    # (T, lanes, regs)
    rows = torch.arange(T)
    ws, ids, total = [], [], torch.zeros(T)
    for _ in range(k):
        best, reg = key.max(dim=2)             # ties: the first, the lowest register
        top = best.max(dim=1).values
        lane = (best == top[:, None]).int().argmax(dim=1)   # the lowest lane holding it
        c = reg[rows, lane]
        w = p[rows, lane, c]
        total = total + w
        ws.append(w)
        ids.append(ex[lane, c])
        key[rows, lane, c] = 0
    w, i = torch.stack(ws, dim=1), torch.stack(ids, dim=1)
    return (w / total[:, None] if norm_topk else w), i


def _moe_logits(T, E, seed):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    x[3] = 0.25                               # every expert ties
    x[5] = np.tile([1.0, 2.0, 2.0], E)[:E]    # ties among the largest
    return x


def _tie_ids(E, k):
    """Row 5 of `_moe_logits`: its 2.0s, then its 1.0s, in index order."""
    return sorted(range(E), key=lambda e: (e % 3 == 0, e))[:k]


@functools.lru_cache(maxsize=None)
def _pallas_gate(E, k, norm_topk):
    w, i = jops.moe_topk(jnp.asarray(_moe_logits(200, E, seed=E + k)), k, norm_topk=norm_topk)
    return np.asarray(w), np.asarray(i)


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_moe_layout_holds_each_expert_once_in_lane_order(lanes):
    """Every expert id 0..63 sits in exactly one register of one lane; lane
    by lane and register by register the ids rise, so the lowest lane
    holding a key holds its lowest expert; and every load is VEC
    neighbouring experts from a VEC boundary (one 8- or 16-byte access where
    E is a multiple of VEC)."""
    ex = moe_layout(lanes)
    vec = min(MOE_MAX_E // lanes, 4)
    assert ex.flatten().tolist() == list(range(MOE_MAX_E))
    loads = ex.reshape(lanes, -1, vec)
    assert bool((loads - loads[..., :1] == torch.arange(vec)).all())
    assert bool((loads[..., 0] % vec == 0).all())


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("E,k", MOE_SHAPES, ids=[f"E{E}_k{k}" for E, k in MOE_SHAPES])
def test_moe_model_matches_pallas_kernel(E, k, lanes):
    """The model of the kernel's layout, sums and sweeps against the Pallas
    kernel (interpret mode) on random rows and the tie rows (row 3: every
    expert equal; row 5: equal largest values in every lane): ids exactly
    equal, weights within 1e-6, with and without renormalisation."""
    x = torch.as_tensor(_moe_logits(200, E, seed=E + k))
    for norm in (False, True):
        gw, gi = _pallas_gate(E, k, norm)
        w, i = moe_topk_model(x, k, norm_topk=norm, lanes=lanes)
        np.testing.assert_array_equal(i.numpy(), gi)
        np.testing.assert_allclose(w.numpy(), gw, atol=MOE_W_TOL, rtol=0)
        assert i[3].tolist() == list(range(k))
        assert i[5].tolist() == _tie_ids(E, k)


def test_moe_lowest_lane_rule_needs_lanes_in_expert_order():
    """The sweep's rule (the lowest lane holding the largest key) is the
    tie rule only because lane order is expert order. With the loads
    interleaved across 8 lanes, row 5's third and fourth picks go to experts
    32 and 34 (lane 0's second load), not 4 and 5 (lane 1's first)."""
    x = torch.as_tensor(_moe_logits(200, 60, seed=64))
    _, kept = moe_topk_model(x, 4, norm_topk=False, lanes=8)
    _, mixed = moe_topk_model(x, 4, norm_topk=False, lanes=8, interleaved=True)
    assert kept[5].tolist() == _tie_ids(60, 4) == [1, 2, 4, 5]
    assert mixed[5].tolist() == [1, 2, 32, 34]
