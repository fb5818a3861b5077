#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   — compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each Hopper kernel against its plain PyTorch version on the
             card, at the serving shapes, within the stated tolerances; times
             of the kernel, the plain version and one PyTorch library call for
             the same function where there is one (the yardstick; the port
             never calls it); and the launch floor, an empty kernel timed
             the same way.
4. serve   — ``ServingEngine`` serving full-width Qwen1.5-MoE-A2.7B (bf16,
             random weights from seed 0) on the paged pool: 8 requests, 16 new
             tokens each. The launch counters are zeroed just before the first
             run and read just after it: flash and MoE top-k must launch once
             per layer per prefill, the SSD scan never. The decode step is a
             CUDA graph: the engine's first decode step runs eagerly and
             captures it, every later step must replay it. A second identical
             run must give identical streams (each step's host time
             recorded); a third, profiled run shows where the device time
             goes, and the empty kernel's device duration in the same trace;
             a fourth holds every replayed step to the eager step over a
             clone of its state and inputs (logits, and the streams).
5. paths   — every serve prompt's full-width prefill, kernel path against
             the plain path on the card, in fp32 and in bf16: router logits
             within tolerance up to the first layer whose MoE routing
             differs, final logits within tolerance where it never does;
             and the bf16 kernel path no further from the fp32 logits than
             the bf16 plain paths are.
6. ssm serve — the same for full-width Mamba2-370m (bf16, random weights
             from seed 0) on the slot-granular pool: 8 requests over 4 slots,
             so slots are refilled over a used state. The SSD scan must
             launch once per layer per prefill, flash and MoE top-k never;
             the decode graph as for Qwen.
7. ssm paths — every Mamba2 serve prompt's prefill, kernel path against the
             plain path: in fp32 the logits and every layer's final state
             within tolerance; in bf16 the kernel path no further from the
             fp32 logits than the plain path is; and decode continuity:
             prefill(S) + one decode step gives prefill(S + 1)'s logits at
             the chunk boundaries.
8. cluster — the intent-driven cluster path (`ServingCluster`,
             `Orchestrator`) on full-width Minitron-4B (bf16, random weights
             from seed 0; paged engines of 8 slots, s_max 512): a unified
             engine runs the serve prompts twice (the oracle); then a phi and
             a general engine take four unlabeled and four phi requests, the
             intent "Phi traffic must remain inside the pod." is submitted
             with ``async_reconfig`` while they decode (PREPARE warms beside
             serving; the swap commits at a step boundary), two unlabeled
             decoding requests migrate, the batch runs again on the
             reconfigured pair in turns with the unified engine, and a phi
             request is rejected once the phi engine retires; then a prefill and a decode engine hand
             every request off at its first token. Streams equal the
             oracle; no route lands mid-swap; flash launches once per layer
             per prefill (PREPARE's warm prefills included), never in a
             migration; the swap installs the decode graph PREPARE captured
             beside serving, nothing is captured inside the swap window and
             no graph is discarded; every engine's decode steps after its
             first replay its graph. Prints the swap's ``DowntimeReport`` and every pause
             beside the paper's 50 ms budget as ``within`` or ``over``, and
             TTFT/TPOT of the reconfigured pair and of the handoff pair
             against the unified engine over paired windows taken in turns
             (median and range of the ratios) beside its 10 % budget as
             ``within``, ``over`` or ``unresolved``; never a failure.
9. scale   — the elastic control loop (`Autoscaler`, `ElasticPolicy`,
             `WorkloadPlanner`) on the same Minitron-4B: the card's
             calibrated profile and the decode step's counted features; a
             seeded trace (`repro_torch.traffic`: 2 req/s over phi and
             general for 24 logical seconds, a 4x flash crowd on phi) runs
             once on a unified engine (the oracle), then twice on a cluster
             of a phi and a general engine whose scaler spawns (PREPARE
             beside serving) and retires: under the threshold
             policy with the intent "... keep between one and three engines
             for phi traffic", and under the planner with a TTFT target.
             Streams equal the oracle; each run spawns during the burst and
             retires after it; every report is finalized (the run ends by
             retiring every engine); no request lands
             on a draining engine; flash launches once per layer per prefill
             (PREPARE's warm prefills included); device memory is back
             within one KV page after the last retire. Prints engines per
             label per tick, each spawn's and retire's times, TTFT/TPOT per
             label, SLO attainment, engine-seconds, and the planner's
             predicted TPOT against the measured one.
10. replay — the discrete-event replay (`repro_torch.traffic.replay_trace`)
             of the elastic loop on the same Minitron-4B, on a `FakeClock`
             (tick 1 µs; one decode step is 20 ms of simulated time, the
             unified engine's TPOT on the card): the scale phase's trace
             through a `WorkloadPlanner` over the card's profile and an
             `Autoscaler` with sync spawns, twice on fresh stacks: with the
             flight recorder and the Watchtower `AlertEvaluator`, and with
             recording off. Both runs' `ReplayStats` and decisions per tick
             are equal; nothing is dropped; every stream equals the oracle's;
             every report is finalized; flash launches once per layer per
             prefill; `RequestLineage` conserves TTFT and TPOT within 1e-9;
             the `SLOLedger`'s attainment is the replay's; the recorder
             dropped nothing; the Chrome export validates; every debug bundle
             round-trips; memory is back within one page. Prints the run's
             figures and both runs' wall time (the recorder's cost).
11. ssm migrate — Mamba2-370m at full width and half depth on two
             slot-granular engines: two requests migrate mid-decode; streams equal the run without
             migration; the SSD scan launches once per layer per prefill.
12. output — a ``{"kernels": [...]}`` JSON line, then, last, the result line
             ``{"ok": true, "device": {...}}``.

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, the PATH or /usr/local/cuda)
and the repository's ``src/`` beside this file. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity

FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # atol = rtol (tests/test_kernels.py)
MOE_W_TOL = 1e-6
# Full-width prefill, kernel path against plain path (logits and router
# logits have std ~0.9). In fp32 the attention sums run in another order
# (~1e-6 relative), which 24 layers carry on. In bf16 that order decides a
# few roundings of each layer's output by one ulp (2**-8 relative), and
# these too are carried on.
ROUTER_TOL = {"float32": 1e-3, "bfloat16": 0.1}       # up to the routing split
PATH_LOGITS_TOL = {"float32": 1e-3, "bfloat16": 0.25}  # where routing never splits
# bf16 prefill logits, each path against the fp32 model's (plain path): the
# kernel path's rms deviation, averaged over the serve prompts, may exceed
# the larger of the two bf16 plain paths' (one chunk; the kernel's 64 x 64
# tiling) by at most this factor.
BF16_PATH_RATIO = 1.5

# the SSD scan against its plain version, (y, final state), atol = rtol:
# 1e-4 in fp32 (tests/test_kernels.py). In bf16 y rounds to bf16 (2e-2); the
# fp32 state is widened alike on both sides, and only the order of the sums
# differs (1e-3).
SSD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-3)}
# full-width fp32 Mamba2, kernel path against plain path: last-token logits
# max |diff| and every layer's final SSM state (atol = rtol); the same for
# decode continuity (prefill(S) + one decode step against prefill(S + 1)).
SSM_PATH_TOL = 1e-3

SERVE_ARCH = "qwen2_moe_a2_7b"
SERVE_PROMPT_LENS = (17, 64, 100, 150, 200, 256, 320, 384)
SERVE_NEW_TOKENS = 16
SSM_ARCH = "mamba2_370m"
SSM_PROMPT_LENS = (17, 100, 255, 256, 257, 384, 512, 1000)
SSM_CONTINUITY_LENS = (255, 256, 511)     # around the chunk boundary (256)
# the kernels each served model's prefill runs, once per layer
SERVE_KERNELS = {SERVE_ARCH: ("flash_attention", "moe_topk"), SSM_ARCH: ("ssd_scan",)}


def free_device() -> None:
    """Return the memory of what the last phase dropped to the card: collect
    reference cycles (a wrapped engine method holds its engine), then empty
    PyTorch's cache."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around the replay of a CUDA
    graph holding ``iters`` calls, so no host launch cost is inside (inputs
    warm in L2)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = 50) -> float:
    """Time per call as an eager caller sees it: CUDA events around
    ``iters`` back-to-back calls (host launch cost included)."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype: str):
    """(least time in ms, "bytes" | "operations") on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(out, gold, tol: float):
    """(every element within atol = rtol = ``tol`` of ``gold``, max |err|)."""
    diff = (out.float() - gold.float()).abs()
    return bool((diff <= tol + tol * gold.float().abs()).all()), diff.max().item()


def ssd_work(B, S, H, G, P, N, chunk, x_bytes):
    """(bytes, operations) of one SSD scan: x, dt, A, B, C read once, y and
    the final state written once; per head and chunk of Lc rows the causal
    half of the two Lc x Lc products (C Bᵀ, then times dt x) and the two
    state products (C hᵀ, the state update)."""
    nbytes = (2 * B * S * H * P * x_bytes + B * S * H * 4 + H * 4
              + 2 * B * S * G * N * x_bytes + B * H * P * N * 4)
    ops = 0
    for t0 in range(0, S, chunk):
        Lc = min(chunk, S - t0)
        ops += 2 * Lc * (Lc + 1) // 2 * (N + P) + 2 * 2 * Lc * P * N
    return nbytes, ops * B * H


def _ssd_case(gen, B, S, H, G, P, N, dtype):
    """SSD inputs as tests/test_kernels.py draws them: dt after softplus,
    A = -exp(0.5 z)."""
    import torch
    import torch.nn.functional as F
    x = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn(H, generator=gen, device="cuda"))
    Bm, Cm = (torch.randn(B, S, G, N, generator=gen, device="cuda").to(dtype) for _ in "BC")
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count={torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    say(f"[build] kernels {_build.source_hash()} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS:.2f} s)")
    for line in _build.PTXAS_LOG.splitlines():
        if "registers" in line:
            say(f"[build] {line.strip()}")


def grid_note(blocks: int) -> str:
    """Blocks of a launch and the SMs they can occupy at once (blocks go
    to distinct SMs first)."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{blocks} blocks, {min(blocks, n_sm)} of {n_sm} SMs used"


def _flash_case(gen, B, S, Hq, Hkv, D, dtype):
    import torch
    mk = lambda H: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(Hq), mk(Hkv), mk(Hkv)


# (E, k) of the repo's MoE configs: qwen2_moe, moonshot, jamba, and the
# reduced ones
MOE_SHAPES = ((60, 4), (64, 6), (16, 2), (8, 2), (8, 3), (4, 2))


def _moe_case(gen, T, E, dtype):
    """Router logits; row 3 ties everywhere, row 5 ties among its largest."""
    import torch
    x = torch.randn(T, E, generator=gen, device="cuda")
    if T > 5:
        x[3] = 0.5
        x[5] = torch.tensor(([1.0, 2.0, 2.0] * E)[:E], device="cuda")
    return x.to(dtype)


def moe_tie_ids(E, k):
    """The ids row 5 of `_moe_case` must get: its 2.0s, then its 1.0s, each
    in index order."""
    return sorted(range(E), key=lambda e: (e % 3 == 0, e))[:k]


def phase_kernels(card):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as moe
    from repro_torch.kernels import ssd_scan as ssd
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    # -- flash attention: compare ------------------------------------------
    # the serve shapes (Qwen's, and Minitron's 3:1 GQA at every prompt
    # length the cluster phase prefills and PREPARE warms), then every edge
    # of the bf16 kernel's tiles (16-row warp strips, 64-row q and k tiles,
    # the two warp groups' k walks, 32-column causal halves) at each head
    # dim it takes, batched, GQA
    flash_err = 0.0
    shapes = [(1, S, 16, 16, 128, "qwen") for S in (17, 128, 200, 384, 512)]
    shapes += [(1, S, 24, 8, 128, "minitron-gqa") for S in SERVE_PROMPT_LENS]
    shapes += [(2, S, 6, 2, D, "edge") for S in (17, 77, 200, 257) for D in (16, 32, 64)]
    for B, S, Hq, Hkv, D, tag in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_case(gen, B, S, Hq, Hkv, D, dtype)
            for causal in (True, False):
                out = ops.flash_attention(q, k, v, causal=causal)
                gold = ref.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                tol = FLASH_TOL[str(dtype).replace("torch.", "")]
                ok, err = within(out, gold, tol)
                say(f"[kernels] flash {tag} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                    f"{dtype} causal={causal}: max|err|={err:.3e} "
                    f"(atol=rtol={tol}) {'ok' if ok else 'FAIL'}")
                check(ok, f"flash kernel disagrees with its plain version ({tag}, S={S}, "
                          f"{dtype}, causal={causal})")
                if tag == "qwen" and dtype == torch.bfloat16 and causal:
                    flash_err = max(flash_err, err)

    # -- flash attention: time at the serve shapes (bf16, causal) ----------
    flash_times = {}
    for S in (128, 200, 384, 512):
        q, k, v = _flash_case(gen, 1, S, 16, 16, 128, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kernel = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
        flash_times[S] = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "eager_ms": eager_ms(kernel),
        }
        nbytes = 4 * q.numel() * q.element_size()
        ops_ = 4 * 16 * 128 * S * (S + 1) // 2       # two products over the causal pairs
        flash_times[S]["bound_ms"], flash_times[S]["bound_by"] = bound(nbytes, ops_, "bfloat16")
        flash_times[S]["grid"] = grid_note(-(-S // fa.BF16_Q_TILE) * 16)
        say(f"[kernels] flash time S={S} bf16 causal: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in flash_times[S].items()) + f"  [{card}]")
    t = flash_times[384]
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:31",
                 "launches": None, "max_abs_err": flash_err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "eager_ms": t["eager_ms"], "shape": "B=1 S=384 Hq=Hkv=16 D=128 bf16 causal"})

    # -- MoE top-k: compare ------------------------------------------------
    # every (E, k) of the repo's MoE configs, fp32 and bf16 logits; T from
    # one row, one short of and one past a block's rows, one past 48 and 128
    # full blocks (a last block with one live row), to two dispatch groups;
    # rows 3 and 5 tie (T > 5)
    moe_err = 0.0
    r = moe.BLOCK_ROWS
    moe_tokens = sorted({1, 2, r - 1, r + 1, 17, 384, 385, 1024, 1025, 2048})
    for E, k in MOE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            worst = 0.0
            for T in moe_tokens:
                x = _moe_case(gen, T, E, dtype)
                for norm in (False, True):
                    w, i = ops.moe_topk(x, k, norm_topk=norm)
                    wr, ir = ref.moe_topk_ref(x, k, norm_topk=norm)
                    torch.cuda.synchronize()
                    err = (w - wr).abs().max().item()
                    ties = T <= 5 or (i[3].tolist() == list(range(k))
                                      and i[5].tolist() == moe_tie_ids(E, k))
                    check(torch.equal(i, ir) and ties and err <= MOE_W_TOL,
                          f"moe_topk kernel disagrees with its plain version (E={E}, k={k}, "
                          f"{dtype}, T={T}, norm={norm}): ids equal {torch.equal(i, ir)}, "
                          f"tie rows lowest-index {ties}, max|w err| {err:.3e}")
                    worst = max(worst, err)
            say(f"[kernels] moe_topk E={E} k={k} {dtype}: T={moe_tokens}, norm False and True: "
                f"ids equal, tie rows lowest-index, max|w err|={worst:.3e} (tol {MOE_W_TOL}) ok")
            moe_err = max(moe_err, worst)

    # -- MoE top-k: time at the largest serve prefill (T=384) --------------
    x = torch.randn(384, 60, generator=gen, device="cuda")
    mt = {
        "ms": time_ms(lambda: ops.moe_topk(x, 4)),
        "eager_ms": eager_ms(lambda: ops.moe_topk(x, 4)),
        "plain_ms": time_ms(lambda: ref.moe_topk_ref(x, 4)),
        "library_ms": time_ms(lambda: torch.topk(torch.softmax(x, dim=-1), 4)),
    }
    nbytes = x.numel() * 4 + 384 * 4 * (4 + 4)
    ops_ = 384 * 60 * (5 + 4)       # softmax ~5 per logit, one compare per sweep
    mt["bound_ms"], mt["bound_by"] = bound(nbytes, ops_, "float32")
    mt["grid"] = grid_note(-(-384 // moe.BLOCK_ROWS))
    say("[kernels] moe_topk time T=384 E=60 k=4 fp32: " + ", ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in mt.items())
        + f"  [{card}]")
    rows.append({"name": "moe_topk", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/moe_topk.cu",
                 "replaces": "src/repro/kernels/moe_dispatch.py:25",
                 "launches": None, "max_abs_err": moe_err, "ms": mt["ms"],
                 "plain_ms": mt["plain_ms"], "bound_ms": mt["bound_ms"],
                 "bound_by": mt["bound_by"], "library_ms": mt["library_ms"],
                 "eager_ms": mt["eager_ms"], "shape": "T=384 E=60 k=4 fp32"})

    # -- the launch floor: an empty kernel, timed as the kernels are -------
    dev = torch.device("cuda", torch.cuda.current_device())
    empty = lambda: _build.launch("launch_floor", dev)  # noqa: E731
    floor = {"ms": time_ms(empty), "eager_ms": eager_ms(empty)}
    say(f"[kernels] launch floor (empty kernel, 1 block of 32 threads): graph-timed "
        f"ms={floor['ms']:.5f}, eager ms={floor['eager_ms']:.5f} (ctypes path)  [{card}]")

    # -- SSD scan: compare -------------------------------------------------
    ssd_err = 0.0
    cases = [(1, S, 32, 1, 64, 128, 256, "mamba2") for S in (17, 255, 256, 257, 512, 1000)]
    cases.append((2, 77, 8, 2, 16, 32, 32, "grouped"))
    # every edge of the tiles: one P tile (P=16), grouped heads, chunks of 32
    # (a quarter of a 128-row tile) and 256, ragged tails within and across
    # chunks
    cases += [(2, S, 8, 2, 16, 128, chunk, "edge") for S in (17, 77, 255, 257)
              for chunk in (32, 256)]
    for B, S, H, G, P, N, chunk, tag in cases:
        for dtype in (torch.float32, torch.bfloat16):
            inp = _ssd_case(gen, B, S, H, G, P, N, dtype)
            y, h = ops.ssd_scan(*inp, chunk=chunk)
            y_ref, h_ref = ref.ssd_scan_ref(*inp, chunk=chunk)
            torch.cuda.synchronize()
            tol_y, tol_h = SSD_TOL[str(dtype).replace("torch.", "")]
            ok_y, err_y = within(y, y_ref, tol_y)
            ok_h, err_h = within(h, h_ref, tol_h)
            say(f"[kernels] ssd_scan {tag} B={B} S={S} H={H} G={G} P={P} N={N} "
                f"chunk={chunk} {dtype}: y max|err|={err_y:.3e} (atol=rtol={tol_y}), "
                f"state max|err|={err_h:.3e} (atol=rtol={tol_h}) "
                f"{'ok' if ok_y and ok_h else 'FAIL'}")
            check(ok_y and ok_h, f"ssd_scan kernel disagrees with its plain version "
                                 f"({tag}, S={S}, {dtype})")
            if tag == "mamba2" and dtype == torch.bfloat16:
                ssd_err = max(ssd_err, err_y)

    # -- SSD scan: time at two serve prompt lengths (bf16) -----------------
    ssd_times = {}
    for S in (512, 1000):
        inp = _ssd_case(gen, 1, S, 32, 1, 64, 128, torch.bfloat16)
        kernel = lambda: ops.ssd_scan(*inp, chunk=256)  # noqa: E731
        ssd_times[S] = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*inp, chunk=256)),
            "library_ms": None,          # no single PyTorch call computes the scan
            "eager_ms": eager_ms(kernel),
        }
        ssd_times[S]["bound_ms"], ssd_times[S]["bound_by"] = bound(
            *ssd_work(1, S, 32, 1, 64, 128, 256, 2), "bfloat16")
        ssd_times[S]["grid"] = grid_note(32 * 64 // ssd.P_TILE)
        say(f"[kernels] ssd_scan time S={S} H=32 P=64 N=128 chunk=256 bf16: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ssd_times[S].items()) + f"  [{card}]")
    t = ssd_times[1000]
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan.py:28",
                 "launches": None, "max_abs_err": ssd_err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 "eager_ms": t["eager_ms"],
                 "shape": "B=1 S=1000 H=32 G=1 P=64 N=128 chunk=256 bf16"})
    return rows, {"flash": flash_times, "moe_topk": mt, "ssd_scan": ssd_times,
                  "launch_floor": floor}


@contextlib.contextmanager
def routed(ops, ref, chunks, routing):
    """Send the model's prefill through the kernels (``chunks`` None) or
    through their plain versions (comparison only; ``chunks`` sets the plain
    attention's tiling: ``q_chunk``, ``k_chunk``), and append each MoE
    layer's (router logits, expert ids) to ``routing``, on the host. The
    model looks the wrappers up in `ops` at call time."""
    saved = ops.flash_attention, ops.moe_topk, ops.ssd_scan
    topk = ops.moe_topk
    if chunks is not None:
        ops.flash_attention = lambda q, k, v, *, causal=True, scale=None: \
            ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, **chunks)
        ops.ssd_scan = ref.ssd_scan_ref
        topk = ref.moe_topk_ref

    def recorded(logits, k, *, norm_topk=False):
        w, i = topk(logits, k, norm_topk=norm_topk)
        routing.append((logits.float().cpu(), i.cpu()))
        return w, i

    ops.moe_topk = recorded
    try:
        yield
    finally:
        ops.flash_attention, ops.moe_topk, ops.ssd_scan = saved


def routing_split(a, b):
    """Where two prefills' MoE routing (lists of (router logits, ids) per
    layer) first parts: (that layer or None, the max |router logit diff|
    over the layers up to it, the tokens routed otherwise there, the largest
    of those tokens' smallest gap between adjacent top-(k+1) logits in
    ``b``). Before the split both prefills saw the same experts, so their
    router logits differ only by rounding."""
    diff = 0.0
    for layer, ((la, ia), (lb, ib)) in enumerate(zip(a, b)):
        diff = max(diff, (la - lb).abs().max().item())
        rows = (ia != ib).any(dim=-1).nonzero().flatten()
        if len(rows):
            top = lb[rows].sort(dim=-1, descending=True).values[:, : ia.shape[-1] + 1]
            gap = (top[:, :-1] - top[:, 1:]).min(dim=-1).values.max().item()
            return layer, diff, len(rows), gap
    return None, diff, 0, None


def _serve_once(engine, prompts, Request):
    import torch
    reqs = [Request(i, p, max_new_tokens=SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return reqs, wall


def launches_per_prefill(arch, n):
    """Launch counts a run of ``arch`` prefills must add: ``n`` for each
    kernel its prefill runs, 0 for every other kernel."""
    from repro_torch.kernels import ops
    return {k: n if k in SERVE_KERNELS[arch] else 0 for k in ops.LAUNCHES}


def phase_serve(card, arch, prompt_lens, path_fn, profile_kernels, *, paged, **engine_kw):
    """``ServingEngine`` over full-width ``arch`` (bf16, random weights from
    seed 0) on the paged or the slot-granular pool (``paged``): run 1 with
    the launch counters zeroed just before it and read just after it (its
    first decode step runs eagerly and captures the decode graph, every
    later step replays it), run 2 identical with each step's host time
    recorded, then each prompt's prefill on each path (``path_fn``), whose
    kernel-path argmax must be the engine's first token, a profiled run 3,
    the host ops of one graph step against one eager ``decode_step``, and
    run 4, each graph step held to the eager step (`_graph_vs_eager`).
    Returns (launches of run 1, metrics, the per-prompt path outputs)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine, compute_metrics

    tag = "[serve]" if paged else "[ssm serve]"
    parts = [("start", time.perf_counter())]
    part = lambda name: parts.append((name, time.perf_counter()))  # noqa: E731
    cfg = get_config(arch)
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    part("model")
    n_params = sum(t.numel() for t in _leaves(model.params))
    say(f"{tag} {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.2f} B parameters ({cfg.param_dtype}), random from seed 0 "
        f"in {parts[-1][1] - parts[0][1]:.1f} s")
    engine = ServingEngine(model, **engine_kw)
    check(engine.paged is paged, f"{cfg.name}: the engine chose the "
                                 f"{'paged' if engine.paged else 'slot-granular'} pool")
    say(f"{tag} {'paged' if paged else 'slot-granular'} pool, {engine_kw}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs, wall = _serve_once(engine, prompts, Request)
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = launches_per_prefill(arch, cfg.num_layers * len(prompts))
    say(f"{tag} run 1: launches {launches} (want {want}), {len(engine.done)} done")
    check(launches == want,
          f"launch counts {launches} != {want} (one per layer per prefill)")
    check(all(len(r.tokens_out) == SERVE_NEW_TOKENS for r in reqs)
          and all(r.t_done > 0 for r in reqs),
          f"not every request completed with {SERVE_NEW_TOKENS} tokens")
    _check_graph_steps(tag, engine)
    m1 = compute_metrics(reqs)
    part("run 1")

    with _host_timed(engine) as (step_s, launch_s):
        reqs2, wall2 = _serve_once(engine, prompts, Request)
    check([r.tokens_out for r in reqs2] == [r.tokens_out for r in reqs],
          "a second identical run gave other token streams")
    _check_graph_steps(tag, engine)
    m2 = compute_metrics(reqs2)
    part("run 2")
    n_tok = len(prompts) * SERVE_NEW_TOKENS
    for name, m, w in (("run 1 (cold)", m1, wall), ("run 2 (warm)", m2, wall2)):
        say(f"{tag} {name}: TTFT mean {m['ttft_mean_s'] * 1e3:.1f} ms p99 "
            f"{m['ttft_p99_s'] * 1e3:.1f} ms, TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms "
            f"p99 {m['tpot_p99_s'] * 1e3:.2f} ms, {n_tok / w:.1f} tok/s "
            f"({n_tok} tokens in {w:.3f} s), peak memory {peak_gb:.2f} GB  [{card}]")
    graph = _graph_line(tag, "engine", engine, card)
    graph.update(step_ms_median=1e3 * float(np.median(step_s)),
                 launch_us_mean=1e6 * float(np.mean(launch_s)))
    say(f"{tag} run 2 host time: {len(step_s)} steps, step wall median "
        f"{graph['step_ms_median']:.3f} ms (prefills included where a step admits); "
        f"graph launch (replay call, returns before the device runs it) mean "
        f"{graph['launch_us_mean']:.1f} us over {len(launch_s)} replays  [{card}]")
    check(engine.kv_allocated_tokens == 0 and engine.free_tokens == engine.kv_token_capacity,
          "pool not pristine after run()")

    # every prompt's prefill on each path; the engine's first token is the
    # argmax of a direct prefill on the kernel path
    paths = [path_fn(model, p) for p in prompts]
    for r, lg in zip(reqs, paths):
        check(r.tokens_out[0] == int(lg["kernel"][0].argmax()),
              f"request {r.rid}: the engine's first token is not the prefill's argmax")
    part("paths")

    profile = _profile_run(engine, prompts, Request, [r.tokens_out for r in reqs], card,
                           profile_kernels)
    part("profiled run 3")
    profile["decode_step_host_ops"] = n_ops = _decode_step_host_ops(model, engine.n_slots)
    profile["graph_step_host_ops"] = g_ops = _graph_step_host_ops(engine, prompts[0])
    say(f"{tag} one model.decode_step over {engine.n_slots} sequences issues {n_ops} "
        f"top-level aten ops, {n_ops / cfg.num_layers:.1f} per layer (eager host work per "
        f"step); one engine decode step through the graph issues {g_ops}")
    part("host ops")
    graph["vs_eager"] = _graph_vs_eager(engine, prompts, [r.tokens_out for r in reqs],
                                        tag, card)
    _check_graph_steps(tag, engine)
    part("graph vs eager")
    part_s = {name: t - parts[i][1] for i, (name, t) in enumerate(parts[1:])}
    say(f"{tag} phase parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
        + f"  [{card}]")
    return launches, {"run1": m1, "run2": m2, "wall1_s": wall, "wall2_s": wall2,
                      "tokens": n_tok, "peak_gb": peak_gb, "profile": profile,
                      "graph": graph, "parts_s": part_s}, paths


def _check_graph_steps(tag, engine):
    """Every decode step after the engine's first replayed its graph."""
    s = engine.decode_stats
    check(s["eager"] == 1 and s["captures"] >= 1 and s["replays"] == engine.steps - 1,
          f"{tag}: {s} over {engine.steps} decode steps: every step after the first "
          "must replay the graph")


def _graph_line(tag, name, engine, card):
    """Print and return an engine's decode-graph counts and its graph's
    private pool."""
    s = dict(engine.decode_stats)
    exe = engine.decode_executable
    s.update(steps=engine.steps, pool_bytes=exe.pool_bytes() if exe is not None else 0)
    say(f"{tag} {name} decode graph: captures {s['captures']} in {s['capture_s']:.4f} s, "
        f"replays {s['replays']} of {s['steps']} decode steps (eager {s['eager']}), "
        f"installs {s['installs']}, discards {s['discards']}, graph pool "
        f"{s['pool_bytes'] / 2**20:.1f} MiB  [{card}]")
    return s


@contextlib.contextmanager
def _host_timed(engine):
    """Record each ``engine.step()``'s wall time and the host time of each
    replay call of its installed graph (which returns before the device
    runs the step); yields the two lists."""
    exe = engine.decode_executable
    step, run = engine.step, exe.run
    steps, launches = [], []

    def timed_step():
        t0 = time.perf_counter()
        n = step()
        steps.append(time.perf_counter() - t0)
        return n

    def timed_run():
        t0 = time.perf_counter()
        run()
        launches.append(time.perf_counter() - t0)

    engine.step, exe.run = timed_step, timed_run
    try:
        yield steps, launches
    finally:
        del engine.step, exe.run


def _graph_step_host_ops(engine, prompt):
    """Top-level aten ops that one engine decode step through the graph
    issues (tables unchanged, no admission): one request is admitted and
    decoded once, then one more step is profiled, and the request runs to
    its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request
    engine.submit(Request(-1, prompt, max_new_tokens=6))
    engine.step()
    engine.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
        torch.cuda.synchronize()
    engine.run()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))


def _graph_vs_eager(engine, prompts, streams, tag, card):
    """Run 4: the prompts once more, each graph step held to the eager
    step. Around every replay, the state and inputs the graph reads are
    cloned before it, and the engine's decode function (the paged decode
    or ``model.decode_step``) runs eagerly over the clones after it; the
    active lanes' logits are compared and the eager picks collected. The
    graph's streams must equal run 1's and the eager picks' streams."""
    import torch

    from repro_torch.serving import Request, kvpool
    model = engine.model
    vocab = model.cfg.vocab_size
    if engine.paged:
        eager = kvpool.make_paged_decode(model, *kvpool.page_axes(model))
    else:
        eager = lambda tokens, cache, pos, tables: model.decode_step(tokens, cache, pos)  # noqa: E731
    exe = engine.decode_executable
    run = exe.run
    diffs, picks = [], {}

    def checked_run():
        lanes = [(i, r.rid) for i, r in enumerate(engine.slot_req) if r is not None]
        state = {k: v.clone() for k, v in exe.cache.items()}
        tables = None if exe.tables is None else exe.tables.clone()
        tokens, pos = exe.tokens.clone(), exe.pos.clone()
        run()
        logits, _ = eager(tokens, state, pos, tables)
        rows = torch.tensor([i for i, _ in lanes], device=logits.device)
        got, want = exe.logits[rows, :vocab].float(), logits[rows, :vocab].float()
        diffs.append((got - want).abs().max().item())
        for (_, rid), p in zip(lanes, want.argmax(dim=-1).tolist()):
            picks.setdefault(rid, []).append(p)

    exe.run = checked_run
    try:
        reqs, _ = _serve_once(engine, prompts, Request)
    finally:
        del exe.run
    graph = [r.tokens_out for r in reqs]
    eager_streams = [r.tokens_out[:1] + picks.get(r.rid, []) for r in reqs]
    check(graph == streams, f"{tag}: run 4 gave other streams than run 1")
    check(eager_streams == graph, f"{tag}: the graph's streams differ from the eager steps'")
    say(f"{tag} graph vs eager, run 4: {len(diffs)} replays, each held to the eager decode "
        f"over a clone of the state and inputs it read: streams equal; active lanes' "
        f"max|logit diff| per step " + " ".join(f"{d:.1e}" for d in diffs)
        + f"; max {max(diffs):.3e}  [{card}]")
    return {"steps": len(diffs), "max_logit_diff": max(diffs), "logit_diff_per_step": diffs}


def _decode_step_host_ops(model, batch):
    """Top-level aten ops (each a host dispatch; views included) that one
    ``model.decode_step`` over a fresh ``batch``-sequence cache issues: what
    the host must get through per decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cache = model.init_cache(batch, 16)
    tokens = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
    pos = torch.zeros(batch, dtype=torch.long, device="cuda")
    model.decode_step(tokens, cache, pos)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.decode_step(tokens, cache, pos)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))


# the paths a prefill can take: the kernels, or their plain versions with one
# attention chunk or with the flash kernel's 64 x 64 tiling
PATHS = {"kernel": None, "plain": {}, "plain_tiled": {"q_chunk": 64, "k_chunk": 64}}


def _path_logits(model, prompt):
    """One prompt's last-token logits (fp32, real vocab, on the host) and
    MoE routing on each of `PATHS`, checking that each path launched what
    it should: ``{path: (logits, routing)}``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import padded_vocab
    cfg = model.cfg
    batch = {"tokens": torch.as_tensor(prompt, device="cuda")[None]}
    out = {}
    for name, chunks in PATHS.items():
        before, routing = dict(ops.LAUNCHES), []
        with routed(ops, ref, chunks, routing):
            logits, _ = model.prefill(batch)
        torch.cuda.synchronize()
        want = launches_per_prefill(SERVE_ARCH, cfg.num_layers if chunks is None else 0)
        want = {n: before[n] + k for n, k in want.items()}
        check(ops.LAUNCHES == want,
              f"the {name} path launched {ops.LAUNCHES} (before: {before}), want {want}")
        check(tuple(logits.shape) == (1, padded_vocab(cfg.vocab_size))
              and bool(torch.isfinite(logits).all()),
              f"{name} prefill logits: shape {tuple(logits.shape)}, or not finite")
        check(len(routing) == cfg.num_layers, f"{name} path: {len(routing)} MoE layers routed")
        out[name] = (logits[0, :cfg.vocab_size].float().cpu(), routing)
    return out


FLOOR_KERNEL = "launch_floor_kernel"
FLOOR_LAUNCHES = 192


def _profile_run(engine, prompts, Request, streams, card, kernels, top=12):
    """A third, profiled run: device time by kernel and the device's busy
    share of the run's wall time; per launch for the named ``kernels``. After
    the run, still in the profile, `FLOOR_LAUNCHES` launches of the empty
    kernel give the launch floor's device duration in the same trace (left
    out of the busy time and the table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    dev = torch.device("cuda", torch.cuda.current_device())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, wall = _serve_once(engine, prompts, Request)
        for _ in range(FLOOR_LAUNCHES):
            _build.launch("launch_floor", dev)
        torch.cuda.synchronize()
    check([r.tokens_out for r in reqs] == streams, "the profiled run gave other token streams")
    from torch.autograd import DeviceType
    rows, floor_us = [], None
    for evt in prof.key_averages():      # device-side events only
        if evt.device_type != DeviceType.CUDA:
            continue
        if FLOOR_KERNEL in evt.key:
            floor_us = evt.self_device_time_total / evt.count
        else:
            rows.append((evt.self_device_time_total, evt.count, evt.key))
    check(floor_us is not None, f"the profile shows no {FLOOR_KERNEL}")
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    say(f"[profile] run 3 (warm, profiled): wall {wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall:.1f} %), idle {100 * (1 - busy_s / wall):.1f} %  [{card}]")
    for dev_us, count, key in rows[:top]:
        say(f"[profile] {dev_us / 1e3:9.2f} ms  {count:6d} calls  "
            f"{100 * dev_us / 1e6 / busy_s:5.1f} %  {key[:90]}")
    for dev_us, count, key in rows:
        for name in kernels:
            if name in key:
                say(f"[profile] {name}: {count} launches, {dev_us / count:.2f} us each "
                    "on the device over the run's prompt mix")
    say(f"[profile] launch floor: {FLOOR_LAUNCHES} launches of the empty kernel, "
        f"{floor_us:.2f} us each on the device (same trace)")
    return {"wall_s": wall, "device_busy_s": busy_s, "launch_floor_us": floor_us,
            "top": [{"device_ms": d / 1e3, "calls": c, "name": k} for d, c, k in rows[:top]]}


def phase_paths(card, bf16):
    """Every serve prompt's full-width prefill on each path, in fp32 (made
    here) and in bf16 (``bf16``, from the serve phase; the bf16 weights are
    the fp32 ones rounded). MoE routing is discrete: where a token's top-k
    logits nearly tie, rounding alone can send it to other experts, and
    from there the paths part. So, for each dtype, the kernel path against
    the plain path: up to the first layer whose routing differs the router
    logits agree within `ROUTER_TOL`, and where routing never differs the
    final logits agree within `PATH_LOGITS_TOL` with the same top-1. Then,
    held to the fp32 logits, the bf16 kernel path may stray at most
    `BF16_PATH_RATIO` times as far as the bf16 plain paths do."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), param_dtype="float32",
                              activ_dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPT_LENS]
    fp32 = [_path_logits(model, p) for p in prompts]
    say(f"[paths] {cfg.name} full width, logit std {fp32[0]['plain'][0].std().item():.3f}; "
        f"per prompt, kernel vs plain path: routing split (layer, tokens, their largest "
        f"top-(k+1) logit gap), router logit max|diff| up to it, final logits  [{card}]")

    rows, ok = [], True
    for dtype, paths in (("float32", fp32), ("bfloat16", bf16)):
        for S, lg in zip(SERVE_PROMPT_LENS, paths):
            layer, rdiff, n, gap = routing_split(lg["kernel"][1], lg["plain"][1])
            t_layer, t_rdiff, _, _ = routing_split(lg["plain_tiled"][1], lg["plain"][1])
            lk, lp = lg["kernel"][0], lg["plain"][0]
            row = {"dtype": dtype, "S": S, "split_layer": layer, "split_tokens": n,
                   "split_gap": gap, "router_max_diff": rdiff,
                   "logits_max_diff": (lk - lp).abs().max().item(),
                   "top1_kernel": int(lk.argmax()), "top1_plain": int(lp.argmax()),
                   "tiled_split_layer": t_layer, "tiled_router_max_diff": t_rdiff}
            row["ok"] = rdiff <= ROUTER_TOL[dtype] and (layer is not None or (
                row["top1_kernel"] == row["top1_plain"]
                and row["logits_max_diff"] <= PATH_LOGITS_TOL[dtype]))
            ok &= row["ok"]
            rows.append(row)
            split = ("none" if layer is None
                     else f"layer {layer}, {n} tokens, gap {gap:.2e}")
            say(f"[paths] {dtype} S={S}: split {split}; router {rdiff:.2e} "
                f"(tol {ROUTER_TOL[dtype]}); logits max|diff| {row['logits_max_diff']:.3e}, "
                f"top-1 {row['top1_kernel']} vs {row['top1_plain']}"
                f"{'' if layer is not None else f' (tol {PATH_LOGITS_TOL[dtype]})'}; "
                f"plain_tiled vs plain split {t_layer}, router {t_rdiff:.2e}  "
                f"{'ok' if row['ok'] else 'FAIL'}")
    check(ok, "full-width prefill: the kernel path disagrees with the plain path")

    rms = lambda a, b: (a - b).pow(2).mean().sqrt().item()   # noqa: E731
    dev = {name: [rms(l16[name][0], l32["plain"][0]) for l16, l32 in zip(bf16, fp32)]
           for name in PATHS}
    top1 = {name: sum(int(l16[name][0].argmax()) == int(l32["plain"][0].argmax())
                      for l16, l32 in zip(bf16, fp32)) for name in PATHS}
    mean = {name: float(np.mean(v)) for name, v in dev.items()}
    limit = BF16_PATH_RATIO * max(mean["plain"], mean["plain_tiled"])
    for name in PATHS:
        say(f"[paths] bf16 {name} path vs fp32 plain logits, rms per prompt: "
            + " ".join(f"{v:.4f}" for v in dev[name])
            + f"; mean {mean[name]:.4f}; top-1 as fp32 in {top1[name]}/{len(prompts)}")
    say(f"[paths] bf16 kernel path mean rms {mean['kernel']:.4f} vs limit {limit:.4f} "
        f"({BF16_PATH_RATIO} x the plain paths')  [{card}]")
    check(mean["kernel"] <= limit,
          "full-width bf16 prefill: the kernel path strays further from fp32 "
          "than the plain paths do")
    return {"prompts": rows, "bf16_rms_vs_fp32": dev, "bf16_mean_rms_vs_fp32": mean,
            "bf16_top1_as_fp32": top1, "bf16_kernel_limit": limit}


def _ssm_path_outputs(model, prompt):
    """One Mamba2 prompt's last-token logits (fp32, real vocab, on the host)
    and every layer's final SSM state ``(L, 1, H, P, N)`` fp32 on the kernel
    and the plain path, checking that each path launched what it should:
    ``{path: (logits, states)}``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import padded_vocab
    cfg = model.cfg
    batch = {"tokens": torch.as_tensor(prompt, device="cuda")[None]}
    out = {}
    for name, chunks in (("kernel", None), ("plain", {})):
        before = dict(ops.LAUNCHES)
        with routed(ops, ref, chunks, []):
            logits, cache = model.prefill(batch)
        torch.cuda.synchronize()
        want = launches_per_prefill(SSM_ARCH, cfg.num_layers if chunks is None else 0)
        want = {n: before[n] + k for n, k in want.items()}
        check(ops.LAUNCHES == want,
              f"the {name} path launched {ops.LAUNCHES} (before: {before}), want {want}")
        check(tuple(logits.shape) == (1, padded_vocab(cfg.vocab_size))
              and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(cache["ssm"]).all()),
              f"{name} prefill: logits shape {tuple(logits.shape)}, or not finite")
        out[name] = (logits[0, :cfg.vocab_size].float().cpu(), cache["ssm"])
    return out


def phase_ssm_paths(card, bf16):
    """Every Mamba2 serve prompt's full-width prefill, kernel path against
    plain path: in fp32 (made here) the logits within `SSM_PATH_TOL` and
    every layer's final SSM state within atol = rtol = `SSM_PATH_TOL`; in
    bf16 (``bf16``, from the serve phase; the bf16 weights are the fp32
    ones rounded) the max logit difference, and the kernel path's rms
    against the fp32 logits at most `BF16_PATH_RATIO` times the plain
    path's. Then decode continuity in fp32 on the kernel path: prefill(S)
    and one decode step of token S give prefill(S + 1)'s logits within
    `SSM_PATH_TOL`, for S around the chunk boundary."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(SSM_ARCH), param_dtype="float32",
                              activ_dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SSM_PROMPT_LENS]
    rows, fp32, ok = [], [], True
    for S, prompt in zip(SSM_PROMPT_LENS, prompts):
        out = _ssm_path_outputs(model, prompt)
        (lk, hk), (lp, hp) = out["kernel"], out["plain"]
        s_ok, s_diff = within(hk, hp, SSM_PATH_TOL)
        row = {"dtype": "float32", "S": S, "logits_max_diff": (lk - lp).abs().max().item(),
               "states_max_diff": s_diff, "top1_kernel": int(lk.argmax()),
               "top1_plain": int(lp.argmax())}
        row["ok"] = s_ok and row["logits_max_diff"] <= SSM_PATH_TOL
        ok &= row["ok"]
        rows.append(row)
        fp32.append({name: lg for name, (lg, _) in out.items()})
        say(f"[ssm paths] float32 S={S}: logits max|diff| {row['logits_max_diff']:.3e}, "
            f"{cfg.num_layers} final states max|diff| {s_diff:.3e} (tol {SSM_PATH_TOL}), top-1 "
            f"{row['top1_kernel']} vs {row['top1_plain']}  {'ok' if row['ok'] else 'FAIL'}  [{card}]")
    check(ok, "full-width fp32 Mamba2 prefill: the kernel path disagrees with the plain path")

    for S, lg in zip(SSM_PROMPT_LENS, bf16):
        lk, lp = lg["kernel"][0], lg["plain"][0]
        rows.append({"dtype": "bfloat16", "S": S, "logits_max_diff": (lk - lp).abs().max().item(),
                     "top1_kernel": int(lk.argmax()), "top1_plain": int(lp.argmax())})
        say(f"[ssm paths] bfloat16 S={S}: kernel vs plain logits max|diff| "
            f"{rows[-1]['logits_max_diff']:.3e}, top-1 {rows[-1]['top1_kernel']} vs "
            f"{rows[-1]['top1_plain']}")
    rms = lambda a, b: (a - b).pow(2).mean().sqrt().item()   # noqa: E731
    dev = {name: [rms(l16[name][0], l32["plain"]) for l16, l32 in zip(bf16, fp32)]
           for name in ("kernel", "plain")}
    mean = {name: float(np.mean(v)) for name, v in dev.items()}
    limit = BF16_PATH_RATIO * mean["plain"]
    for name, v in dev.items():
        say(f"[ssm paths] bf16 {name} path vs fp32 plain logits, rms per prompt: "
            + " ".join(f"{x:.4f}" for x in v) + f"; mean {mean[name]:.4f}")
    say(f"[ssm paths] bf16 kernel path mean rms {mean['kernel']:.4f} vs limit {limit:.4f} "
        f"({BF16_PATH_RATIO} x the plain path's)  [{card}]")
    check(mean["kernel"] <= limit, "full-width bf16 Mamba2 prefill: the kernel path strays "
                                   "further from fp32 than the plain path does")

    toks = torch.as_tensor(prompts[-1], device="cuda")[None].long()
    continuity = {}
    for S in SSM_CONTINUITY_LENS:
        _, cache = model.prefill({"tokens": toks[:, :S]})
        stepped, _ = model.decode_step(toks[:, S:S + 1], cache, torch.tensor(S, device="cuda"))
        full, _ = model.prefill({"tokens": toks[:, :S + 1]})
        diff = (stepped - full)[0, :cfg.vocab_size].abs().max().item()
        continuity[S] = diff
        say(f"[ssm paths] decode continuity fp32: prefill({S}) + decode_step(token {S}) vs "
            f"prefill({S + 1}): logits max|diff| {diff:.3e} (tol {SSM_PATH_TOL})  "
            f"{'ok' if diff <= SSM_PATH_TOL else 'FAIL'}  [{card}]")
        check(diff <= SSM_PATH_TOL, f"decode after prefill({S}) parts from prefill({S + 1})")
    return {"prompts": rows, "bf16_rms_vs_fp32": dev, "bf16_mean_rms_vs_fp32": mean,
            "bf16_kernel_limit": limit, "decode_continuity_max_diff": continuity}


# ---------------------------------------------------------------------------
# the intent-driven cluster path
# ---------------------------------------------------------------------------

CLUSTER_ARCH = "minitron_4b"
CLUSTER_ENGINE = {"n_slots": 8, "s_max": 512, "page_size": 16}
PHI_INTENT = "Phi traffic must remain inside the pod."
# the paper's budgets: downtime and each migration pause under 50 ms, TTFT
# and TPOT within 10 % of a unified engine's. Printed beside the figures as
# `within` or `over` (the overhead also `unresolved`, see `_paired_overhead`);
# host time on the card's machine moves from call to call, so they do not
# fail the run.
PAUSE_BUDGET_S = 0.05
OVERHEAD_BUDGET = 0.10
# windows of each side, taken in turns, behind each overhead verdict
OVERHEAD_PAIRS = 3
# serving steps the cluster may take while PREPARE runs, before it waits for
# the warm-up: the requests to migrate must still be decoding after the swap
PREPARE_STEPS = 4
SSM_MIGRATE_SLOTS = 4
# Mamba2's migration runs at full width and half depth, to keep the whole
# run inside its time
SSM_MIGRATE_LAYERS = 24


def _watch_swaps(engine, log):
    """Wrap ``engine.swap_plan`` to log each swap: the engine, the decode
    executable it was handed and the engine's captures during the call."""
    swap = engine.swap_plan

    def watched(*args, **kw):
        before = engine.decode_stats["captures"]
        out = swap(*args, **kw)
        log.append({"engine": engine, "decode": (kw.get("executables") or {}).get("decode"),
                    "captures_in_window": engine.decode_stats["captures"] - before})
        return out

    engine.swap_plan = watched


def budget(value, limit):
    return "within" if value < limit else "over"


def _zeroed_launches(fn):
    """Run ``fn`` with the launch counters set to 0 just before it; return
    (its result, the counts just after it)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    return out, dict(ops.LAUNCHES)


def _overhead_lines(tag, m, base, card):
    """One window against one unified window: ratios, no verdict."""
    out = {}
    for key in ("ttft_mean_s", "tpot_mean_s"):
        ratio = m[key] / base[key] - 1.0
        out[key] = ratio
        say(f"[{tag}] {key[:4].upper()} mean {m[key] * 1e3:.2f} ms against the unified "
            f"engine's {base[key] * 1e3:.2f} ms: {100 * ratio:+.1f} %  [{card}]")
    return out


def _paired_overhead(tag, serve_unified, serve_other, card):
    """The paper's overhead budget from `OVERHEAD_PAIRS` pairs of windows,
    each a unified window then one of ``tag`` (``serve_*(k)`` serves the
    batch once and returns its metrics): each pair's TTFT and TPOT ratio,
    their median and range. ``within`` when every pair's ratio is under the
    budget, ``over`` when none is, else ``unresolved``: the host's speed
    moved across the budget between windows."""
    pairs = [(serve_unified(k), serve_other(k)) for k in range(OVERHEAD_PAIRS)]
    out = {}
    for key in ("ttft_mean_s", "tpot_mean_s"):
        base = [b[key] for b, _ in pairs]
        other = [o[key] for _, o in pairs]
        ratios = [o / b - 1.0 for b, o in zip(base, other)]
        lo, hi = min(ratios), max(ratios)
        verdict = ("within" if hi < OVERHEAD_BUDGET else
                   "over" if lo >= OVERHEAD_BUDGET else "unresolved")
        out[key] = {"unified_s": base, "other_s": other, "ratios": ratios,
                    "median": float(np.median(ratios)), "verdict": verdict}
        say(f"[{tag}] {key[:4].upper()} mean over {OVERHEAD_PAIRS} paired windows: unified "
            f"median {np.median(base) * 1e3:.2f} ms ({min(base) * 1e3:.2f}-{max(base) * 1e3:.2f}), "
            f"{tag} median {np.median(other) * 1e3:.2f} ms ({min(other) * 1e3:.2f}-"
            f"{max(other) * 1e3:.2f}); ratio median {100 * np.median(ratios):+.1f} % "
            f"({100 * lo:+.1f} % to {100 * hi:+.1f} %): {verdict} the "
            f"{100 * OVERHEAD_BUDGET:.0f} % budget  [{card}]")
    return out


def cluster_model(card):
    """Full-width Minitron-4B on the card (bf16, random weights from seed 0),
    which the cluster and scale phases share."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(CLUSTER_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    say(f"[cluster] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} query heads over {cfg.num_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.2f} B parameters ({cfg.param_dtype}), random from seed 0 "
        f"in {time.perf_counter() - t0:.1f} s; engines {CLUSTER_ENGINE}  [{card}]")
    return model


def phase_cluster(card, model):
    """The intent-driven cluster path on full-width Minitron-4B (bf16, random
    weights from seed 0; `cluster_model`), every engine paged with `CLUSTER_ENGINE`, the
    serve prompts with `SERVE_NEW_TOKENS` new tokens each:

    1. unified: one engine runs the batch twice; the streams agree and are
       the oracle (flash once per layer per prefill);
    2. cluster: ``edge0`` (phi) and ``edge1`` (general); four unlabeled
       requests, then four phi ones; the phi intent goes through the
       `Orchestrator` with ``async_reconfig`` while they decode, and its swap
       commits at a step boundary; two unlabeled decoding requests then
       migrate edge0 -> edge1. Streams equal the oracle, no route lands
       mid-swap, flash launches once per layer per prefill (PREPARE's warm
       prefills included) and never in the migration; then the batch runs
       again on the reconfigured pair, in turns with the unified engine
       (streams equal the oracle); with edge0 retired, a phi request is
       rejected;
    3. handoff: a prefill and a decode engine; every request hands off at
       its first token; streams equal the oracle; then the batch runs again
       on the pair, in turns with the unified engine.
    Then `phase_scale`, then `phase_ssm_migration`. Prints the swap's report and every pause
    with the paper's 50 ms budget, and the reconfigured pair's and the
    handoff pair's TTFT/TPOT against the unified engine with its 10 % budget
    over paired windows (`_paired_overhead`)."""
    import torch

    from repro_torch.core import Orchestrator
    from repro_torch.kernels import ops
    from repro_torch.obs import Recorder, recording
    from repro_torch.serving import (
        PrepareWorker,
        Request,
        RoutingError,
        ServingCluster,
        ServingEngine,
        compute_metrics,
    )

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPT_LENS]
    per_prefill = cfg.num_layers
    want_launches = lambda n: {k: n if k == "flash_attention" else 0  # noqa: E731
                               for k in ops.LAUNCHES}

    # -- 1. unified baseline (the oracle) -------------------------------------
    unified = ServingEngine(model, **CLUSTER_ENGINE)
    (reqs1, _), launches = _zeroed_launches(lambda: _serve_once(unified, prompts, Request))
    check(launches == want_launches(per_prefill * len(prompts)),
          f"unified run: launches {launches}, want {want_launches(per_prefill * len(prompts))}")
    reqs2, wall2 = _serve_once(unified, prompts, Request)
    oracle = {r.rid: r.tokens_out for r in reqs2}
    check({r.rid: r.tokens_out for r in reqs1} == oracle,
          "the unified engine's two runs gave other token streams")
    base = compute_metrics(reqs2)
    _check_graph_steps("[cluster] unified", unified)
    say(f"[cluster] unified: launches {launches}; two runs agree; warm TTFT mean "
        f"{base['ttft_mean_s'] * 1e3:.2f} ms, TPOT mean {base['tpot_mean_s'] * 1e3:.2f} ms  [{card}]")

    def serve_unified(k):
        """A unified window for `_paired_overhead`; streams held to the oracle."""
        got, _ = _serve_once(unified, prompts, Request)
        check({r.rid: r.tokens_out for r in got} == oracle,
              f"unified window {k}: streams differ from the oracle")
        return compute_metrics(got)

    def serve_cluster_window(cl, k, labelled):
        """The batch once more on cluster ``cl`` under fresh rids (half phi
        when ``labelled``); streams held to the oracle."""
        rid0 = 1000 * (k + 1)
        got = [Request(rid0 + i, p, max_new_tokens=SERVE_NEW_TOKENS,
                       labels={"data-type": "phi"} if labelled and i >= 4 else {})
               for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        for r in got:
            cl.submit(r)
        cl.run()
        torch.cuda.synchronize()
        check({r.rid - rid0: r.tokens_out for r in got} == oracle,
              f"cluster window {k}: streams differ from the oracle")
        return compute_metrics(got)

    # -- 2. the cluster: intent, swap, migration, fail-closed -----------------
    worker = PrepareWorker(max_workers=1)
    try:
        cluster = ServingCluster(prepare_worker=worker)
        cluster.register("edge0", ServingEngine(model, labels={"data-type": "phi"},
                                                **CLUSTER_ENGINE))
        cluster.register("edge1", ServingEngine(model, labels={"data-type": "general"},
                                                **CLUSTER_ENGINE))
        edge0, edge1 = cluster.engine("edge0"), cluster.engine("edge1")
        swaps = []
        for eng in (edge0, edge1):
            _watch_swaps(eng, swaps)
        reqs = [Request(i, p, max_new_tokens=SERVE_NEW_TOKENS,
                        labels={"data-type": "phi"} if i >= 4 else {})
                for i, p in enumerate(prompts)]
        state = {}

        def drive():
            torch.cuda.synchronize()
            state["placed"] = [cluster.submit(r) for r in reqs]
            for _ in range(2):
                cluster.step()
            state["warm_lengths"] = cluster.engine("edge0").recent_prompt_lengths()
            capture_s = edge0.decode_stats["capture_s"]
            res = Orchestrator().submit(PHI_INTENT, apply_to=cluster, async_reconfig=True)
            check(res.success and list(res.reports) == ["edge0"],
                  f"intent: success={res.success}, reconfigured {list(res.reports)}")
            ticket = res.reports["edge0"]
            served = 0
            while not ticket.done() and served < PREPARE_STEPS:
                served += 1
                cluster.step()                  # serving continues through PREPARE
            check(ticket.wait_ready(600.0), f"PREPARE did not finish: {ticket!r}")
            state["prepare_capture_s"] = edge0.decode_stats["capture_s"] - capture_s
            while not ticket.done():
                cluster.step()                  # the swap commits at this boundary
            state["report"] = ticket.result()
            check(len(swaps) == 1 and swaps[0]["engine"] is edge0
                  and swaps[0]["decode"] is not None
                  and edge0.decode_executable is swaps[0]["decode"]
                  and swaps[0]["captures_in_window"] == 0,
                  f"the swap did not install PREPARE's decode graph, or captured: {swaps}")
            state["steps_in_prepare"] = served
            movable = [r.rid for r in cluster.engine("edge0").slot_req
                       if r is not None and not r.labels]
            check(len(movable) >= 2, f"edge0 holds {movable} unlabeled decoding requests")
            before = dict(ops.LAUNCHES)
            state["records"] = cluster.migrate_requests("edge0", "edge1", movable[:2])
            check(ops.LAUNCHES == before, f"the migration launched kernels: "
                                          f"{before} -> {ops.LAUNCHES}")
            cluster.run()
            torch.cuda.synchronize()

        _, launches = _zeroed_launches(drive)
        report, records = state["report"], state["records"]
        n_prefill = len(prompts) + report.compiled_in_prepare - 1
        check(launches == want_launches(per_prefill * n_prefill),
              f"cluster run: launches {launches}, want {want_launches(per_prefill * n_prefill)} "
              f"({len(prompts)} request prefills + {report.compiled_in_prepare - 1} warmed)")
        check(state["placed"] == ["edge0", "edge1", "edge0", "edge1"] + ["edge0"] * 4,
              f"routing: {state['placed']}")
        check({r.rid: r.tokens_out for r in reqs} == oracle,
              "the cluster's streams differ from the unified engine's")
        check(cluster.midswap_routes == 0, f"midswap_routes={cluster.midswap_routes}")
        check(all(m.phase == "decoding" and m.batch == 2 and m.bytes_moved > 0
                  for m in records), f"migration records {records}")
        check("pod" in cluster.engine("edge0").plan.forbidden_collective_axes,
              "edge0 is not on the pinned plan")
        check(edge0.decode_stats["installs"] == 1 and edge0.decode_stats["captures"] == 2,
              f"edge0 {edge0.decode_stats}: one capture at its first step, one in PREPARE")
        # serving after the swap: the batch again on the reconfigured pair,
        # in turns with the unified engine
        over_c = _paired_overhead(
            "cluster", serve_unified,
            lambda k: serve_cluster_window(cluster, k, labelled=True), card)
        graphs = {}
        for name, eng in (("unified", unified), ("edge0", edge0), ("edge1", edge1)):
            _check_graph_steps(f"[cluster] {name}", eng)
            check(eng.decode_stats["discards"] == 0, f"{name} discarded a graph")
            graphs[name] = _graph_line("[cluster]", name, eng, card)
        check(len(swaps) == 1, f"swaps {swaps}")
        say(f"[cluster] the swap installed PREPARE's decode graph (captured in "
            f"{state['prepare_capture_s']:.4f} s on the PREPARE thread beside serving); "
            f"captures inside the swap window 0; graphs discarded 0  [{card}]")
        phi = Request(100, prompts[0], max_new_tokens=2, labels={"data-type": "phi"})
        check(cluster.eligible(phi) == ["edge0"], f"phi eligible on {cluster.eligible(phi)}")
        cluster.retire_engine("edge0")
        try:
            cluster.submit(phi)
            rejected = False
        except RoutingError:
            rejected = True
        check(rejected and cluster.rejected[-1].rid == 100,
              "a phi request was served with its only compliant engine retired")
        m_cluster = compute_metrics(reqs)
        check(report.metrics_after["completed"] >= 4,
              f"the swap report's post-swap window holds {report.metrics_after['completed']} "
              "completions; the four phi requests finish on edge0 after the swap")
        say(f"[cluster] routing {state['placed']}; launches {launches} "
            f"({len(prompts)} request prefills + {report.compiled_in_prepare - 1} warmed, "
            f"{per_prefill} each; none in the migration); streams equal the unified run's; "
            f"midswap_routes 0; phi rejected with edge0 retired (fail-closed)")
        say(f"[cluster] swap: {report.summary()}; prepare_s {report.prepare_s:.4f}, "
            f"downtime_s {report.downtime_s:.6f} ({budget(report.downtime_s, PAUSE_BUDGET_S)} "
            f"the 50 ms budget), compiled_in_prepare {report.compiled_in_prepare}, "
            f"migrate_bytes {report.migrate_bytes}; {state['steps_in_prepare']} steps served "
            f"during PREPARE  [{card}]")
        for m in records:
            say(f"[cluster] migration rid {m.rid} {m.src}->{m.dst}: pause_s {m.pause_s:.6f} "
                f"({budget(m.pause_s, PAUSE_BUDGET_S)} the 50 ms budget), "
                f"{m.bytes_moved} bytes, batch {m.batch}  [{card}]")
        say(f"[cluster] the run through the intent (PREPARE beside serving, swap, "
            f"migration) against the unified engine's warm run; one window, informational:")
        _overhead_lines("cluster run", m_cluster, base, card)
        check(report.compiled_in_prepare == 1 + len(state["warm_lengths"]),
              f"PREPARE warmed {report.compiled_in_prepare - 1} prompt lengths, "
              f"not {state['warm_lengths']}")
    finally:
        worker.shutdown()

    # -- 3. first-token handoff ------------------------------------------------
    with recording(Recorder()) as rec:
        cluster = ServingCluster()
        cluster.register("pf", ServingEngine(model, **CLUSTER_ENGINE), role="prefill")
        cluster.register("dc", ServingEngine(model, **CLUSTER_ENGINE), role="decode")
        hreqs = [Request(i, p, max_new_tokens=SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]

        def drive_handoff():
            torch.cuda.synchronize()
            for r in hreqs:
                cluster.submit(r)
            cluster.run()
            torch.cuda.synchronize()

        _, h_launches = _zeroed_launches(drive_handoff)
    pauses = rec.events("migration.pause")
    cohorts = rec.events("cluster.handoff")
    dc = cluster.engine("dc")
    _check_graph_steps("[handoff] dc", dc)
    check(h_launches == want_launches(per_prefill * len(prompts)),
          f"handoff run: launches {h_launches}")
    check({r.rid: r.tokens_out for r in hreqs} == oracle,
          "the handed-off streams differ from the unified engine's")
    check(len(pauses) == len(prompts) and all(e.data["reason"] == "handoff" for e in pauses),
          f"{len(pauses)} handoff pauses recorded")
    check(cluster.metrics_by_label()["role:decode"]["completed"] == len(prompts),
          "not every request completed on the decode engine")
    m_handoff = compute_metrics(hreqs)
    hp = [e.data["pause_s"] for e in pauses]
    say(f"[handoff] {len(cohorts)} cohort(s) moved {sum(c.data['moved'] for c in cohorts)} "
        f"requests at their first token; launches {h_launches}; streams equal the "
        f"unified run's; pauses " + ", ".join(f"{p:.6f}" for p in hp)
        + f" s, max {max(hp):.6f} ({budget(max(hp), PAUSE_BUDGET_S)} the 50 ms budget), "
        f"{sum(e.data['bytes_moved'] for e in pauses)} bytes  [{card}]")
    over_h = _paired_overhead(
        "handoff", serve_unified,
        lambda k: serve_cluster_window(cluster, k, labelled=False), card)
    for name in ("pf", "dc"):
        eng = cluster.engine(name)
        if eng.steps:
            _check_graph_steps(f"[handoff] {name}", eng)
        graphs[f"handoff {name}"] = _graph_line("[handoff]", name, eng, card)
    del cluster, unified
    free_device()
    return {"unified": base, "cluster_run": m_cluster,
            "handoff": m_handoff, "report_metrics_after": report.metrics_after,
            "overhead": {"cluster": over_c, "handoff": over_h},
            "launches": {"cluster": launches, "handoff": h_launches},
            "report": {"prepare_s": report.prepare_s, "downtime_s": report.downtime_s,
                       "compiled_in_prepare": report.compiled_in_prepare,
                       "migrate_bytes": report.migrate_bytes, "summary": report.summary()},
            "migrations": [{"rid": m.rid, "pause_s": m.pause_s, "bytes": m.bytes_moved,
                            "batch": m.batch} for m in records],
            "handoff_pauses_s": hp, "steps_in_prepare": state["steps_in_prepare"],
            "graphs": graphs, "prepare_capture_s": state["prepare_capture_s"]}


# ---------------------------------------------------------------------------
# the elastic control loop
# ---------------------------------------------------------------------------

SCALE_LABELS = ("phi", "general")
# the trace: 2 req/s over both labels for 24 logical seconds, a 4x flash
# crowd on phi in [6, 14), prompts from the serve lengths, 12 new tokens on
# average (capped at 16); seed 0
SCALE_SECONDS = 24
SCALE_RATE = 2.0
SCALE_CROWD = {"t_start": 6.0, "duration_s": 8.0, "multiplier": 4.0, "label": "phi"}
SCALE_NEW_MEAN, SCALE_NEW_CAP = 12.0, 16
# one logical second is one tick, taken after that second's arrivals are
# submitted and SCALE_STEPS cluster steps: 8 lanes x 4 steps serve about
# 32 / 12 = 2.7 requests of phi a tick, above its 1 req/s outside the crowd
# and below its 4 req/s inside it
SCALE_STEPS = 4
# at most this many quiet ticks after the trace, for the drain and the
# scale-down
SCALE_TAIL = 12
# threshold mode: a hot label holds more than 4 requests (queued + resident,
# EWMA) per engine for 2 ticks (phi's EWMA stays under 2.4 before the crowd
# and passes 4 in its second second); a cold one sees <= 0.25 arrivals and
# <= 0.5 requests a tick for 2 ticks; 2 ticks of cooldown after an action
SCALE_POLICY = {"spawn_depth": 4.0, "retire_rate": 0.25, "retire_depth": 0.5,
                "sustain": 2, "cooldown": 2}
SCALE_INTENTS = ("Phi traffic must remain inside the pod, and keep between one and "
                 "three engines for phi traffic.",
                 "Keep at least one engine for general traffic.")
SCALE_SLO_INTENT = "Keep TTFT under 2 seconds for phi traffic."
SCALE_TTFT_TARGET_S = 2.0      # what SCALE_SLO_INTENT compiles to


def held_bytes():
    """`torch.cuda.memory_allocated` with cuBLAS's workspaces left out, read
    where nothing runs: cuBLAS keeps one per (thread's handle, stream) for
    the process (made anew at next use), and a run's first spawn is the
    first cuBLAS work of its PREPARE worker thread. torch's own leak check
    does the same. Returns (held, allocated before the workspaces went, the
    held blocks counted by (size, memory pool))."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    blocks = {}
    for seg in torch.cuda.memory_snapshot():
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                key = (b["size"], str(tuple(seg.get("segment_pool_id", ()))))
                blocks[key] = blocks.get(key, 0) + 1
    return torch.cuda.memory_allocated(), raw, blocks


def _scale_trace(vocab):
    """The scale phase's trace (`generate_trace`) and a prompt per request
    (token ids from seed 0)."""
    from repro_torch.traffic import FlashCrowd, LabelProfile, TrafficPattern, generate_trace

    profile = LabelProfile(prompt_buckets=SERVE_PROMPT_LENS, new_tokens_mean=SCALE_NEW_MEAN,
                           new_tokens_cap=SCALE_NEW_CAP)
    trace = generate_trace(TrafficPattern(
        duration_s=float(SCALE_SECONDS), base_rate=SCALE_RATE,
        labels={v: profile for v in SCALE_LABELS},
        flash_crowds=(FlashCrowd(**SCALE_CROWD),), seed=0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=r.prompt_len).astype(np.int32) for r in trace]
    return trace, prompts


def _scale_run(mode, model, trace, prompts, card, profile=None):
    """One run of the trace on a fresh cluster (``edge-phi``, ``edge-gen``)
    under an `Autoscaler` in ``mode`` ("threshold": `ElasticPolicy`;
    "planner": a `WorkloadPlanner` over the calibrated ``profile``), spawns
    through `spawn_engine_async`. Checks what the phase checks and returns
    the run's record."""
    import torch

    from repro_torch.core import Orchestrator
    from repro_torch.kernels import ops
    from repro_torch.planner import EngineSpec, LabelDemand, ResidualCalibration, \
        WorkloadPlanner, estimate
    from repro_torch.serving import (
        METRIC_KEYS,
        Autoscaler,
        ElasticPolicy,
        PrepareWorker,
        Request,
        ServingCluster,
        ServingEngine,
        compute_metrics,
    )
    from repro_torch.sharding import default_plan

    tag = f"[scale {mode}]"
    worker = PrepareWorker(max_workers=1)
    try:
        cluster = ServingCluster(prepare_worker=worker)
        for name, label in (("edge-phi", "phi"), ("edge-gen", "general")):
            cluster.register(name, ServingEngine(model, labels={"data-type": label},
                                                 **CLUSTER_ENGINE))
        page_bytes = sum(v.numel() * v.element_size() for v in
                         cluster.engine("edge-phi").cache.values()) \
            // cluster.engine("edge-phi").pool.store_batch
        factory = lambda label: ServingEngine(model, **CLUSTER_ENGINE)  # noqa: E731
        planner = None
        if mode == "planner":
            spec = EngineSpec(plan=default_plan(), n_slots=CLUSTER_ENGINE["n_slots"],
                              s_max=CLUSTER_ENGINE["s_max"])
            planner = WorkloadPlanner(
                cluster, lambda s, label: ServingEngine(model, n_slots=s.n_slots,
                                                        s_max=s.s_max, page_size=16),
                specs=[spec], profiles=[profile], new_tokens=SCALE_NEW_MEAN,
                max_engines_per_label=3)
            feats = planner.features_for(spec)
            est = estimate(feats, profile)
            # one tick is SCALE_STEPS decode steps: in the estimator's time,
            # SCALE_STEPS of its predicted step
            planner.tick_s = SCALE_STEPS * est.step_s
            scaler = Autoscaler(cluster, factory, planner=planner, async_spawn=True)
        else:
            scaler = Autoscaler(cluster, factory, policy=ElasticPolicy(**SCALE_POLICY),
                                async_spawn=True)
        reqs = [Request(r.rid, p, max_new_tokens=r.new_tokens,
                        labels={"data-type": r.label}) for r, p in zip(trace, prompts)]
        by_tick = {}
        for r, req in zip(trace, reqs):
            by_tick.setdefault(int(r.t), []).append(req)
        log = {"ticks": [], "drain_s": {}, "retire_mode": {}, "stats": {}, "mem": None}
        calib, windows = ResidualCalibration(), []

        def drive():
            torch.cuda.synchronize()
            for text in SCALE_INTENTS + ((SCALE_SLO_INTENT,) if planner else ()):
                res = Orchestrator().submit(text, apply_to=scaler)
                check(res.success, f"{tag} intent {text!r}: {res.report.summary()}")
            if planner is not None:
                check(planner.slo_targets.get("phi", (None,))[0] == SCALE_TTFT_TARGET_S,
                      f"{tag} SLO targets {planner.slo_targets}")
            check(scaler.bounds.get("phi") == (1, 3) and scaler.bounds.get("general")
                  == (1, None), f"{tag} bounds {scaler.bounds}")
            draining_since = {}

            def sample():
                now = time.perf_counter()
                for name in cluster.engines():
                    log["stats"][name] = cluster.engine(name).decode_stats
                for name in [n for n in draining_since if n not in cluster.engines()]:
                    log["drain_s"][name] = now - draining_since.pop(name)

            for tick in range(SCALE_SECONDS + SCALE_TAIL):
                t0, t0_wall = time.perf_counter(), time.time()
                if tick < SCALE_SECONDS:
                    for req in by_tick.get(tick, []):
                        draining = set(cluster.draining())
                        name = cluster.submit(req)
                        check(name not in draining,
                              f"{tag} rid {req.rid} routed to draining {name}")
                    for _ in range(SCALE_STEPS):
                        cluster.step()
                        sample()
                else:
                    # the quiet tail: serve out the queues and let spawns
                    # still in PREPARE commit (a PREPARE outlasts many ticks
                    # of an idle cluster), then tick, until scaled back
                    cluster.run(wait_pending=True)
                    sample()
                    if not cluster.draining() and not scaler.pending_spawns() and all(
                            len(cluster.engines_for_label(v)) == 1 for v in SCALE_LABELS):
                        break
                if not any(d.kind == "spawn" for t in log["ticks"] for d in t["decisions"]):
                    log["mem"] = held_bytes()         # before the first spawn
                decisions = scaler.tick(dt=1.0)
                now = time.perf_counter()
                for d in decisions:
                    if d.kind != "retire":
                        continue
                    log["retire_mode"][d.engine] = d.mode
                    if d.engine in cluster.engines():
                        draining_since[d.engine] = now
                    else:
                        log["drain_s"][d.engine] = 0.0   # idle, or migrated: reaped at once
                sample()
                log["ticks"].append({
                    "t": tick, "wall_s": now - t0, "decisions": decisions,
                    "engines": {v: len(cluster.engines_for_label(v)) for v in SCALE_LABELS},
                    "total": len(cluster.engines())})
                if planner is not None:
                    done = [r for r in reqs if r.t_done >= t0_wall
                            and r.labels["data-type"] == "phi"]
                    pred = planner.predicted_for("phi", LabelDemand(rate=0.0), calibrated=False)
                    if done and pred is not None:
                        m = compute_metrics(done)
                        calib.observe("phi", predicted_ttft_s=pred.ttft_s,
                                      predicted_tpot_s=pred.tpot_s,
                                      measured_ttft_s=m["ttft_mean_s"],
                                      measured_tpot_s=m["tpot_mean_s"])
                        windows.append(m["tpot_mean_s"])
            cluster.run(wait_pending=True)
            torch.cuda.synchronize()

        ops.reset_launches()
        t_run = time.perf_counter()
        drive()
        wall = time.perf_counter() - t_run
        launches = dict(ops.LAUNCHES)
        mem_end = held_bytes()
        history = list(cluster.history)
        pred = (planner.predicted_for("phi", LabelDemand(rate=0.0), calibrated=False)
                if planner is not None else None)
        # the end of the run retires every engine: a report stays open until
        # its engine serves after the event or retires, and a spawn that
        # joined after the traffic ended has served nothing
        late = cluster.pending_reports()
        for name in cluster.engines():
            cluster.retire_engine(name)
        cluster.run()

        ticks = log["ticks"]
        kinds = [(t["t"], d.kind) for t in ticks for d in t["decisions"]]
        traj = " ".join(f"{t['t']}:{t['engines']['phi']}/{t['engines']['general']}"
                        for t in ticks)
        say(f"{tag} {len(reqs)} requests over {len(ticks)} ticks ({SCALE_STEPS} steps each) in "
            f"{wall:.2f} s; engines phi/general per tick: {traj}  [{card}]")
        for t in ticks:
            for d in t["decisions"]:
                say(f"{tag} tick {t['t']}: {d.kind} {d.label} {d.engine or ''} ({d.reason})")

        # -- checks -----------------------------------------------------------
        crowd_end = SCALE_CROWD["t_start"] + SCALE_CROWD["duration_s"]
        check(any(k == "spawn" and SCALE_CROWD["t_start"] <= t < crowd_end for t, k in kinds),
              f"{tag} no spawn during the burst: {kinds}")
        check(any(k == "retire" and t >= crowd_end for t, k in kinds),
              f"{tag} no retire after the burst: {kinds}")
        check(scaler.failures == [], f"{tag} failed spawns {scaler.failures}")
        check(all(r.t_done > 0 for r in reqs),
              f"{tag} {sum(r.t_done == 0 for r in reqs)} requests did not complete")
        check(cluster.engines() == [] and cluster.pending_reports() == []
              and all(set(r.metrics_after) == set(METRIC_KEYS) for r in cluster.history),
              f"{tag} reports pending {cluster.pending_reports()} after every engine retired")
        spawns = [r for r in history if r.event == "spawn"]
        check(len(spawns) == sum(k == "spawn" for _, k in kinds),
              f"{tag} {len(spawns)} spawns committed of {kinds}")
        for r in spawns:
            st = log["stats"][r.engine]
            check(st["installs"] == 1 and st["captures"] == 1 and st["discards"] == 0,
                  f"{tag} {r.engine} {st}: the swap must install PREPARE's graph")
        n_prefill = len(reqs) + sum(max(r.compiled_in_prepare - 1, 0) for r in history)
        want = {k: model.cfg.num_layers * n_prefill if k == "flash_attention" else 0
                for k in ops.LAUNCHES}
        check(launches == want, f"{tag} launches {launches}, want {want} ({len(reqs)} requests "
              f"+ {n_prefill - len(reqs)} warmed prefills)")
        mem_delta = mem_end[0] - log["mem"][0]
        check(abs(mem_delta) <= page_bytes,
              f"{tag} memory held {mem_end} after the last retire, {log['mem']} before the "
              f"first spawn (without, with cuBLAS's workspaces): {mem_delta:+d} bytes, more "
              f"than a page ({page_bytes})")

        # -- results (printed, not checked) -------------------------------------
        say(f"{tag} reports still open after the scale-down, closed by the final retire of "
            f"every engine: {late or 'none'}")
        for r in history:
            if r.event == "spawn":
                say(f"{tag} spawn {r.engine}: prepare_s {r.prepare_s:.4f} beside serving, "
                    f"capture {log['stats'][r.engine]['capture_s']:.4f} s, downtime_s "
                    f"{r.downtime_s:.6f} ({budget(r.downtime_s, PAUSE_BUDGET_S)} the 50 ms "
                    f"budget), {r.compiled_in_prepare - 1} prefills warmed  [{card}]")
            elif r.event == "retire":
                say(f"{tag} retire {r.engine} ({log['retire_mode'].get(r.engine)} mode): gone "
                    f"{log['drain_s'].get(r.engine, float('nan')):.4f} s after the decision, "
                    f"downtime_s {r.downtime_s:.6f}, {len(r.migrations)} requests migrated  "
                    f"[{card}]")
        out = {"wall_s": wall, "launches": launches, "ticks": len(ticks),
               "trajectory": [t["engines"] for t in ticks],
               "events": [(t, k) for t, k in kinds],
               "spawns": [{"engine": r.engine, "prepare_s": r.prepare_s,
                           "capture_s": log["stats"][r.engine]["capture_s"],
                           "downtime_s": r.downtime_s} for r in spawns],
               "drain_s": log["drain_s"], "mem_delta": mem_delta,
               "mem_workspaces": [log["mem"][1] - log["mem"][0], mem_end[1] - mem_end[0]],
               "page_bytes": page_bytes, "by_label": {}}
        for v in SCALE_LABELS:
            m = compute_metrics([r for r in reqs if r.labels["data-type"] == v])
            out["by_label"][v] = m
            say(f"{tag} {v}: {m['completed']} requests, TTFT mean {m['ttft_mean_s'] * 1e3:.1f} "
                f"ms (p99 {m['ttft_p99_s'] * 1e3:.1f}), TPOT mean {m['tpot_mean_s'] * 1e3:.2f} ms "
                f"(p99 {m['tpot_p99_s'] * 1e3:.2f})  [{card}]")
        phi = [r for r in reqs if r.labels["data-type"] == "phi"]
        out["slo_attainment"] = sum(r.ttft <= SCALE_TTFT_TARGET_S for r in phi) / len(phi)
        out["engine_ticks"] = sum(t["total"] for t in ticks)
        out["engine_s"] = sum(t["total"] * t["wall_s"] for t in ticks)
        say(f"{tag} phi TTFT <= {SCALE_TTFT_TARGET_S:g} s for {100 * out['slo_attainment']:.1f} % "
            f"of requests; {out['engine_ticks']} engine-ticks (logical seconds), "
            f"{out['engine_s']:.2f} engine-seconds of wall time; launches {launches}; memory "
            f"held after the last retire {mem_delta:+d} bytes against before the first spawn "
            f"(a page is {page_bytes}; cuBLAS's workspaces {out['mem_workspaces']} bytes then "
            f"and there, not counted)  [{card}]")
        gone = {k: v for k, v in log["mem"][2].items() if mem_end[2].get(k, 0) < v}
        new = {k: v for k, v in mem_end[2].items() if log["mem"][2].get(k, 0) < v}
        if gone or new:
            say(f"{tag} held blocks by (size, pool), counts before the first spawn and not "
                f"after: {gone}; after the last retire and not before: {new}  [{card}]")
        if planner is not None:
            cal = calib.apply("phi", pred)
            out["tpot_pred"] = {"analytical_s": pred.tpot_s, "calibrated_s": cal.tpot_s,
                                "measured_s": out["by_label"]["phi"]["tpot_mean_s"],
                                "windows": len(windows), "factors": calib.factors("phi")}
            say(f"{tag} planner TPOT for phi: predicted {pred.tpot_s * 1e3:.3f} ms by the "
                f"roofline ({est.bottleneck}-bound, features {feats.flops:.4g} FLOPs, "
                f"{feats.bytes:.4g} B a step), {cal.tpot_s * 1e3:.3f} ms after "
                f"ResidualCalibration folded {len(windows)} tick windows (factor "
                f"{calib.factors('phi')[1]:.2f}); measured {out['tpot_pred']['measured_s'] * 1e3:.3f}"
                f" ms; tick_s {planner.tick_s:.6f}  [{card}]")
        return out, reqs
    finally:
        worker.shutdown()


def phase_scale(card, model):
    """The elastic control loop on full-width Minitron-4B (`cluster_model`),
    every engine paged with `CLUSTER_ENGINE`: the calibrated profile of the
    card and the decode step's features; a unified engine serves every
    prompt of the trace (`_scale_trace`) with its budget (the oracle); then
    the trace runs twice on a fresh cluster, once under the threshold policy
    and once under the planner (`_scale_run`). In both runs every stream
    equals the oracle's, a spawn comes during the burst and a retire after
    it, every report is finalized, no request lands on a draining engine,
    flash launches once per layer per prefill (PREPARE's warm prefills
    included), and memory is back within one page after the last retire."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.planner import calibrate_host_profile, features_from_engine
    from repro_torch.serving import Request, ServingEngine, compute_metrics

    prof = calibrate_host_profile()
    say(f"[scale] calibrated profile {prof.name}: {prof.peak_flops / 1e12:.2f} TFLOP/s "
        f"(fp32 matmul, d=384), {prof.hbm_bw / 1e9:.1f} GB/s (x + 1 over 32 MiB), "
        f"{prof.mem_bytes / 1e9:.2f} GB  [{card}]")
    trace, prompts = _scale_trace(model.cfg.vocab_size)
    oracle_engine = ServingEngine(model, **CLUSTER_ENGINE)
    feats = features_from_engine(oracle_engine)
    say(f"[scale] decode-step features of {CLUSTER_ENGINE}: {feats.flops:.6g} FLOPs, "
        f"{feats.bytes:.6g} bytes, params {feats.param_bytes} B, KV pool {feats.kv_bytes} B, "
        f"kv_tokens {feats.kv_tokens}, wire {feats.wire_bytes:g} B  [{card}]")
    oracle_reqs = [Request(r.rid, p, max_new_tokens=r.new_tokens)
                   for r, p in zip(trace, prompts)]
    ops.reset_launches()
    torch.cuda.synchronize()
    for r in oracle_reqs:
        oracle_engine.submit(r)
    oracle_engine.run()
    torch.cuda.synchronize()
    check(ops.LAUNCHES["flash_attention"] == model.cfg.num_layers * len(trace),
          f"[scale] oracle launches {dict(ops.LAUNCHES)}")
    oracle = {r.rid: r.tokens_out for r in oracle_reqs}
    m = compute_metrics(oracle_reqs)
    n_phi = sum(r.label == "phi" for r in trace)
    say(f"[scale] trace: {len(trace)} requests ({n_phi} phi, {len(trace) - n_phi} general) "
        f"over {SCALE_SECONDS} s, flash crowd {SCALE_CROWD}; the unified oracle served them "
        f"all (TTFT mean {m['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
        f"{m['tpot_mean_s'] * 1e3:.2f} ms, all queued at once)  [{card}]")
    del oracle_engine
    free_device()
    out = {"profile": {"peak_flops": prof.peak_flops, "hbm_bw": prof.hbm_bw,
                       "mem_bytes": prof.mem_bytes},
           "features": {"flops": feats.flops, "bytes": feats.bytes,
                        "param_bytes": feats.param_bytes, "kv_bytes": feats.kv_bytes},
           "requests": len(trace)}
    for mode in ("threshold", "planner"):
        out[mode], reqs = _scale_run(mode, model, trace, prompts, card, profile=prof)
        check({r.rid: r.tokens_out for r in reqs} == oracle,
              f"[scale {mode}] streams differ from the oracle's")
        say(f"[scale {mode}] every stream equals the unified oracle's")
        free_device()
    return out, oracle


# the replay phase: `_scale_trace`'s trace through `replay_trace` on a
# FakeClock. One simulated decode step is 20 ms: the unified Minitron-4B
# engine's warm TPOT on the H100 with the decode graph was 20.20-20.88 ms
# (PERF.md). A constant, never measured inside the run, so the replay stays
# deterministic.
REPLAY_STEP_TIME_S = 0.020
REPLAY_BOUNDS = (1, 4)
REPLAY_TICK = 1e-6
REPLAY_CONSERVATION_TOL = 1e-9


def _replay_run(model, trace, profile, record, bundle_dir):
    """One replay of ``trace`` (`replay_trace`, prompt draws from seed 0, as
    `_scale_trace` draws them) on a fresh stack, the stack `recorded_replay`
    builds over `CLUSTER_ENGINE` engines: a `WorkloadPlanner` over the
    card's ``profile`` with `ResidualCalibration(alpha=0.3)`, bounds
    `REPLAY_BOUNDS` for phi and general, SLO targets 50x and 2x the step
    time, sync spawns, windows of 4 ticks; with ``record``, the flight
    recorder and an `AlertEvaluator` wired to the planner and the scaler.
    Returns the run's record."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import AlertEvaluator, Recorder, recording
    from repro_torch.planner import EngineSpec, ResidualCalibration, WorkloadPlanner
    from repro_torch.serving import Autoscaler, FakeClock, LoadTracker, ServingCluster, \
        ServingEngine, install_clock
    from repro_torch.sharding import default_plan
    from repro_torch.traffic import replay_trace

    spec = EngineSpec(plan=default_plan(), n_slots=CLUSTER_ENGINE["n_slots"],
                      s_max=CLUSTER_ENGINE["s_max"])
    factory = lambda s, label: ServingEngine(model, **CLUSTER_ENGINE)  # noqa: E731
    rec = Recorder() if record else None
    clock = FakeClock(tick=REPLAY_TICK)
    restore = install_clock(clock)
    try:
        with recording(rec) if record else contextlib.nullcontext():
            cluster = ServingCluster()
            planner = WorkloadPlanner(cluster, factory, specs=[spec], profiles=[profile],
                                      dwell=0, calibration=ResidualCalibration(alpha=0.3),
                                      clock=clock)
            for label in SCALE_LABELS:
                planner.bounds[label] = REPLAY_BOUNDS
                planner.set_slo_target(label, 50 * REPLAY_STEP_TIME_S, 2 * REPLAY_STEP_TIME_S)
            scaler = Autoscaler(cluster, lambda label: factory(spec, label), planner=planner,
                                tracker=LoadTracker(alpha=0.5), async_spawn=False, clock=clock)
            planner.execute(planner.plan({}), async_spawn=False)       # the floors
            planner.attach_calibrated_profiles()
            evaluator = (AlertEvaluator(rec, policy=planner, calibration=planner.calibration,
                                        planner=planner, scaler=scaler, bundle_dir=bundle_dir)
                         if record else None)
            done, ticks = [], []
            drain, tick = cluster.drain_completed, scaler.tick

            def drain_kept():
                out = drain()
                done.extend(out)
                return out

            def tick_kept(dt=1.0):
                out = tick(dt)
                ticks.append([(d.kind, d.label, d.engine, d.mode) for d in out])
                return out

            cluster.drain_completed, scaler.tick = drain_kept, tick_kept
            n_history = len(cluster.history)
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            stats = replay_trace(trace, cluster, scaler, clock, vocab_size=model.cfg.vocab_size,
                                 step_time_s=REPLAY_STEP_TIME_S, tick_s=1.0, window_ticks=4,
                                 seed=0, alert_evaluator=evaluator)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            history = list(cluster.history)
            graphs = {n: dict(cluster.engine(n).decode_stats) for n in cluster.engines()}
            trajectory = list(scaler.trajectory)
            # close the run: retire every engine (a report stays open until
            # its engine serves after the event or retires)
            for name in cluster.engines():
                cluster.retire_engine(name)
            cluster.run()
            closed = cluster.engines() == [] and cluster.pending_reports() == []
    finally:
        restore()
    return {"stats": stats, "rec": rec, "planner": planner, "scaler": scaler,
            "evaluator": evaluator, "done": done, "ticks": ticks, "wall_s": wall,
            "launches": launches, "history": history, "replay_history": history[n_history:],
            "graphs": graphs, "trajectory": trajectory, "closed": closed,
            "closed_history": list(cluster.history)}


def phase_replay(card, model, oracle):
    """The discrete-event replay (`repro_torch.traffic.replay_trace`) of the
    elastic loop on full-width Minitron-4B (`cluster_model`) on a simulated
    clock, with the rest of observability: the scale phase's trace runs
    twice on fresh stacks (`_replay_run`), recorded with the Watchtower
    evaluator and with recording off. The two `ReplayStats` and their
    decisions per tick are equal; nothing is dropped and every request
    completes with the oracle's stream; every report is finalized; flash
    launches once per layer per prefill (PREPARE's warm prefills included);
    the lineage conserves TTFT and TPOT within 1e-9; the SLO ledger's
    attainment is the replay's; the recorder dropped nothing; the Chrome
    export with the lineage's flows validates; every debug bundle (each
    alert's and one at the end) round-trips; memory is back within one page.
    Prints the run's figures and the recorder's cost in wall time."""
    import dataclasses
    import tempfile

    from repro_torch.obs import (
        Alert,
        RequestLineage,
        SLOLedger,
        load_bundle,
        replay_ledger,
        validate_chrome,
    )
    from repro_torch.planner import calibrate_host_profile
    from repro_torch.serving import METRIC_KEYS, ServingEngine

    tag = "[replay]"
    profile = calibrate_host_profile()          # cached: the scale phase's, before any clock
    trace, _ = _scale_trace(model.cfg.vocab_size)
    probe = ServingEngine(model, **CLUSTER_ENGINE)
    page_bytes = sum(v.numel() * v.element_size() for v in probe.cache.values()) \
        // probe.pool.store_batch
    del probe
    free_device()
    mem0 = held_bytes()
    OUT.mkdir(exist_ok=True)
    bundles_tmp = tempfile.TemporaryDirectory(prefix="replay-bundles-")
    bundle_dir = bundles_tmp.name
    runs = {}
    for mode in ("recorded", "unrecorded"):
        runs[mode] = run = _replay_run(model, trace, profile, mode == "recorded", bundle_dir)
        stats = run["stats"]
        check(stats.dropped == 0 and stats.completed == stats.submitted == len(trace),
              f"{tag} {mode}: submitted {stats.submitted}, completed {stats.completed}, "
              f"dropped {stats.dropped} of {len(trace)}")
        check(stats.reports_finalized, f"{tag} {mode}: a report is not finalized at the end "
              f"of the replay: {[(r.event, r.engine) for r in run['history']]}")
        check(run["closed"] and all(set(r.metrics_after) == set(METRIC_KEYS)
                                    for r in run["closed_history"]),
              f"{tag} {mode}: reports pending after every engine retired")
        check({r.rid: r.tokens_out for r in run["done"]} == oracle,
              f"{tag} {mode}: streams differ from the unified oracle's")
        n_prefill = len(trace) + sum(max(r.compiled_in_prepare - 1, 0)
                                     for r in run["replay_history"])
        want = {k: model.cfg.num_layers * n_prefill if k == "flash_attention" else 0
                for k in run["launches"]}
        check(run["launches"] == want, f"{tag} {mode}: launches {run['launches']}, want "
              f"{want} ({len(trace)} requests + {n_prefill - len(trace)} warmed prefills)")
        for name, st in run["graphs"].items():
            check(st["eager"] <= 1 and st["discards"] == 0,
                  f"{tag} {mode}: {name} decode {st}: every step after the first replays")
        free_device()
    rec_run, off_run = runs.pop("recorded"), runs.pop("unrecorded")
    a, b = rec_run["stats"], off_run["stats"]
    check(dataclasses.asdict(a) == dataclasses.asdict(b),
          f"{tag} the recorded and the unrecorded ReplayStats differ")
    check(rec_run["ticks"] == off_run["ticks"],
          f"{tag} decisions per tick differ between the recorded and the unrecorded run")
    rec, evaluator = rec_run["rec"], rec_run["evaluator"]
    check(rec.bus.dropped == 0 and rec.trace.dropped == 0,
          f"{tag} the recorder dropped {rec.bus.dropped} events, {rec.trace.dropped} spans")
    lineage = RequestLineage.from_recorder(rec)
    cons = lineage.conservation()
    check(len(lineage) == a.completed and cons["n_partial"] == 0
          and cons["ttft_max_rel_err"] <= REPLAY_CONSERVATION_TOL
          and cons["tpot_max_rel_err"] <= REPLAY_CONSERVATION_TOL,
          f"{tag} lineage conservation {cons}")
    ledger = SLOLedger.from_policy(rec_run["planner"]).consume(rec.events())
    check(ledger.attainment() == a.attainment,
          f"{tag} SLO ledger attainment {ledger.attainment()} against the replay's "
          f"{a.attainment}")
    doc = rec.export_chrome(str(OUT / "replay.trace.json"), flows=lineage.chrome_flows())
    n_chrome = validate_chrome(json.loads(json.dumps(doc)))
    final = evaluator.capture_bundle(
        Alert("replay.end", "warn", t=rec.events()[-1].ts, message="end of the replay"),
        path=str(Path(bundle_dir) / "end.json"))
    bundles = [x.bundle for x in evaluator.alerts if x.bundle] + [final]
    for path in bundles:
        bundle = load_bundle(path)
        got = json.loads(json.dumps(replay_ledger(bundle).as_dict()))
        check(len(bundle["events"]) > 0 and all(
            got[k] == bundle["slo"][k] for k in ("attainment", "completed", "windows")),
              f"{tag} bundle {path} does not round-trip")
    bundles_tmp.cleanup()

    # -- results (printed, not checked) -----------------------------------
    err = a.prediction_error()
    traj = " ".join(f"{i + 1}:{t.get('phi', 0)}/{t.get('general', 0)}"
                    for i, t in enumerate(rec_run["trajectory"]))
    decisions = [(i + 1, d) for i, ds in enumerate(rec_run["ticks"]) for d in ds]
    extra = [d for d in decisions if d[1][0] == "spawn"]
    say(f"{tag} {len(trace)} requests ({a.submitted} submitted, {a.completed} completed, "
        f"{a.dropped} dropped) in {a.steps} steps of {REPLAY_STEP_TIME_S * 1e3:g} ms over "
        f"{a.duration_s:.3f} simulated s; {a.engine_seconds:.3f} engine-seconds; engines peak "
        f"{a.peak_engines}, final {a.final_engines}  [{card}]")
    say(f"{tag} engines phi/general per tick: {traj}  [{card}]")
    for t, (kind, label, engine, mode) in decisions:
        say(f"{tag} tick {t}: {kind} {label} {engine} ({mode})  [{card}]")
    if not extra:
        say(f"{tag} the planner spawned nothing beyond its floors (bounds {REPLAY_BOUNDS}, "
            f"SLO targets {50 * REPLAY_STEP_TIME_S:g} s / {2 * REPLAY_STEP_TIME_S:g} s)  [{card}]")
    for label, v in sorted(a.attainment.items()):
        m = a.per_label[label]
        say(f"{tag} {label}: attainment {100 * v:.1f} % of {m['completed']} requests; TTFT mean "
            f"{m['ttft_mean_s'] * 1e3:.1f} ms (p99 {m['ttft_p99_s'] * 1e3:.1f}), TPOT mean "
            f"{m['tpot_mean_s'] * 1e3:.2f} ms, simulated  [{card}]")
    say(f"{tag} {len(a.windows)} windows, {err['windows_scored']} predicted/measured TTFT and "
        f"TPOT pairs scored: analytical MARE {err['analytical_mare']}, calibrated MARE "
        f"{err['calibrated_mare']}  [{card}]")
    say(f"{tag} alerts fired: {[(x.name, x.severity, x.label or x.engine) for x in evaluator.alerts] or 'none'}; "
        f"{len(bundles)} bundles round-trip  [{card}]")
    say(f"{tag} recorded {rec.bus.emitted} events, {rec.trace.added} spans (0 dropped); "
        f"lineage of {len(lineage)} requests, max relative error TTFT "
        f"{cons['ttft_max_rel_err']:.3g}, TPOT {cons['tpot_max_rel_err']:.3g}; Chrome export "
        f"{n_chrome} events with {len(lineage.chrome_flows())} flow events  [{card}]")
    ratio = rec_run["wall_s"] / off_run["wall_s"]
    say(f"{tag} wall time of the replay loop: recorded {rec_run['wall_s']:.3f} s, unrecorded "
        f"{off_run['wall_s']:.3f} s, ratio {ratio:.4f}; {a.steps / rec_run['wall_s']:.1f} and "
        f"{a.steps / off_run['wall_s']:.1f} steps per wall second; launches "
        f"{rec_run['launches']}  [{card}]")
    out = {"requests": len(trace), "step_time_s": REPLAY_STEP_TIME_S,
           "stats": {k: v for k, v in dataclasses.asdict(a).items() if k != "windows"},
           "windows": len(a.windows), "prediction_error": err,
           "decisions": [[t, list(d)] for t, d in decisions],
           "trajectory": rec_run["trajectory"],
           "alerts": [[x.name, x.severity, x.label, x.engine, x.t] for x in evaluator.alerts],
           "events": rec.bus.emitted, "spans": rec.trace.added, "conservation": cons,
           "wall_s": {"recorded": rec_run["wall_s"], "unrecorded": off_run["wall_s"],
                      "ratio": ratio},
           "steps_per_wall_s": [a.steps / rec_run["wall_s"], a.steps / off_run["wall_s"]],
           "launches": rec_run["launches"], "bundles": len(bundles)}
    del rec_run, off_run, rec, evaluator, lineage, ledger, doc
    free_device()
    mem1 = held_bytes()
    out["mem_delta"] = mem_delta = mem1[0] - mem0[0]
    check(abs(mem_delta) <= page_bytes,
          f"{tag} memory held {mem1[:2]} after the phase, {mem0[:2]} before it: {mem_delta:+d} "
          f"bytes, more than a page ({page_bytes})")
    say(f"{tag} memory held after the phase {mem_delta:+d} bytes against before it (a page "
        f"is {page_bytes})  [{card}]")
    say(f"{tag} every stream equals the unified oracle's; both runs' ReplayStats and "
        f"decisions equal")
    return out


def phase_ssm_migration(card):
    """Full-width Mamba2-370m (bf16, random weights from seed 0) on two
    slot-granular engines (`SSM_MIGRATE_SLOTS` slots, ``s_max`` 1024), cut to
    `SSM_MIGRATE_LAYERS` layers: the SSM serve prompts go to one engine, two
    of its requests migrate to the other mid-decode; the streams equal one engine's run without migration
    and the SSD scan launches once per layer per prefill."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingCluster, ServingEngine

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_MIGRATE_LAYERS)
    model = Model(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SSM_PROMPT_LENS]
    kw = {"n_slots": SSM_MIGRATE_SLOTS, "s_max": 1024}
    ref, _ = _serve_once(ServingEngine(model, **kw), prompts, Request)
    want = {r.rid: r.tokens_out for r in ref}
    cluster = ServingCluster()
    cluster.register("a", ServingEngine(model, **kw))
    cluster.register("b", ServingEngine(model, **kw))
    reqs = [Request(i, p, max_new_tokens=SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]
    state = {}

    def drive():
        torch.cuda.synchronize()
        for r in reqs:
            cluster.engine("a").submit(r)
        for _ in range(2):
            cluster.step()
        movable = [r.rid for r in cluster.engine("a").slot_req if r is not None][:2]
        state["records"] = cluster.migrate_requests("a", "b", movable)
        cluster.run()
        torch.cuda.synchronize()

    _, launches = _zeroed_launches(drive)
    records = state["records"]
    want_l = launches_per_prefill(SSM_ARCH, cfg.num_layers * len(prompts))
    check(launches == want_l, f"ssm migration: launches {launches}, want {want_l}")
    check({r.rid: r.tokens_out for r in reqs} == want,
          "the migrated Mamba2 streams differ from the run without migration")
    check(len(records) == 2 and all(m.phase == "decoding" and m.bytes_moved > 0
                                    for m in records), f"records {records}")
    graphs = {}
    for name in ("a", "b"):
        _check_graph_steps(f"[ssm migrate] {name}", cluster.engine(name))
        graphs[name] = _graph_line("[ssm migrate]", name, cluster.engine(name), card)
    for m in records:
        say(f"[ssm migrate] rid {m.rid} a->b: pause_s {m.pause_s:.6f} "
            f"({budget(m.pause_s, PAUSE_BUDGET_S)} the 50 ms budget), {m.bytes_moved} bytes "
            f"(SSM state), batch {m.batch}  [{card}]")
    say(f"[ssm migrate] launches {launches} ({cfg.num_layers} per prefill); streams equal "
        f"the run without migration")
    del cluster, model
    free_device()
    return {"launches": launches, "graphs": graphs,
            "migrations": [{"rid": m.rid, "pause_s": m.pause_s, "bytes": m.bytes_moved,
                            "batch": m.batch} for m in records]}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    t_start = time.perf_counter()
    import torch
    check(torch.cuda.is_available(), "no CUDA device: the port's smoke run needs one card")
    check((SRC / "repro_torch").is_dir(), f"{SRC / 'repro_torch'} not found: run from the repo")
    sys.path.insert(0, str(SRC))

    card = phase_device()
    marks = [("start", t_start)]
    mark = lambda name: marks.append((name, time.perf_counter()))  # noqa: E731
    phase_build()
    mark("build")
    rows, kernel_times = phase_kernels(card)
    mark("kernels")
    launches, serve, bf16 = phase_serve(
        card, SERVE_ARCH, SERVE_PROMPT_LENS, _path_logits,
        ("flash_fwd_kernel", "moe_topk_kernel"), paged=True,
        n_slots=8, s_max=512, page_size=16)
    free_device()                   # the bf16 model is gone; make room for fp32
    mark("serve")
    serve["paths"] = phase_paths(card, bf16)
    mark("paths")
    del bf16
    free_device()
    ssm_launches, ssm, ssm_bf16 = phase_serve(
        card, SSM_ARCH, SSM_PROMPT_LENS, _ssm_path_outputs, ("ssd_scan_kernel",),
        paged=False, n_slots=4, s_max=1024)
    mark("ssm serve")
    ssm_bf16 = [{name: (lg, None) for name, (lg, _) in out.items()}   # drop the states
                for out in ssm_bf16]
    free_device()
    ssm["paths"] = phase_ssm_paths(card, ssm_bf16)
    mark("ssm paths")
    del ssm_bf16
    free_device()
    model = cluster_model(card)
    cluster = phase_cluster(card, model)
    mark("cluster")
    cluster["scale"], oracle = phase_scale(card, model)
    mark("scale")
    cluster["replay"] = phase_replay(card, model, oracle)
    del model
    free_device()
    mark("replay")
    cluster["ssm_migration"] = phase_ssm_migration(card)
    mark("ssm migrate")
    phase_s = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    for row in rows:
        runs = launches if row["name"] in SERVE_KERNELS[SERVE_ARCH] else ssm_launches
        row["launches"] = runs[row["name"]]

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": rows, "kernel_times": kernel_times, "serve": serve,
         "ssm_serve": ssm, "cluster": cluster, "phase_s": phase_s}, indent=1))
    say(f"[time] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, the kernels' "
        f"build included; by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f" s  [{card}]")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
