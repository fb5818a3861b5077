#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit and no result line:

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off.
2. build   — compile the port's CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels — each Hopper kernel against its plain PyTorch version on the
             card, at the serving shapes of every served model (Jamba's and
             Qwen2-VL's GQA ratios, Jamba's SSD state width 16 and
             Nemotron-4-340B's 96 over 8 heads of 192 included),
             within the stated tolerances; times
             of the kernel, the plain version and one PyTorch library call for
             the same function where there is one (the yardstick; the port
             never calls it); each kernel's eager time per call through its
             custom op and through its launch alone; and the launch floor, an
             empty kernel timed the same way. Flash and the scan on a
             tensor-parallel rank's heads over a model axis of 2 equal the
             whole call's slice bit for bit, and flash on a rank's padded
             head slots over a model axis of 16 (Minitron-4B's 24 over 8
             heads at S=384, Whisper's 20 over 20 of 64 at S=128; each slot
             reading its K/V head by index, a padding slot's q zero) equals
             the whole call's slice on the real slots and feeds exactly 0
             into the output through its zero out-projection rows.
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
4b. prefill graphs — on the same Qwen model, before it is freed: an
             eager engine beside one whose PREPARE captured a prefill CUDA
             graph (`PrefillExecutable`) at four of the serve lengths and at
             every bucket of the ladder 8 ... 512, all in one memory pool,
             installed by the swap. The other four prompts take the smallest
             bucket that holds them, as the reference's ``_admit`` picks. Every
             replay is held to an eager ``model.prefill`` of its batch:
             logits, cache and greedy pick equal bit for bit, and the
             launches it adds equal one prefill's. A run with the counters
             zeroed replays every prefill and launches flash and MoE top-k
             once per layer per prefill. Warm TTFT eager against replayed
             (runs in turns; median and range), the capture seconds, the
             pool's bytes and each path's busy share of a profiled warm
             run. A second swap, whose PREPARE installs one length and no
             bucket, leaves no bucket behind: an unseen length prefills
             eagerly. Then the same for Mamba2-370m cut to 24 of its 48
             layers on its slot pool (exact lengths only: the SSD scan
             inside a graph), and `launch.serve_intents` over the Qwen
             model: two waves and the intent's swap, wave 2 admitted
             through the graphs PREPARE captured.
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
             the decode graph as for Qwen; no profiled run (the families
             phase profiles the scan in Jamba's serve mix).
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
12. families — the other decoder families at full width (bf16, random
             weights from seed 0), each freed before the next: Jamba-v0.1 cut
             to 16 of its 32 layers (two hybrid periods; all 32 do not fit
             one card) on the slot-granular pool, 8 requests over 4 slots at
             the SSM prompt lengths, every prefill launching flash 2, MoE
             top-k 8 and the SSD scan 14 times, with the profiled run; then
             one period (8 layers) in fp32, kernel path against plain path
             (router logits up to the first routing split, logits and every
             Mamba layer's final state where routing never splits) and decode
             continuity at the chunk boundaries; MiniCPM3-4B (MLA) paged over
             its latent cache with the absorbed decode, no kernel launched;
             Qwen2-VL-2B's text backbone (M-RoPE) paged, flash once per layer
             per prefill. Each serve as in phase 4 without the profile (decode
             graph replayed after the first step, run 2 equal to run 1, every
             replay held to the eager plain decode step).
13. train — the training side at full width (bf16 params, fp32 AdamW
             moments, random weights from seed 0), each model freed before the
             next: Minitron-4B (32 layers) through `make_train_step` driven
             directly, B=2 x S=1024, loss chunk 256 (step time, tokens/s, model
             FLOPs against the bf16 peak, peak memory; the loss must fall),
             then one step each under remat "dots" and "nothing" in parts
             (what the forward saves, the peaks, a profiled loss-and-gradients
             each); Mamba2-370m
             (48 layers) through `TrainRunner` under deterministic algorithms:
             a run without failure, then one with a checkpoint every 5 steps,
             a straggler and a failure at step 6, recovered from the
             checkpoint at 5 (the restored state equal to the saved one and
             the recovered losses equal to the run without failure, bit for
             bit; the straggler flagged; save and restore timed); then
             Whisper-large-v3 (32 + 32 layers, 1500 frames): a few train steps
             (the loss must fall), a bf16 prefill + greedy decode twice (flash
             once per decoder layer a prefill, never in decode, run 2 equal to
             run 1), and in fp32 the prefill's kernel path held to its plain
             path. The kernel wrappers refuse autograd, so training runs the
             reference's plain ops, as the reference's does.
14. sharded — the sharded builders (`launch.steps.jit_prefill`,
             `jit_decode_step`, `jit_train_step`) over a one-rank NCCL process
             group (a FileStore under a temp dir, no network) and a (1, 1, 1)
             CUDA mesh under `default_plan()`: the data stream made on the
             card equals the CPU's bit for bit (Minitron's tokens and mask,
             Whisper's bf16 frames); full-width Qwen1.5-MoE-A2.7B (bf16)
             prefills two prompts (17 and 384 tokens) and decodes 8 greedy
             steps each with params and cache as DTensors, flash and MoE
             top-k launching once per layer per prefill on the gathered
             plain tensors, logits and tokens equal to the unsharded
             `prefill` / `decode_step` bit for bit; the collectives of one
             sharded decode step by op and group; Mamba2-370m whole (B=4 x
             S=1024) under deterministic algorithms, one sharded train step
             (each layer gathered in its checkpointed scan step) equal to
             `make_train_step`'s bit for bit (loss, params, moments), and a
             save and a restore under the mesh's shardings equal to the state
             bit for bit; then the tensor-parallel train step on a model axis
             of 2 emulated by two threads (`tools/tp_emulate.py`, the axis's
             collectives exchanged between them): fp32 Minitron-4B,
             Qwen1.5-MoE and Whisper-large-v3 at full width and 2 layers
             (Whisper 2 + 2; B=2 x S=1024, sequence-parallel as the
             reference lays it out: each norm on the thread's piece of the
             sequence, the normed piece gathered into the shards with a
             reduce-scatter backward), the loss and the first moments
             against the whole step's, the replicated leaves' gradients
             equal on both threads, every group on its shard, and the
             model-axis collectives each step issued (by kind, with their
             ring-model wire bytes a rank, printed before the last line);
             then Whisper served on the same two threads
             (`tp_emulate.py`'s `whisper_case`: fp32, 2 + 2 layers, a prefill
             of 128 tokens over 1500 frames, flash on each thread's 10 heads
             once per decoder layer, and 8 greedy decode steps against the
             whole model, logits within 1e-5 of the step's largest, picks
             equal, every group on its shard); then decode over a
             sequence-sharded cache on the same two threads, the model axis
             cutting the heads and the cache's sequence (`tp_emulate.py`'s
             `decode_case`): fp32 Qwen1.5-MoE (4 layers, heads local) and
             Minitron-4B (2 layers, attention gathered) at full width, 8
             greedy steps across the halves against the whole model's
             decode (logits within 1e-5 of the step's largest, picks
             equal), then the cache in fp8 against the whole model's fp8
             decode on the CPU (within `PATH_LOGITS_TOL`); then attention
             heads that do not divide a model axis of 16, emulated by 16
             threads (`tp_emulate.py`'s `padded_case` and `train_case`):
             fp32 Minitron-4B (24 heads: 2 slots a thread) and MiniCPM3-4B
             (40 MLA heads: 3 slots a thread) at full width and 2 layers, a
             prefill (flash on each thread's slots) and 8 greedy decode
             steps against the whole model (logits within 1e-5 of the
             step's largest, picks equal), and Minitron's train step (B=2
             x S=1024, sequence-parallel, its collectives printed as the
             two-thread cases') against the whole step; every attention
             counted padded.
15. dryrun — in a child process (the fake world and the sharded phase's NCCL
             group must not meet in one process): the dry run
             (`launch.dryrun`) of four steps on a fake world of one rank,
             with ``device="cuda"`` and ``"cpu"`` (equal counts): full-width
             Qwen1.5-MoE-A2.7B and Mamba2-370m prefill of one 4,096-token
             prompt, Nemotron-4-340B at 1 of 96 layers prefill of 384 tokens
             (flash at head dim 192), and the train phase's Minitron-4B step
             (B=2 x S=1024); then each step run for real over a one-rank NCCL
             mesh: kernel launches, counted FLOPs and bytes and argument bytes
             equal to the prediction, the predicted peak within 5 % of the
             measured one; each prediction, measurement and roofline bound
             against the step's time printed.
16. engine ranks — the serving engine laid out across ranks
             (`sharding.plan_layout` of a rank mesh: DTensor params and pool,
             sharded PREPARE) over a one-rank NCCL mesh: each kernel wrapper
             given an empty input returns the empty result without a launch;
             the Qwen serve cell of phase 4 (8 slots, s_max 512, pages of 16,
             the serve prompts x 16 new) on a `ServingCluster`, four requests
             first, swapped after step 2 from the one-device placement to the
             layout across ranks (the other four admitted there, through the
             sharded prefill), and back after step 8, requests resident.
             Every step's logits, the streams and the final pool equal an
             unsharded engine's on the same schedule bit for bit; flash and
             MoE top-k launch once per layer per prefill (PREPARE's warm
             prefills included); decode replays its graph on one device and
             runs eagerly across ranks by design.
17. output — a ``{"kernels": [...]}`` JSON line (each kernel's launches on
             its first serve path and on every serve path, Whisper's prefill,
             the sharded prefills, the padded prefill on 16 emulated ranks
             and the engine-ranks phase included, and its times at the
             other families' shapes and on a rank's heads and padded head
             slots), then, last, the
             result line ``{"ok": true, "device": {...}}``.

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, the PATH or /usr/local/cuda)
and the repository's ``src/`` beside this file. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
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
# the other decoder families. Jamba-v0.1 at full width is cut in depth to
# fit one card: 16 of its 32 layers (two periods of eight) in bf16 for the
# serve, one period in fp32 for the paths check; MiniCPM3-4B and Qwen2-VL-2B
# run whole
HYBRID_ARCH = "jamba_v0_1_52b"
HYBRID_SERVE_LAYERS = 16
HYBRID_PATH_LAYERS = 8
MLA_ARCH = "minicpm3_4b"
MROPE_ARCH = "qwen2_vl_2b"
# launches of (flash, MoE top-k, SSD scan) per prefill, by model name and
# depth, for every model this script builds, counted by hand from the
# published layer layouts: `launches_per_prefill` derives them from the
# port's `layer_kinds` and must agree
PREFILL_LAUNCHES = {
    ("qwen2-moe-a2.7b", 24): (24, 24, 0),
    ("mamba2-370m", 48): (0, 0, 48),
    ("mamba2-370m", 24): (0, 0, 24),
    ("jamba-v0.1-52b", 16): (2, 8, 14),      # per period of 8: 1 attn, 4 MoE, 7 Mamba
    ("jamba-v0.1-52b", 8): (1, 4, 7),
    ("minicpm3-4b", 62): (0, 0, 0),          # MLA prefill is plain `sdpa`
    ("qwen2-vl-2b", 28): (28, 0, 0),
}


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
    for fn, regs, spill in ptxas_report(_build.PTXAS_LOG):
        if "Li192E" in fn:           # flash at Nemotron's head dim
            say(f"[build] flash D=192 {'bf16 mma' if 'mma' in fn else 'fp32'}: "
                f"{regs} registers, {spill}")


def ptxas_report(log: str):
    """(function, registers, spill line) of each kernel in an
    ``-Xptxas -v`` log."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line:
            spill = line
        elif "Used" in line and "registers" in line and fn is not None:
            regs = int(line.split("Used", 1)[1].split("registers")[0].strip())
            out.append((fn, regs, spill))
            fn = None
    return out


def grid_note(blocks: int) -> str:
    """Blocks of a launch and the SMs they can occupy at once (blocks go
    to distinct SMs first)."""
    import torch
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{blocks} blocks, {min(blocks, n_sm)} of {n_sm} SMs used"


def _flash_timed(gen, S, Hq, Hkv, card, tag, D=128):
    """Time flash at ``(1, S, Hq, Hkv, D)`` bf16 causal: the kernel
    (graph-timed and eager), its plain version, PyTorch's
    `scaled_dot_product_attention` and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v = _flash_case(gen, 1, S, Hq, Hkv, D, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    t = {"shape": f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal",
         "ms": time_ms(kernel),
         "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True)),
         "eager_ms": eager_ms(kernel),
         # the launch without the custom op's dispatch (the wrappers' path
         # before the kernels became custom ops)
         "eager_direct_ms": eager_ms(lambda: fa.flash_attention(q, k, v, causal=True))}
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()    # q, k, v read, out written
    ops_ = 4 * Hq * D * S * (S + 1) // 2       # two products over the causal pairs
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops_, "bfloat16")
    t["grid"] = grid_note(-(-S // fa.BF16_Q_TILE) * Hq)
    say(f"[kernels] flash time {tag} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal: " + ", ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in t.items() if k != "shape") + f"  [{card}]")
    return t


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

    from repro_torch.kernels import _build, ops, ref
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
    # the other families' prefills: Jamba's attention (32 over 8 heads) at
    # the SSM prompt lengths, Qwen2-VL's (12 over 2) at the serve lengths
    shapes += [(1, S, 32, 8, 128, "jamba-gqa") for S in SSM_PROMPT_LENS]
    shapes += [(1, S, 12, 2, 128, "qwen2vl-gqa") for S in SERVE_PROMPT_LENS]
    # Whisper's decoder prefill (20 over 20 heads of 64) at the train phase's
    # prompt length, and at one partial tile and its 448-token context
    shapes += [(1, S, 20, 20, 64, "whisper") for S in (17, WHISPER_PROMPT_LEN, 448)]
    shapes += [(2, S, 6, 2, D, "edge") for S in (17, 77, 200, 257) for D in (16, 32, 64)]
    # Nemotron-4-340B's prefill (96 over 8 heads of 192) at a full tile and
    # a ragged length
    shapes += [(1, S, 96, 8, 192, "nemotron") for S in (384, 1000)]
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
    # Qwen's, then the other families' longest prefills: Jamba's at S=1000,
    # Qwen2-VL's at S=384
    flash_times = {S: _flash_timed(gen, S, 16, 16, card, "qwen") for S in (128, 200, 384, 512)}
    for tag, (S, Hq, Hkv) in (("jamba", (1000, 32, 8)), ("qwen2vl", (384, 12, 2))):
        flash_times[tag] = _flash_timed(gen, S, Hq, Hkv, card, tag)
    flash_times["nemotron"] = _flash_timed(gen, 384, 96, 8, card, "nemotron", D=192)
    flash_shards = _tp_flash_shards(gen, card) + _tp_flash_padded(gen, card)
    t = flash_times[384]
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:31",
                 "launches": None, "max_abs_err": flash_err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "eager_ms": t["eager_ms"], "shape": "B=1 S=384 Hq=Hkv=16 D=128 bf16 causal",
                 "eager_direct_ms": t["eager_direct_ms"],
                 "other_shapes": [flash_times[k] for k in ("jamba", "qwen2vl", "nemotron")],
                 "tp_shards": flash_shards})

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
        "eager_direct_ms": eager_ms(lambda: moe.moe_topk(x, 4)),
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
                 "eager_ms": mt["eager_ms"], "eager_direct_ms": mt["eager_direct_ms"],
                 "shape": "T=384 E=60 k=4 fp32"})

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
    # Jamba's Mamba layers: 128 heads, state width 16 (one 16-column tile)
    cases += [(1, S, 128, 1, 64, 16, 256, "jamba") for S in (17, 256, 257, 1000)]
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
    # two Mamba2 serve prompt lengths, then Jamba's longest (H=128, N=16)
    for key, (S, H, N) in ((512, (512, 32, 128)), (1000, (1000, 32, 128)),
                           ("jamba", (1000, 128, 16))):
        inp = _ssd_case(gen, 1, S, H, 1, 64, N, torch.bfloat16)
        kernel = lambda: ops.ssd_scan(*inp, chunk=256)  # noqa: E731
        ssd_times[key] = {
            "shape": f"B=1 S={S} H={H} G=1 P=64 N={N} chunk=256 bf16",
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*inp, chunk=256)),
            "library_ms": None,          # no single PyTorch call computes the scan
            "eager_ms": eager_ms(kernel),
            "eager_direct_ms": eager_ms(lambda: ssd.ssd_scan(*inp, chunk=256)),
        }
        ssd_times[key]["bound_ms"], ssd_times[key]["bound_by"] = bound(
            *ssd_work(1, S, H, 1, 64, N, 256, 2), "bfloat16")
        ssd_times[key]["grid"] = grid_note(H * 64 // ssd.P_TILE)
        say(f"[kernels] ssd_scan time S={S} H={H} P=64 N={N} chunk=256 bf16: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ssd_times[key].items() if k != "shape") + f"  [{card}]")
    ssd_shards = _tp_ssd_shards(gen, card)
    t = ssd_times[1000]
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan.py:28",
                 "launches": None, "max_abs_err": ssd_err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": None,
                 "eager_ms": t["eager_ms"], "eager_direct_ms": t["eager_direct_ms"],
                 "shape": "B=1 S=1000 H=32 G=1 P=64 N=128 chunk=256 bf16",
                 "other_shapes": [ssd_times["jamba"]], "tp_shards": ssd_shards})
    return rows, {"flash": flash_times, "moe_topk": mt, "ssd_scan": ssd_times,
                  "launch_floor": floor, "tp_shards": {"flash": flash_shards,
                                                       "ssd_scan": ssd_shards}}


#: a tensor-parallel rank's heads (`lm.tp_groups`) over a model axis of 2:
#: flash at Qwen's S=384 (16 over 16 heads of 128 -> 8 over 8), Jamba's
#: S=1000 (32 over 8 -> 16 over 4) and Whisper's decoder prefill of 128
#: (20 over 20 heads of 64 -> 10 over 10); the scan at Mamba2's S=1000 (32
#: heads -> 16)
TP_FLASH_SHARDS = (("qwen", 384, 16, 16, 2, 128), ("jamba", 1000, 32, 8, 2, 128),
                   ("whisper", 128, 20, 20, 2, 64))
TP_SSD_SHARDS = (("mamba2", 1000, 32, 128, 2),)
#: a rank's padded head slots (`ctx.head_slots`) over a model axis of 16,
#: the one extent on which the shipped configs pad: Minitron-4B's prefill
#: at S=384 (24 over 8 heads of 128 -> 2 slots, ranks 12-15 padding alone)
#: and Whisper's decoder prefill of 128 (20 over 20 heads of 64 -> 2 slots,
#: ranks 10-15 padding alone)
TP_FLASH_PADDED = (("minitron", 384, 24, 8, 16, 128), ("whisper", 128, 20, 20, 16, 64))


def _tp_flash_shards(gen, card):
    """Flash on each rank's q heads and the K/V heads they read equals that
    slice of the whole call bit for bit (heads are independent), fp32 and
    bf16; the bf16 slice timed as the whole call is (`_flash_timed`)."""
    import torch

    from repro_torch.kernels import ops, ref
    out = []
    for tag, S, Hq, Hkv, tp, D in TP_FLASH_SHARDS:
        hq, hkv = Hq // tp, Hkv // tp
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_case(gen, 1, S, Hq, Hkv, D, dtype)
            whole = ops.flash_attention(q, k, v, causal=True)
            for r in range(tp):
                part = ops.flash_attention(q[:, :, r * hq:(r + 1) * hq].contiguous(),
                                           k[:, :, r * hkv:(r + 1) * hkv].contiguous(),
                                           v[:, :, r * hkv:(r + 1) * hkv].contiguous(),
                                           causal=True)
                torch.cuda.synchronize()
                same = torch.equal(part, whole[:, :, r * hq:(r + 1) * hq])
                say(f"[kernels] flash tp shard {tag} S={S} Hq={Hq}->{hq} Hkv={Hkv}->{hkv} D={D} "
                    f"rank {r} of {tp} {dtype}: the whole call's slice bit for bit "
                    f"{'ok' if same else 'FAIL'}")
                check(same, f"flash on rank {r}'s heads is not the whole call's slice "
                            f"({tag}, {dtype})")
        t = _flash_timed(gen, S, hq, hkv, card, f"{tag} tp shard 1 of {tp}", D=D)
        q, k, v = _flash_case(gen, 1, S, hq, hkv, D, torch.bfloat16)
        ok, t["max_abs_err"] = within(ops.flash_attention(q, k, v, causal=True),
                                      ref.flash_attention_ref(q, k, v, causal=True),
                                      FLASH_TOL["bfloat16"])
        check(ok, f"flash on a rank's heads disagrees with its plain version ({tag})")
        t["whole"] = f"Hq={Hq} Hkv={Hkv}"
        out.append(t)
    return out


def _tp_flash_padded(gen, card):
    """Flash on each rank's padded head slots, as the model calls it
    (`attention._kv_heads_read`, `_take_kv`): the rank's real q heads, a
    zero q for each padding slot, and the K/V head each slot reads. On the
    real slots it equals that slice of the whole call, bit for bit where
    the heads are computed alike (a rank's call may read its K/V heads
    grouped otherwise than the whole call; a difference is printed and held
    within `FLASH_TOL`); a padding slot's output is finite, so its zero
    out-projection rows feed exactly 0 into the layer's output. fp32 and
    bf16; the bf16 call of the rank that reads the most K/V heads timed as
    the whole call is (`_flash_timed`)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import _take_kv
    out = []
    for tag, S, Hq, Hkv, tp, D in TP_FLASH_PADDED:
        k = -(-Hq // tp)
        group = Hq // Hkv
        index = [tuple(h // group if h < Hq else 0 for h in range(r * k, (r + 1) * k))
                 for r in range(tp)]
        bitwise = True
        for dtype in (torch.float32, torch.bfloat16):
            q, kk, vv = _flash_case(gen, 1, S, Hq, Hkv, D, dtype)
            whole = ops.flash_attention(q, kk, vv, causal=True)
            wo = torch.zeros((k * D, 64), dtype=dtype, device="cuda")
            for r in range(tp):
                real = [h for h in range(r * k, (r + 1) * k) if h < Hq]
                qr = torch.zeros((1, S, k, D), dtype=dtype, device="cuda")
                qr[:, :, :len(real)] = q[:, :, real]
                part = ops.flash_attention(qr, _take_kv(kk, index[r]).contiguous(),
                                           _take_kv(vv, index[r]).contiguous(), causal=True)
                torch.cuda.synchronize()
                got, want = part[:, :, :len(real)], whole[:, :, real]
                same = torch.equal(got, want)
                bitwise = bitwise and same
                ok, err = (True, 0.0) if same else within(got, want,
                                                          FLASH_TOL[str(dtype)[6:]])
                pad = part[:, :, len(real):]
                # a padding slot's out-projection rows are zero (`ctx.slot_cut`)
                fed = pad.reshape(S, -1) @ wo[len(real) * D:]
                zero = bool(torch.isfinite(pad).all()) and not bool(fed.any())
                say(f"[kernels] flash tp padded {tag} S={S} Hq={Hq}->{k} slots ({len(real)} "
                    f"real) Hkv={Hkv} reads {index[r]} D={D} rank {r} of {tp} {dtype}: the "
                    f"whole call's slice {'bit for bit' if same else f'max|err|={err:.3e}'}, "
                    f"padding feeds 0 {zero} {'ok' if ok and zero else 'FAIL'}")
                check(ok and zero, f"flash on rank {r}'s padded slots ({tag}, {dtype}): "
                                   f"max|err| {err}, padding feeds 0 {zero}")
        r = max(range(tp), key=lambda r: len(set(index[r])))
        hkv = _take_kv(kk, index[r]).shape[2]
        t = _flash_timed(gen, S, k, hkv, card, f"{tag} tp padded rank {r} of {tp}", D=D)
        q, kk, vv = _flash_case(gen, 1, S, k, hkv, D, torch.bfloat16)
        ok, t["max_abs_err"] = within(ops.flash_attention(q, kk, vv, causal=True),
                                      ref.flash_attention_ref(q, kk, vv, causal=True),
                                      FLASH_TOL["bfloat16"])
        check(ok, f"flash on a rank's padded slots disagrees with its plain version ({tag})")
        t["whole"] = f"Hq={Hq} Hkv={Hkv}"
        t["padded"] = {"tp": tp, "slots": k, "rank": r, "reads": list(index[r]),
                       "bit_for_bit": bitwise}
        out.append(t)
    return out


def _tp_ssd_shards(gen, card):
    """The scan on each rank's SSM heads (B and C whole: one group) equals
    that slice of the whole call's output and final state bit for bit, fp32
    and bf16; the bf16 slice timed, with its plain version and bound."""
    import torch

    from repro_torch.kernels import ops, ref
    out = []
    for tag, S, H, N, tp in TP_SSD_SHARDS:
        h = H // tp
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm = _ssd_case(gen, 1, S, H, 1, 64, N, dtype)
            y, state = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
            for r in range(tp):
                cut = slice(r * h, (r + 1) * h)
                y_r, s_r = ops.ssd_scan(x[:, :, cut].contiguous(), dt[:, :, cut].contiguous(),
                                        A[cut].contiguous(), Bm, Cm, chunk=256)
                torch.cuda.synchronize()
                same = torch.equal(y_r, y[:, :, cut]) and torch.equal(s_r, state[:, cut])
                say(f"[kernels] ssd_scan tp shard {tag} S={S} H={H}->{h} rank {r} of {tp} "
                    f"{dtype}: the whole call's slice (y and state) bit for bit "
                    f"{'ok' if same else 'FAIL'}")
                check(same, f"ssd_scan on rank {r}'s heads is not the whole call's slice "
                            f"({tag}, {dtype})")
        inp = _ssd_case(gen, 1, S, h, 1, 64, N, torch.bfloat16)
        kernel = lambda: ops.ssd_scan(*inp, chunk=256)  # noqa: E731
        t = {"shape": f"B=1 S={S} H={h} (of {H}) G=1 P=64 N={N} chunk=256 bf16",
             "ms": time_ms(kernel),
             "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*inp, chunk=256)),
             "library_ms": None}
        ok, t["max_abs_err"] = within(kernel()[0], ref.ssd_scan_ref(*inp, chunk=256)[0],
                                      SSD_TOL["bfloat16"][0])
        check(ok, f"ssd_scan on a rank's heads disagrees with its plain version ({tag})")
        t["bound_ms"], t["bound_by"] = bound(*ssd_work(1, S, h, 1, 64, N, 256, 2), "bfloat16")
        say(f"[kernels] ssd_scan time {tag} tp shard 1 of {tp} S={S} H={h} P=64 N={N} "
            f"chunk=256 bf16: " + ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in t.items() if k != "shape") + f"  [{card}]")
        out.append(t)
    return out


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


def launches_per_prefill(cfg, n):
    """Launch counts ``n`` prefills of ``cfg`` must add: flash once per GQA
    attention layer (MLA prefill runs plain `sdpa`, as the reference's),
    MoE top-k once per MoE layer, the SSD scan once per Mamba layer, over
    every period of a hybrid model."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import layer_kinds, n_scan_steps
    kinds = layer_kinds(cfg)
    per_step = {"flash_attention": sum(m == "attn" for m, _ in kinds),
                "moe_topk": sum(f == "moe" for _, f in kinds),
                "ssd_scan": sum(m == "ssm" for m, _ in kinds)}
    per_prefill = {k: n_scan_steps(cfg) * per_step[k] for k in ops.LAUNCHES}
    key = (cfg.name, cfg.num_layers)
    check(key in PREFILL_LAUNCHES, f"{key}: no hand-counted launches in PREFILL_LAUNCHES")
    by_hand = dict(zip(("flash_attention", "moe_topk", "ssd_scan"), PREFILL_LAUNCHES[key]))
    check(per_prefill == by_hand, f"{key}: the port's layer kinds give {per_prefill} "
                                  f"launches per prefill, counted by hand {by_hand}")
    return {k: n * v for k, v in per_prefill.items()}


def phase_serve(card, arch, prompt_lens, path_fn, profile_kernels, *, paged,
                tag=None, layers=None, after=None, **engine_kw):
    """``ServingEngine`` over full-width ``arch`` (bf16, random weights from
    seed 0; cut to ``layers`` when given) on the paged or the slot-granular
    pool (``paged``): run 1 with the launch counters zeroed just before it
    and read just after it (its first decode step runs eagerly and captures
    the decode graph, every later step replays it), run 2 identical with
    each step's host time recorded, then each prompt's prefill on each path
    (``path_fn``), whose kernel-path argmax must be the engine's first
    token, a profiled run 3 (when ``profile_kernels`` is not None), the host
    ops of one graph step against one eager ``decode_step``, and run 4, each
    graph step held to the eager (plain) decode step (`_graph_vs_eager`);
    then ``after(model)``, a phase over the same model, when given (its
    result under ``"after"``). Returns (launches of run 1, metrics, the
    per-prompt path outputs)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine, compute_metrics

    tag = tag or ("[serve]" if paged else "[ssm serve]")
    parts = [("start", time.perf_counter())]
    part = lambda name: parts.append((name, time.perf_counter()))  # noqa: E731
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
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
    want = launches_per_prefill(cfg, len(prompts))
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

    profile = {}
    if profile_kernels is not None:
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
    done = None
    if after is not None:
        del engine
        free_device()
        done = after(model)
        part("after")
    part_s = {name: t - parts[i][1] for i, (name, t) in enumerate(parts[1:])}
    say(f"{tag} phase parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
        + f"  [{card}]")
    return launches, {"run1": m1, "run2": m2, "wall1_s": wall, "wall2_s": wall2,
                      "tokens": n_tok, "peak_gb": peak_gb, "profile": profile,
                      "graph": graph, "parts_s": part_s, "after": done}, paths


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


def _path_logits(model, prompt, paths=tuple(PATHS)):
    """One prompt's last-token logits (fp32, real vocab, on the host), MoE
    routing and every Mamba layer's final SSM state (fp32, on the host,
    stacked in cache-key order; None without one) on each of ``paths`` (of
    `PATHS`), checking that each path launched what it should: ``{path:
    (logits, routing, states)}``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.common import padded_vocab
    from repro_torch.models.lm import leaf_name
    cfg = model.cfg
    batch = {"tokens": torch.as_tensor(prompt, device="cuda")[None]}
    n_moe = launches_per_prefill(cfg, 1)["moe_topk"]   # MoE layers
    out = {}
    for name in paths:
        chunks = PATHS[name]
        before, routing = dict(ops.LAUNCHES), []
        with routed(ops, ref, chunks, routing):
            logits, cache = model.prefill(batch)
        torch.cuda.synchronize()
        want = launches_per_prefill(cfg, 1 if chunks is None else 0)
        want = {n: before[n] + k for n, k in want.items()}
        check(ops.LAUNCHES == want,
              f"the {name} path launched {ops.LAUNCHES} (before: {before}), want {want}")
        ssm = [cache[k] for k in sorted(cache) if leaf_name(k) == "ssm"]
        states = torch.cat(ssm).cpu() if ssm else None
        check(tuple(logits.shape) == (1, padded_vocab(cfg.vocab_size))
              and bool(torch.isfinite(logits).all())
              and (states is None or bool(torch.isfinite(states).all())),
              f"{name} prefill logits: shape {tuple(logits.shape)}, or not finite")
        check(len(routing) == n_moe, f"{name} path: {len(routing)} MoE layers routed, "
                                     f"want {n_moe}")
        out[name] = (logits[0, :cfg.vocab_size].float().cpu(), routing, states)
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


# the prefill graphs phase (`serving/executable.py::PrefillExecutable`):
# PREPARE is given the first four serve lengths, so those prompts replay
# their exact-length graphs, and the other four the smallest bucket that
# holds them (64 itself, 256, 256, 512; the ladder 8 ... 512)
PG_EXACT_LENS = (17, 100, 256, 384)
PG_RUNS = 3                     # warm runs a path, eager and replayed in turns
# Mamba2's slot pool pads nothing: exact lengths only, at half depth (the
# scan inside a graph needs no more layers to show; the capture and the
# checks take half the time)
PG_SSM_LAYERS = 24
PG_SSM_LENS = (17, 255, 256, 1000)


@contextlib.contextmanager
def _replays_held_to_eager(engine, records):
    """While inside, every installed prefill executable's replay is held to
    an eager ``model.prefill`` of the same batch, run just after it over the
    executable's buffers: logits, ``cache1`` and ``next_tok`` equal bit for
    bit, and the launches the replay added equal one prefill's
    (`launches_per_prefill`). One record per replay in ``records``."""
    import torch

    from repro_torch.kernels import ops
    model = engine.model
    vocab = model.cfg.vocab_size
    want = launches_per_prefill(model.cfg, 1)
    exact, buckets = engine.prefill_executables
    exes = [e for e in list(exact.values()) + list(buckets.values()) if e is not None]
    check(exes and all(e.graph is not None for e in exes),
          f"{model.cfg.name}: an installed prefill executable holds no graph")

    def held(exe, run):
        def go():
            before = dict(ops.LAUNCHES)
            run()
            torch.cuda.synchronize()
            got = {k: ops.LAUNCHES[k] - before[k] for k in before}
            logits, cache = model.prefill(exe.batch())
            pick = int(torch.argmax(logits[0, :vocab]))
            torch.cuda.synchronize()
            records.append({
                "length": exe.length, "padded": exe.padded,
                "true_len": int(exe.true_len) if exe.padded else exe.length,
                "launches_ok": got == want,
                "logits_equal": bool(torch.equal(exe.logits, logits)),
                "cache_equal": all(torch.equal(exe.cache1[k], v) for k, v in cache.items()),
                "next_tok_equal": int(exe.next_tok[0]) == pick})
        return go

    for e in exes:
        e.run = held(e, e.run)
    try:
        yield records
    finally:
        for e in exes:
            del e.run


def _busy_run(engine, prompts, Request):
    """One profiled run: (its requests, wall seconds, device-busy seconds:
    the device events' own time summed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, wall = _serve_once(engine, prompts, Request)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    return reqs, wall, busy


def _stats_delta(engine, before):
    return {k: engine.prefill_stats[k] - before[k] for k in ("exact", "bucket", "eager",
                                                            "replays")}


def _prefill_graph_cell(card, tag, model, prompts, lengths, buckets, engine_kw):
    """One model's prefill graphs (module docstring, phase 4b): an eager
    engine and one whose PREPARE captured a graph at each of ``lengths``
    (and each bucket when ``buckets``), both over ``model``, warmed; one
    run with every replay held to the eager prefill of its batch; one run
    with the launch counters zeroed just before and read just after (every
    prefill a replay, the counts a prefill's each); `PG_RUNS` warm runs a
    path in turns (TTFT, the streams of each path equal run to run, and an
    exact-length prompt's stream equal on both paths); a profiled warm run
    each. Returns the figures."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import Request, ServingEngine, compute_metrics
    cfg = model.cfg
    place = {"params": model.device, "cache": model.device}
    eager = ServingEngine(model, **engine_kw)
    graphs = ServingEngine(model, **engine_kw)
    e_reqs, _ = _serve_once(eager, prompts, Request)          # cold: decode capture
    _serve_once(graphs, prompts, Request)
    t0 = time.perf_counter()
    execs, n = graphs.prepare_executables(place, prefill_lengths=lengths,
                                          prefill_buckets=buckets)
    prepare_s = time.perf_counter() - t0
    exes = list(execs["prefill"].values()) + list(execs["prefill_buckets"].values())
    pool = exes[0].pool_bytes()
    check(n == 1 + len(exes) and len({tuple(e.graph.pool()) for e in exes}) == 1,
          f"{tag} PREPARE: {n} executables, pools {[e.graph.pool() for e in exes]}")
    graphs.pause()
    graphs.swap_plan(placement=place, executables=execs)
    graphs.resume()
    del execs, exes
    records = []
    before = dict(graphs.prefill_stats)
    with _replays_held_to_eager(graphs, records):
        _serve_once(graphs, prompts, Request)
    held = _stats_delta(graphs, before)
    bad = [r for r in records if not (r["launches_ok"] and r["logits_equal"]
                                      and r["cache_equal"] and r["next_tok_equal"])]
    check(len(records) == len(prompts) and held["replays"] == len(prompts) and not bad,
          f"{tag}: replays held to eager prefill: {held}, failing {bad}")
    say(f"{tag} {len(records)} replays, each held to an eager model.prefill of its batch: "
        f"logits, cache1 and next_tok equal bit for bit, launches "
        f"{launches_per_prefill(cfg, 1)} each; picks {held}  [{card}]")

    before = dict(graphs.prefill_stats)
    (g_reqs, _), launches = _zeroed_launches(lambda: _serve_once(graphs, prompts, Request))
    want = launches_per_prefill(cfg, len(prompts))
    counted = _stats_delta(graphs, before)
    check(launches == want and counted["replays"] == len(prompts),
          f"{tag}: launches {launches} (want {want}), prefills {counted}")
    say(f"{tag} counted run: launches {launches} (want {want}), prefills {counted}")

    ttft = {"eager": [], "replayed": []}
    streams = {"eager": [], "replayed": []}
    for _ in range(PG_RUNS):
        for name, eng in (("eager", eager), ("replayed", graphs)):
            reqs, _ = _serve_once(eng, prompts, Request)
            ttft[name].append(compute_metrics(reqs)["ttft_mean_s"])
            streams[name].append([r.tokens_out for r in reqs])
    for name, runs in streams.items():
        check(all(s == runs[0] for s in runs), f"{tag}: the {name} runs' streams differ")
    same = [i for i, p in enumerate(prompts) if len(p) in lengths]
    check(all(streams["eager"][0][i] == streams["replayed"][0][i] for i in same),
          f"{tag}: an exact-length prompt's stream differs between the paths")
    parted = [i for i in range(len(prompts)) if streams["eager"][0][i] != streams["replayed"][0][i]]
    _check_graph_steps(f"{tag} eager engine", eager)
    _check_graph_steps(f"{tag} graph engine", graphs)
    _, e_wall, e_busy = _busy_run(eager, prompts, Request)
    _, g_wall, g_busy = _busy_run(graphs, prompts, Request)
    s = graphs.prefill_stats
    out = {"prepare_s": prepare_s, "executables": n, "captures": s["captures"],
           "capture_s": s["capture_s"], "pool_bytes": pool, "launches": launches,
           "records": len(records), "ttft_s": ttft, "busy": {
               "eager": {"wall_s": e_wall, "busy_s": e_busy},
               "replayed": {"wall_s": g_wall, "busy_s": g_busy}},
           "bucket_streams_parted": parted, "prefill_stats": dict(s)}
    say(f"{tag} PREPARE {prepare_s:.3f} s: {n} executables, {s['captures']} prefill graphs "
        f"captured in {s['capture_s']:.3f} s, one pool of {pool} B "
        f"({pool / 2**20:.1f} MiB)  [{card}]")
    for name in ("eager", "replayed"):
        ms = [1e3 * t for t in ttft[name]]
        say(f"{tag} warm TTFT mean, {name} prefill: median {np.median(ms):.2f} ms, range "
            f"{min(ms):.2f}-{max(ms):.2f} ms over {PG_RUNS} runs in turns  [{card}]")
    for name, (w, b) in (("eager", (e_wall, e_busy)), ("replayed", (g_wall, g_busy))):
        say(f"[profile] {tag} warm {name} run: wall {w:.3f} s, device busy {b:.3f} s "
            f"({100 * b / w:.1f} %)  [{card}]")
    say(f"{tag} bucket prompts whose stream parts from the eager path's (a padded "
        f"prefill is another shape): {parted}")
    return out, graphs


def phase_prefill_graphs(card, model):
    """Phase 4b (module docstring): the Qwen serve model's prefill graphs
    (`_prefill_graph_cell`), then a swap whose PREPARE installs one length
    and no bucket (an unseen length then prefills eagerly), then Mamba2 at
    `PG_SSM_LAYERS` layers on its slot pool (exact lengths: the SSD scan
    inside a graph), then `launch.serve_intents` over the same Qwen."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_intents
    from repro_torch.models import Model
    from repro_torch.serving import Request

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, model.cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPT_LENS]
    out, graphs = {}, None
    out["qwen"], graphs = _prefill_graph_cell(
        card, "[prefill graphs]", model, prompts, PG_EXACT_LENS, True,
        {"n_slots": 8, "s_max": 512, "page_size": 16})
    check(graphs.prefill_stats["bucket"] > 0, "[prefill graphs] no bucket was replayed")

    place = {"params": model.device, "cache": model.device}
    execs, n = graphs.prepare_executables(place, prefill_lengths=PG_EXACT_LENS[:1])
    graphs.pause()
    graphs.swap_plan(placement=place, executables=execs)
    graphs.resume()
    exact, buckets = graphs.prefill_executables
    check(sorted(exact) == [PG_EXACT_LENS[0]] and buckets == {} and graphs._bucket_lengths == [],
          f"[prefill graphs] after the second swap: {sorted(exact)}, buckets {sorted(buckets)}")
    before = dict(graphs.prefill_stats)
    pick = [prompts[SERVE_PROMPT_LENS.index(PG_EXACT_LENS[0])], prompts[1]]   # 17, then 64
    _serve_once(graphs, pick, Request)
    moved = _stats_delta(graphs, before)
    check((moved["exact"], moved["bucket"], moved["eager"], moved["replays"]) == (1, 0, 1, 1),
          f"[prefill graphs] after a swap without buckets: {moved}")
    say(f"[prefill graphs] second swap ({n} executables, no bucket): a 17 replays its "
        f"graph, a 64 prefills eagerly: {moved}")
    del graphs, execs
    free_device()

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=PG_SSM_LAYERS)
    ssm = Model(cfg, device="cuda", seed=0)
    ssm_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                   for n in PG_SSM_LENS]
    out["mamba2"], eng = _prefill_graph_cell(
        card, "[ssm prefill graphs]", ssm, ssm_prompts, PG_SSM_LENS, True,
        {"n_slots": 4, "s_max": 1024})
    check(eng.prefill_stats["bucket"] == 0 and eng._bucket_lengths == [],
          "[ssm prefill graphs] the slot pool took a bucket")
    del eng, ssm
    free_device()

    intents = serve_intents.main(["--device", "cuda"], model=model)
    report = intents["report"]
    stats = intents["prefill_stats"]
    check(stats["replays"] == len(intents["wave2"]) == stats["exact"]
          and all(len(t) == 8 for t in intents["wave2"].values()),
          f"[serve intents] wave 2 did not replay its prefill graphs: {stats}")
    say(f"[serve intents] {report.summary()}; aot x{report.compiled_in_prepare}, downtime "
        f"{report.downtime_s * 1e3:.2f} ms, wave 2 prefills {stats}  [{card}]")
    out["serve_intents"] = {"summary": report.summary(), "downtime_s": report.downtime_s,
                            "prepare_s": report.prepare_s,
                            "n_compiled": report.compiled_in_prepare,
                            "prefill_stats": stats, "decode_stats": intents["decode_stats"]}
    free_device()
    out["seconds"] = time.perf_counter() - t0
    say(f"[prefill graphs] phase {out['seconds']:.1f} s  [{card}]")
    return out


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
    and the plain path (`_path_logits`): ``{path: (logits, states)}``."""
    return {name: (lg, states) for name, (lg, _, states)
            in _path_logits(model, prompt, ("kernel", "plain")).items()}


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


def phase_hybrid_paths(card):
    """Jamba at full width, cut to `HYBRID_PATH_LAYERS` (one period), in
    fp32 (random weights from seed 0): every SSM serve prompt's prefill,
    kernel path against plain path. Up to the first layer whose MoE routing
    differs the router logits agree within `ROUTER_TOL`; where routing never
    differs the logits agree within `PATH_LOGITS_TOL` with the same top-1
    and every Mamba layer's final state within atol = rtol =
    `SSM_PATH_TOL`. Then decode continuity on the kernel path: prefill(S)
    and one decode step of token S (the prefill's cache written into a slot
    with room for it) give prefill(S + 1)'s logits within `SSM_PATH_TOL`,
    for S around the chunk boundary (both MoE groups drop no token). Last,
    the weights rounded to bf16 in place, every prompt on each of `PATHS`
    in bf16 (the kernels' bf16 variants, the SSD scan's at N = 16 among
    them): the router logits within `ROUTER_TOL` up to the routing split,
    and, held to the fp32 plain logits, the kernel path strays at most
    `BF16_PATH_RATIO` times as far as the plain paths do."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.lm import Leaf, param_layout
    from repro_torch.serving.engine import _write_slot

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), num_layers=HYBRID_PATH_LAYERS,
                              param_dtype="float32", activ_dtype="float32")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    say(f"[hybrid paths] {cfg.name}: {cfg.num_layers} layers (one period), "
        f"{n_params / 1e9:.2f} B parameters (float32), random from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s; per prompt, kernel vs plain path  [{card}]")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SSM_PROMPT_LENS]
    rows, fp32, ok = [], [], True
    for S, prompt in zip(SSM_PROMPT_LENS, prompts):
        out = _path_logits(model, prompt, ("kernel", "plain"))
        (lk, rk, hk), (lp, rp, hp) = out["kernel"], out["plain"]
        fp32.append(lp)
        layer, rdiff, n, gap = routing_split(rk, rp)
        s_ok, s_diff = within(hk, hp, SSM_PATH_TOL)
        row = {"S": S, "split_layer": layer, "split_tokens": n, "split_gap": gap,
               "router_max_diff": rdiff, "logits_max_diff": (lk - lp).abs().max().item(),
               "states_max_diff": s_diff, "top1_kernel": int(lk.argmax()),
               "top1_plain": int(lp.argmax())}
        row["ok"] = rdiff <= ROUTER_TOL["float32"] and (layer is not None or (
            s_ok and row["top1_kernel"] == row["top1_plain"]
            and row["logits_max_diff"] <= PATH_LOGITS_TOL["float32"]))
        ok &= row["ok"]
        rows.append(row)
        split = "none" if layer is None else f"layer {layer}, {n} tokens, gap {gap:.2e}"
        say(f"[hybrid paths] float32 S={S}: split {split}; router {rdiff:.2e} "
            f"(tol {ROUTER_TOL['float32']}); logits max|diff| {row['logits_max_diff']:.3e} "
            f"(tol {PATH_LOGITS_TOL['float32']}), {hk.shape[0]} final states max|diff| "
            f"{s_diff:.3e} (tol {SSM_PATH_TOL}), top-1 {row['top1_kernel']} vs "
            f"{row['top1_plain']}  {'ok' if row['ok'] else 'FAIL'}  [{card}]")
    check(ok, "full-width fp32 Jamba prefill: the kernel path disagrees with the plain path")

    toks = torch.as_tensor(prompts[-1], device="cuda")[None].long()
    continuity = {}
    for S in SSM_CONTINUITY_LENS:
        _, cache = model.prefill({"tokens": toks[:, :S]})
        pool = model.init_cache(1, S + 1, dtype=torch.float32)
        _write_slot(pool, cache, 0)
        stepped, _ = model.decode_step(toks[:, S:S + 1], pool, torch.tensor(S, device="cuda"))
        full, _ = model.prefill({"tokens": toks[:, :S + 1]})
        diff = (stepped - full)[0, :cfg.vocab_size].abs().max().item()
        continuity[S] = diff
        say(f"[hybrid paths] decode continuity fp32: prefill({S}) + decode_step(token {S}) vs "
            f"prefill({S + 1}): logits max|diff| {diff:.3e} (tol {SSM_PATH_TOL})  "
            f"{'ok' if diff <= SSM_PATH_TOL else 'FAIL'}  [{card}]")
        check(diff <= SSM_PATH_TOL, f"Jamba decode after prefill({S}) parts from "
                                    f"prefill({S + 1})")
    del cache, pool, stepped, full

    # the same weights rounded to bf16, one leaf at a time (the fp32 leaf
    # freed as its copy is made, so the two models never share the card)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", activ_dtype="bfloat16")

    def rounded(tree, layout):
        for key, spec in layout.items():
            if isinstance(spec, Leaf):
                tree[key] = tree[key].to(spec.dtype)
            else:
                rounded(tree[key], spec)

    rounded(model.params, param_layout(cfg16))
    model.cfg = cfg16
    bf16 = [_path_logits(model, p) for p in prompts]
    check_bf16 = _bf16_router_check("[hybrid paths]", SSM_PROMPT_LENS, bf16, card)
    rms = lambda a, b: (a - b).pow(2).mean().sqrt().item()   # noqa: E731
    dev = {name: [rms(l16[name][0], l32) for l16, l32 in zip(bf16, fp32)] for name in PATHS}
    mean = {name: float(np.mean(v)) for name, v in dev.items()}
    limit = BF16_PATH_RATIO * max(mean["plain"], mean["plain_tiled"])
    for name in PATHS:
        say(f"[hybrid paths] bf16 {name} path vs fp32 plain logits, rms per prompt: "
            + " ".join(f"{v:.4f}" for v in dev[name]) + f"; mean {mean[name]:.4f}")
    say(f"[hybrid paths] bf16 kernel path mean rms {mean['kernel']:.4f} vs limit {limit:.4f} "
        f"({BF16_PATH_RATIO} x the plain paths')  [{card}]")
    check(mean["kernel"] <= limit, "full-width bf16 Jamba prefill: the kernel path strays "
                                   "further from fp32 than the plain paths do")
    del model
    free_device()
    return {"layers": cfg.num_layers, "params": n_params, "prompts": rows,
            "decode_continuity_max_diff": continuity, "bf16_prompts": check_bf16,
            "bf16_rms_vs_fp32": dev, "bf16_mean_rms_vs_fp32": mean, "bf16_kernel_limit": limit}


def _bf16_router_check(tag, prompt_lens, paths, card):
    """bf16 prefills, kernel path against plain path, per prompt: up to the
    first layer whose MoE routing differs (every layer where it never does)
    the router logits agree within `ROUTER_TOL`. The final logits and SSM
    states are shown beside it: in bf16 they part for any routing split and
    for a rounding carried on through the Mamba layers, so only the rms
    against fp32 (`phase_hybrid_paths`) holds them."""
    rows, ok = [], True
    for S, lg in zip(prompt_lens, paths):
        (lk, rk, hk), (lp, rp, hp) = lg["kernel"], lg["plain"]
        layer, rdiff, n, gap = routing_split(rk, rp)
        row = {"dtype": "bfloat16", "S": S, "split_layer": layer, "split_tokens": n,
               "split_gap": gap, "router_max_diff": rdiff,
               "logits_max_diff": (lk - lp).abs().max().item(),
               "states_max_diff": (hk - hp).abs().max().item(),
               "top1_kernel": int(lk.argmax()), "top1_plain": int(lp.argmax()),
               "ok": rdiff <= ROUTER_TOL["bfloat16"]}
        ok &= row["ok"]
        rows.append(row)
        split = "none" if layer is None else f"layer {layer}, {n} tokens, gap {gap:.2e}"
        say(f"{tag} bfloat16 S={S}: split {split}; router {rdiff:.2e} "
            f"(tol {ROUTER_TOL['bfloat16']}); logits max|diff| {row['logits_max_diff']:.3e}, "
            f"{hk.shape[0]} final states max|diff| {row['states_max_diff']:.3e}, top-1 "
            f"{row['top1_kernel']} vs {row['top1_plain']}  {'ok' if row['ok'] else 'FAIL'}  "
            f"[{card}]")
    check(ok, f"{tag} bf16 prefill: the router logits of the kernel path part from the "
              "plain path's before the routing does")
    return rows


def phase_families(card):
    """The other decoder families served at full width (bf16, random
    weights from seed 0), each freed before the next is built:

    - Jamba-v0.1 (`HYBRID_SERVE_LAYERS` of 32 layers) on the slot-granular
      pool, 8 requests over 4 slots at the SSM prompt lengths: flash, MoE
      top-k and the SSD scan at their per-period counts in every prefill,
      the profiled run, each prompt's bf16 kernel path held to its plain
      path (`_bf16_router_check`); then `phase_hybrid_paths`;
    - MiniCPM3-4B (MLA) on the paged pool over its latent cache: absorbed
      decode through the decode graph, no kernel launched;
    - Qwen2-VL-2B's text backbone (M-RoPE) on the paged pool: flash once
      per layer per prefill.

    Each as `phase_serve` (decode graph replayed after the first step, run
    2 equal to run 1, run 4 held to the eager plain decode step)."""
    out = {}
    launches, out[HYBRID_ARCH], paths = phase_serve(
        card, HYBRID_ARCH, SSM_PROMPT_LENS, functools.partial(_path_logits,
                                                              paths=("kernel", "plain")),
        ("flash_fwd_kernel", "moe_topk_kernel", "ssd_scan_kernel"), paged=False,
        tag="[hybrid serve]", layers=HYBRID_SERVE_LAYERS, n_slots=4, s_max=1024)
    out[HYBRID_ARCH]["launches"] = launches
    out[HYBRID_ARCH]["bf16_paths"] = _bf16_router_check("[hybrid serve]", SSM_PROMPT_LENS,
                                                        paths, card)
    del paths
    free_device()
    out[HYBRID_ARCH]["paths"] = phase_hybrid_paths(card)
    for arch, tag in ((MLA_ARCH, "[mla serve]"), (MROPE_ARCH, "[mrope serve]")):
        launches, out[arch], _ = phase_serve(
            card, arch, SERVE_PROMPT_LENS, functools.partial(_path_logits, paths=("kernel",)),
            None, paged=True, tag=tag, n_slots=8, s_max=512, page_size=16)
        out[arch]["launches"] = launches
        free_device()
    return out


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


def held_bytes(engines=()):
    """`torch.cuda.memory_allocated` with cuBLAS's workspaces left out, read
    where nothing runs: cuBLAS keeps one per (thread's handle, stream) for
    the process (made anew at next use), and a run's first spawn is the
    first cuBLAS work of its PREPARE worker thread. torch's own leak check
    does the same. The pools of the prefill graphs installed on ``engines``
    (live engines, which hold what their last PREPARE built for as long as
    they serve: an engine that retires frees them) are left out too and
    counted apart. Returns (held, allocated before the workspaces went, the
    held blocks counted by (size, memory pool), the bytes of the installed
    prefill pools)."""
    import torch
    pools = {str(tuple(exe.graph.pool())) for eng in engines
             for table in eng.prefill_executables for exe in table.values()
             if exe is not None and exe.graph is not None}
    gc.collect()
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    blocks, installed = {}, 0
    for seg in torch.cuda.memory_snapshot():
        pool = str(tuple(seg.get("segment_pool_id", ())))
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                key = (b["size"], pool)
                blocks[key] = blocks.get(key, 0) + 1
                installed += b["size"] if pool in pools else 0
    return torch.cuda.memory_allocated() - installed, raw - installed, blocks, installed


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
        # each spawn's counts from the moment it joins (its commit verifies
        # its collectives first): a spawn can join and be retired inside one
        # scaler tick, between two samples
        verify = cluster.verify_engine_collectives

        def verified(name, *args, **kwargs):
            out = verify(name, *args, **kwargs)
            log["stats"][name] = cluster.engine(name).decode_stats
            return out

        cluster.verify_engine_collectives = verified

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
                    log["mem"] = held_bytes(            # before the first spawn
                        [cluster.engine(n) for n in cluster.engines()])
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
        mem_end = held_bytes([cluster.engine(n) for n in cluster.engines()])
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
              f"first spawn (without, with cuBLAS's workspaces; blocks; the live engines' "
              f"installed prefill pools, left out): {mem_delta:+d} bytes, more than a page "
              f"({page_bytes})")

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
               "mem_installed_prefill": [log["mem"][3], mem_end[3]],
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
            f"(a page is {page_bytes}; cuBLAS's workspaces {out['mem_workspaces']} bytes and "
            f"the live engines' installed prefill graph pools {out['mem_installed_prefill']} "
            f"bytes then and there, not counted)  [{card}]")
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
    want_l = launches_per_prefill(cfg, len(prompts))
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


# ---------------------------------------------------------------------------
# the training side
# ---------------------------------------------------------------------------

# Constant AdamW LRs under which a handful of steps shows each model's loss
# falling from its random start (`tools/train_first_steps.py` sweeps 1e-5,
# 3e-5, 1e-4 and the reference example's warmup_cosine(3e-4, 20, 100) over
# 8 steps). Adam's first step moves every weight by ~lr sign(g); at
# Minitron's init it sends the loss from ~13 to 31-38 at every LR of the
# sweep, and the next steps bring it back below its start.
TRAIN_LR = {"minitron_4b": 1e-4, "mamba2_370m": 1e-4, "whisper_large_v3": 1e-5}
TRAIN_ARCH = "minitron_4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_CHUNK = 2, 1024, 256
TRAIN_STEPS = 8                 # the first is the warm-up; the rest are timed
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 4, 1024
# Mamba2's run: 8 steps, a checkpoint every 5, a failure at step 6 (after the
# checkpoint at 5), a straggler at step 4 slowed by 4x the warm step time:
# three saves in all (the uninterrupted run's final, the failed run's 5 and 8)
SSM_TRAIN_STEPS, SSM_CKPT_EVERY, SSM_FAIL_AT = 8, 5, 6
SSM_SLOW_STEP, SSM_SLOW_FACTOR = 4, 4.0
WHISPER_ARCH = "whisper_large_v3"
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 2, 448, 6
WHISPER_PROMPT_LEN, WHISPER_NEW_TOKENS = 128, 8
WHISPER_PATH_TOL = 1e-3         # fp32 prefill logits, kernel vs plain (atol = rtol)


def train_flops(cfg, B, S):
    """Model FLOPs of one train step over ``B x S`` target tokens: three
    forwards (the backward costs two), recompute not counted. A forward:
    2 x tokens x each matmul weight (the depthwise conv's too), the tied or
    untied logits, the attention products (two per pair, causal pairs only
    where causal), the SSD scan's products (`ssd_work`); an enc-dec model's
    encoder and cross K/V run over the ``F`` frames."""
    import math

    from repro_torch import tree as tree_util
    from repro_torch.models import encdec, lm, ssm
    from repro_torch.models.common import padded_vocab

    def weights(tree, keep=lambda path: True):
        return sum(math.prod(leaf.shape) for path, leaf in tree_util.items(tree)
                   if leaf.stacked and len(leaf.shape) == 3 and keep(path))

    H, D = cfg.num_heads, cfg.resolved_head_dim
    fwd = 2 * B * S * cfg.d_model * padded_vocab(cfg.vocab_size)
    if cfg.encdec is not None:
        F_enc, L_enc = cfg.encdec.encoder_seq_len, cfg.encdec.num_encoder_layers
        lay = encdec.param_layout(cfg)
        cross_kv = weights(lay["dec_layers"], lambda p: p in ("cross_attn/wk", "cross_attn/wv"))
        fwd += 2 * B * (F_enc * (weights(lay["enc_layers"]) + cross_kv)
                        + S * (weights(lay["dec_layers"]) - cross_kv))
        fwd += B * H * D * (4 * L_enc * F_enc * F_enc
                            + cfg.num_layers * (2 * S * (S + 1) + 4 * S * F_enc))
        return 3 * fwd
    fwd += 2 * B * S * weights(lm.param_layout(cfg)["layers"])
    kinds, steps = lm.layer_kinds(cfg), lm.n_scan_steps(cfg)
    fwd += steps * sum(m == "attn" for m, _ in kinds) * 2 * B * H * D * S * (S + 1)
    n_ssm = steps * sum(m == "ssm" for m, _ in kinds)
    if n_ssm:
        _, Hs, P, N, _ = ssm.ssm_dims(cfg)
        fwd += n_ssm * ssd_work(B, S, Hs, cfg.ssm.n_groups, P, N, cfg.ssm.chunk_size, 2)[1]
    return 3 * fwd


def _train_setup(arch, **model_kw):
    """Full-width ``arch`` (bf16, random weights from seed 0), AdamW with
    fp32 moments, and the train step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    model = Model(get_config(arch), device="cuda", seed=0, **model_kw)
    opt = AdamW(lr=TRAIN_LR[arch])
    return model, opt.init(model.params), make_train_step(model, opt)


def _timed_steps(step_fn, params, opt_state, batches):
    """Drive ``step_fn`` over ``batches`` (made before the clock starts):
    (losses, wall seconds per step, each ending in the loss's host read)."""
    import torch
    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss, _ = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return losses, times


def _profiled_step(tag, step_fn, params, opt_state, batch, card, top=5):
    """One more train step under `torch.profiler`: its wall time, the
    device's busy share of it and the kernels that took the most device
    time (the profiler's own host work is inside the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss, _ = step_fn(params, opt_state, batch)
        float(loss)
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    say(f"{tag} profiled step: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
        f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} %), "
        f"{sum(r[1] for r in rows)} kernels; top: " + "; ".join(
            f"{d / 1e3:.1f} ms {c}x {k[:48]}" for d, c, k in rows[:top]) + f"  [{card}]")
    return {"wall_s": wall, "device_busy_s": busy, "kernels": sum(r[1] for r in rows),
            "top": [{"device_ms": d / 1e3, "calls": c, "name": k} for d, c, k in rows[:top]]}


def _train_figures(tag, cfg, B, S, losses, times, peak, card):
    """Print and return a run's step time (median of the warm steps),
    tokens/s, model FLOPs against the card's bf16 peak and peak memory."""
    step_s = float(np.median(times[1:]))
    flops = train_flops(cfg, B, S)
    fig = {"losses": losses, "step_s": times, "warm_step_s": step_s,
           "tokens_per_s": B * S / step_s, "model_flops": flops,
           "flops_share": flops / step_s / PEAK_OPS_PER_S["bfloat16"], "peak_bytes": peak}
    say(f"{tag} {cfg.name} B={B} S={S}: warm step {step_s * 1e3:.1f} ms (median of "
        f"{len(times) - 1}; all " + " ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms), {fig['tokens_per_s']:.0f} tokens/s, model FLOPs {flops:.3e} a step = "
        f"{100 * fig['flops_share']:.1f} % of the bf16 peak, peak memory "
        f"{peak / 1e9:.2f} GB; losses " + " ".join(f"{x:.4f}" for x in losses) + f"  [{card}]")
    check(all(np.isfinite(losses)), f"{tag} a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{tag} the loss did not fall: {losses}")
    return fig


def _train_dense(card):
    """(a) Minitron-4B, all 32 layers: `TRAIN_STEPS` steps of the train step
    driven directly (a runner's final save would write ~50 GB), remat
    "nothing"; then one step under "dots" and one under "nothing" again,
    each in parts with its own peaks, and a profiled loss-and-gradients
    under each; then a profiled step."""
    import torch

    from repro_torch.data import SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    model, opt_state, step_fn = _train_setup(TRAIN_ARCH, loss_chunk=TRAIN_LOSS_CHUNK)
    cfg = model.cfg
    ds = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0, device=model.device)
    state_bytes = sum(t.numel() * t.element_size() for t in _leaves(model.params)) + sum(
        t.numel() * t.element_size() for t in _leaves(opt_state))
    torch.cuda.reset_peak_memory_stats()
    losses, times = _timed_steps(step_fn, model.params, opt_state,
                                 [ds.batch_at(i) for i in range(TRAIN_STEPS)])
    fig = _train_figures("[train dense]", cfg, TRAIN_BATCH, TRAIN_SEQ, losses, times,
                         torch.cuda.max_memory_allocated(), card)
    fig["state_bytes"] = state_bytes
    # one more step under each remat policy, in its two parts: loss and
    # gradients, then AdamW (its fp32 copies of a leaf set the step's peak,
    # the same under both). What a policy saves is held at the end of the
    # forward (above the state held before it); the gradients, all alive at
    # the end of the backward, set that part's peak. Then one profiled
    # loss-and-gradients each
    from repro_torch import tree as tree_util
    from repro_torch.launch.steps import _loss_and_grads
    policies = {}
    opt = AdamW(lr=TRAIN_LR[TRAIN_ARCH])
    for i, policy in enumerate(("dots", "nothing")):
        other = Model(cfg, model.params, device=model.device, remat_policy=policy,
                      loss_chunk=TRAIN_LOSS_CHUNK)
        batch = ds.batch_at(TRAIN_STEPS + i)
        free_device()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = [p.detach().requires_grad_(True) for p in tree_util.leaves(model.params)]
        with torch.enable_grad():
            loss, _ = other.train_loss(batch, params=tree_util.like(model.params, leaves))
            saved = torch.cuda.memory_allocated() - held
            grads = torch.autograd.grad(loss, leaves)
        del leaves
        loss = float(loss)
        t1 = time.perf_counter()
        grads_peak = torch.cuda.max_memory_allocated()
        opt.update(tree_util.like(model.params, grads), opt_state, model.params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        check(np.isfinite(loss), f"[train dense] remat {policy}: loss {loss}")
        policies[policy] = {"loss": loss, "loss_and_grads_s": t1 - t0, "adamw_s": t2 - t1,
                            "step_s": t2 - t0, "held_bytes": held, "saved_bytes": saved,
                            "grads_peak_bytes": grads_peak,
                            "peak_bytes": torch.cuda.max_memory_allocated()}
    for i, policy in enumerate(("dots", "nothing")):
        other = Model(cfg, model.params, device=model.device, remat_policy=policy,
                      loss_chunk=TRAIN_LOSS_CHUNK)
        policies[policy]["profile"] = _profiled_step(
            f"[train dense] remat {policy} (loss and gradients only)",
            lambda p, s, b, m=other: (p, s, _loss_and_grads(m, p, b)[0], None),
            model.params, opt_state, ds.batch_at(TRAIN_STEPS + 2 + i), card)
        free_device()
    say(f"[train dense] state (params bf16 + fp32 m, v) {state_bytes / 1e9:.2f} GB; one step "
        "each in parts, remat " + "; ".join(
            f"{p}: loss and gradients {v['loss_and_grads_s'] * 1e3:.1f} ms, "
            f"{v['saved_bytes'] / 1e9:.2f} GB saved by the forward and a peak "
            f"{(v['grads_peak_bytes'] - v['held_bytes']) / 1e9:.2f} GB, both above the "
            f"{v['held_bytes'] / 1e9:.2f} GB held; AdamW in place {v['adamw_s'] * 1e3:.1f} ms, "
            f"step peak {v['peak_bytes'] / 1e9:.2f} GB" for p, v in policies.items())
        + f"  [{card}]")
    fig["remat"] = policies
    fig["parts_s"] = {"loss_and_grads": policies["nothing"]["loss_and_grads_s"],
                      "adamw": policies["nothing"]["adamw_s"]}
    fig["profile"] = _profiled_step("[train dense]", step_fn, model.params, opt_state,
                                    ds.batch_at(TRAIN_STEPS + 4), card)
    del model, opt_state, step_fn
    free_device()
    return fig


def _host_copy(tree):
    from repro_torch import tree as tree_util
    return {name: t.detach().cpu().clone() for name, t in tree_util.items(tree)}


def _train_recovery(card):
    """(b) Mamba2-370m, all 48 layers, under deterministic algorithms: an
    uninterrupted `TrainRunner` run, then a fresh one that checkpoints,
    meets a straggler and fails mid-run, and `recover_and_run`s from its
    last periodic checkpoint. The restored state must equal the saved one
    bit for bit, the recovered losses the uninterrupted run's, and the
    straggler must be flagged."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import latest_step
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import TrainRunner
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        def runner(ckpt_dir, ckpt_every):
            model, opt_state, step_fn = _train_setup(SSM_ARCH, loss_chunk=TRAIN_LOSS_CHUNK)
            ds = SyntheticLM(model.cfg.vocab_size, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, seed=0,
                             device=model.device)
            return model.cfg, TrainRunner(step_fn=step_fn, params=model.params,
                                          opt_state=opt_state, dataset=ds,
                                          ckpt_dir=root / ckpt_dir, ckpt_every=ckpt_every)

        cfg, plain = runner("plain", 10 * SSM_TRAIN_STEPS)
        step_times, observe = [], plain.monitor.observe
        plain.monitor.observe = lambda step, dt: observe(step, step_times.append(dt) or dt)
        torch.cuda.reset_peak_memory_stats()
        plain.run(SSM_TRAIN_STEPS)
        fig = _train_figures("[train ssm]", cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, plain.losses,
                             step_times, torch.cuda.max_memory_allocated(), card)
        warm = fig["warm_step_s"]
        del plain
        gc.collect()

        cfg, failing = runner("failing", SSM_CKPT_EVERY)
        saved, timings = {}, {"save_s": [], "restore_s": []}
        save, restore = failing._save, failing.try_restore

        def timed_save():
            if failing.step == SSM_CKPT_EVERY:
                saved["params"], saved["opt"] = (_host_copy(failing.params),
                                                 _host_copy(failing.opt_state))
            torch.cuda.synchronize()
            t = time.perf_counter()
            save()
            timings["save_s"].append(time.perf_counter() - t)

        def timed_restore(**kw):
            t = time.perf_counter()
            ok = restore(**kw)
            torch.cuda.synchronize()
            timings["restore_s"].append(time.perf_counter() - t)
            check(ok and failing.step == SSM_CKPT_EVERY,
                  f"[train ssm] restored step {failing.step}, want {SSM_CKPT_EVERY}")
            for key, tree in (("params", failing.params), ("opt", failing.opt_state)):
                for name, t in tree_util.items(tree):
                    check(torch.equal(t.cpu(), saved[key][name]),
                          f"[train ssm] restored {key}/{name} differs from the saved state")
            return ok

        failing._save, failing.try_restore = timed_save, timed_restore
        slow = {SSM_SLOW_STEP: SSM_SLOW_FACTOR * warm}
        try:
            failing.run(SSM_TRAIN_STEPS, fail_at=SSM_FAIL_AT, slow_steps=slow)
            check(False, "[train ssm] the injected failure did not raise")
        except RuntimeError as e:
            check("simulated node failure" in str(e), f"[train ssm] {e}")
        check(latest_step(failing.ckpt_dir) == SSM_CKPT_EVERY,
              f"[train ssm] last checkpoint {latest_step(failing.ckpt_dir)}, "
              f"want {SSM_CKPT_EVERY}")
        out = failing.recover_and_run(SSM_TRAIN_STEPS)
        last = failing.ckpt_dir / f"step_{SSM_TRAIN_STEPS:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in last.iterdir())
        check(out["steps"] == SSM_TRAIN_STEPS and out["restarts"] == 1, f"[train ssm] {out}")
        # the failed run's losses: steps 0 .. FAIL_AT-1, then CKPT_EVERY .. end again
        first, resumed = failing.losses[:SSM_FAIL_AT], failing.losses[SSM_FAIL_AT:]
        want = fig["losses"]
        check(first == want[:SSM_FAIL_AT] and resumed == want[SSM_CKPT_EVERY:],
              f"[train ssm] losses {failing.losses} differ from the uninterrupted run's {want}")
        flagged = [r for r in failing.monitor.flagged if r.step == SSM_SLOW_STEP]
        check(bool(flagged), f"[train ssm] the straggler at step {SSM_SLOW_STEP} was not "
                             f"flagged: {failing.monitor.flagged}")
        rep = flagged[0]
        say(f"[train ssm] failure at step {SSM_FAIL_AT}, resumed from checkpoint "
            f"{SSM_CKPT_EVERY}: restored state equals the saved state bit for bit; the "
            f"recovered losses equal the uninterrupted run's bit for bit (deterministic "
            f"algorithms); a checkpoint {ckpt_bytes / 1e9:.2f} GB on disk, saves "
            + " ".join(f"{t:.2f}" for t in timings["save_s"]) + " s, restore "
            + " ".join(f"{t:.2f}" for t in timings["restore_s"]) + f" s; straggler at step "
            f"{rep.step}: {rep.step_time_s:.3f} s against an EWMA of {rep.ewma_s:.3f} s "
            f"({rep.slowdown:.1f}x)  [{card}]")
        fig["profile"] = _profiled_step("[train ssm]", failing.step_fn, failing.params,
                                        failing.opt_state,
                                        failing.dataset.batch_at(SSM_TRAIN_STEPS), card)
        fig.update(timings, checkpoint_bytes=ckpt_bytes, restarts=out["restarts"],
                   straggler={"step": rep.step, "step_s": rep.step_time_s,
                              "ewma_s": rep.ewma_s, "slowdown": rep.slowdown},
                   disk_free_bytes=shutil.disk_usage(root).free)
        del failing
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
        free_device()
    return fig


def _whisper_greedy(model, batch, n_new):
    """Prefill ``batch`` and decode ``n_new`` greedy tokens from a bf16
    cache: (prefill logits, every step's logits, the tokens, the launches
    of the prefill and of the decode)."""
    import torch

    from repro_torch.kernels import ops
    tokens = batch["tokens"]
    S = tokens.shape[1]
    ops.reset_launches()
    logits, pre = model.prefill(batch)
    torch.cuda.synchronize()
    prefill_launches = dict(ops.LAUNCHES)
    cache = model.init_cache(1, S + n_new, enc_len=batch["frames"].shape[1])
    for key, t in pre.items():
        cache[key][:, :, :t.shape[2]] = t
    ops.reset_launches()
    steps, out = [logits], []
    for i in range(n_new):
        nxt = steps[-1].argmax(dim=-1, keepdim=True).to(torch.int32)
        out.append(int(nxt[0, 0]))
        lg, cache = model.decode_step(nxt, cache, torch.tensor(S + i, device=model.device))
        steps.append(lg)
    torch.cuda.synchronize()
    return logits, torch.stack(steps), out, prefill_launches, dict(ops.LAUNCHES)


def _train_whisper(card):
    """(c) Whisper-large-v3 (32 + 32 layers, d 1280; 1500 frames): a few
    train steps with the loss falling; then a bf16 prefill and greedy
    decode, twice: flash launches once per decoder layer per prefill (the
    decoder's causal self-attention; the encoder and cross-attention are
    bidirectional, plain `sdpa`), never in decode, and run 2 equals run 1;
    then the weights in fp32, the prefill's kernel path held to its plain
    path (logits within `WHISPER_PATH_TOL`)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import Model
    from repro_torch.models.common import padded_vocab
    model, opt_state, step_fn = _train_setup(WHISPER_ARCH)
    cfg = model.cfg
    cell = ShapeCell("whisper_train", "train", WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    losses, times = _timed_steps(step_fn, model.params, opt_state,
                                 [make_batch(cfg, cell, step=i, device=model.device)
                                  for i in range(WHISPER_TRAIN_STEPS)])
    fig = _train_figures("[train whisper]", cfg, WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ,
                         losses, times, torch.cuda.max_memory_allocated(), card)
    fig["profile"] = _profiled_step("[train whisper]", step_fn, model.params, opt_state,
                                    make_batch(cfg, cell, step=WHISPER_TRAIN_STEPS,
                                               device=model.device), card)
    del opt_state, step_fn
    free_device()

    prompt = make_batch(cfg, ShapeCell("whisper_prompt", "prefill", WHISPER_PROMPT_LEN, 1),
                        step=0, seed=1, device=model.device)
    batch = {"frames": prompt["frames"], "tokens": prompt["tokens"][:, :WHISPER_PROMPT_LEN]}
    runs = []
    with torch.no_grad():
        for _ in range(2):
            runs.append(_whisper_greedy(model, batch, WHISPER_NEW_TOKENS))
    (lg1, steps1, toks1, pre1, dec1), (lg2, steps2, toks2, _, _) = runs
    want = {"flash_attention": cfg.num_layers, "moe_topk": 0, "ssd_scan": 0}
    check(pre1 == want, f"[whisper] prefill launched {pre1}, want {want}")
    check(not any(dec1.values()), f"[whisper] decode launched {dec1}")
    V = padded_vocab(cfg.vocab_size)
    check(tuple(steps1.shape) == (WHISPER_NEW_TOKENS + 1, 1, V)
          and bool(torch.isfinite(steps1).all()), "[whisper] logits: shape or not finite")
    check(toks1 == toks2 and torch.equal(steps1, steps2), "[whisper] run 2 differs from run 1")
    say(f"[whisper] bf16 prefill of {WHISPER_PROMPT_LEN} tokens over {cfg.encdec.encoder_seq_len} "
        f"frames + {WHISPER_NEW_TOKENS} greedy tokens {toks1}: launches {pre1} a prefill, "
        f"{dec1} in decode; run 2 equals run 1 (tokens, logits)  [{card}]")
    fig.update(prefill_launches=pre1, tokens=toks1)
    fig["flash_time"] = _flash_timed(torch.Generator(device=model.device).manual_seed(0),
                                     WHISPER_PROMPT_LEN, cfg.num_heads, cfg.num_kv_heads,
                                     card, "whisper", D=cfg.resolved_head_dim)
    del model, runs, lg1, lg2, steps1, steps2
    free_device()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")
    model = Model(cfg32, device="cuda", seed=0)
    paths = {}
    with torch.no_grad():
        for name in ("kernel", "plain"):
            chunks = None if name == "kernel" else {}
            before = dict(ops.LAUNCHES)
            with routed(ops, ref, chunks, []):
                logits, _ = model.prefill(batch)
            torch.cuda.synchronize()
            n = ops.LAUNCHES["flash_attention"] - before["flash_attention"]
            check(n == (cfg.num_layers if chunks is None else 0),
                  f"[whisper paths] the {name} path launched flash {n} times")
            paths[name] = logits[0, :cfg.vocab_size].float()
    ok, err = within(paths["kernel"], paths["plain"], WHISPER_PATH_TOL)
    say(f"[whisper paths] fp32 prefill, kernel vs plain path: logits max|diff| {err:.3e} "
        f"(atol = rtol {WHISPER_PATH_TOL}), top-1 {int(paths['kernel'].argmax())} vs "
        f"{int(paths['plain'].argmax())}  {'ok' if ok else 'FAIL'}  [{card}]")
    check(ok, "[whisper paths] the kernel path disagrees with the plain path")
    fig["paths_max_diff"] = err
    del model, paths
    free_device()
    return fig


def phase_train(card):
    """The training side at full width: (a) Minitron-4B, (b) Mamba2-370m
    with a failure, recovery and a straggler, (c) Whisper-large-v3 with its
    prefill and decode; each freed before the next."""
    return {TRAIN_ARCH: _train_dense(card), SSM_ARCH: _train_recovery(card),
            WHISPER_ARCH: _train_whisper(card)}


SHARDED_PROMPT_LENS = (17, 384)
SHARDED_DECODE_STEPS = 8


@contextlib.contextmanager
def one_rank_group(backend: str = "nccl"):
    """A one-rank process group over a FileStore under a fresh temp dir (no
    network), destroyed (and the dir removed) on exit."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1, **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def _sharded_stream(card, device="cuda"):
    """The data stream on the card against the CPU's, bit for bit: the train
    phase's Minitron batches and Whisper's bf16 frames."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import make_batch
    t0 = time.perf_counter()
    n = 0
    for arch, (B, S) in ((TRAIN_ARCH, (TRAIN_BATCH, TRAIN_SEQ)),
                         (WHISPER_ARCH, (WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ))):
        cfg, cell = get_config(arch), ShapeCell("train", "train", S, B)
        for step in (0, 1):
            dev = make_batch(cfg, cell, step=step, device=device)
            cpu = make_batch(cfg, cell, step=step, device="cpu")
            for k in cpu:
                check(_bits_equal(dev[k], cpu[k]),
                      f"[sharded] {arch} step {step} {k}: the card's stream is not the CPU's")
                n += cpu[k].numel()
    say(f"[sharded] data stream: the card's Minitron tokens and loss masks and Whisper's "
        f"bf16 frames equal the CPU's bit for bit ({n} values, steps 0 and 1) in "
        f"{time.perf_counter() - t0:.2f} s  [{card}]")
    return {"values": n}


def _padded_cache(model, cache, s_max):
    """A prefill cache written into a fresh bf16 decode cache of ``s_max``."""
    from repro_torch.models.lm import is_positional
    out = model.init_cache(1, s_max)
    for k, v in cache.items():
        if is_positional(k):
            out[k][:, :, :v.shape[2]] = v
        else:
            out[k].copy_(v)
    return out


def _sharded_serve(card, mesh, cfg):
    """Sharded prefill and greedy decode of ``cfg`` against the unsharded
    model on the same weights: logits, caches and tokens bit for bit; the
    launches of each sharded prefill; the collectives of one decode step."""
    from collections import Counter

    import torch

    from repro_torch.configs import ShapeCell
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import jit_decode_step, jit_prefill, named
    from repro_torch.models import Model
    from repro_torch.serving.engine import trace_collectives
    from repro_torch.sharding import default_plan, param_specs
    from repro_torch.sharding.ctx import full, is_dtensor, place_tree
    plan = default_plan()
    model = Model(cfg, device="cuda", seed=0)
    params = place_tree(model.params, named(mesh, param_specs(cfg, plan)))
    check(all(is_dtensor(v) for v in _leaves(params)), "[sharded] params are not DTensors")
    rng = np.random.default_rng(21)
    want = launches_per_prefill(cfg, 1)
    out = {"launches": [], "prefill_s": [], "plain_prefill_s": [], "decode_s": []}
    torch.cuda.reset_peak_memory_stats()
    for S in SHARDED_PROMPT_LENS:
        batch = {"tokens": torch.tensor(rng.integers(2, cfg.vocab_size, size=(1, S)),
                                        dtype=torch.int32, device="cuda")}
        s_max = S + SHARDED_DECODE_STEPS + 1
        prefill = jit_prefill(model, mesh, plan, ShapeCell("prefill", "prefill", S, 1))
        decode = jit_decode_step(model, mesh, plan, ShapeCell("decode", "decode", s_max, 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            ref_logits, ref_cache = model.prefill(batch)
        torch.cuda.synchronize()
        out["plain_prefill_s"].append(time.perf_counter() - t0)
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        out["prefill_s"].append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCHES)
        out["launches"].append(launches)
        check(launches == want, f"[sharded] prefill S={S} launched {launches}, want {want}")
        check(is_dtensor(logits) and all(is_dtensor(v) for v in cache.values()),
              "[sharded] prefill outputs are not DTensors")
        check(_bits_equal(full(logits), ref_logits),
              f"[sharded] prefill S={S}: logits differ from the unsharded prefill's")
        for k, v in cache.items():
            check(_bits_equal(full(v), ref_cache[k]),
                  f"[sharded] prefill S={S}: cache {k} differs from the unsharded prefill's")
        ref_c = _padded_cache(model, ref_cache, s_max)
        sh_c = _padded_cache(model, {k: full(v) for k, v in cache.items()}, s_max)
        ref_tok, tok = ref_logits.argmax(-1), full(logits).argmax(-1)
        ref_stream, stream = [int(ref_tok)], [int(tok)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SHARDED_DECODE_STEPS):
            pos = torch.tensor(S + i, device="cuda")
            with torch.no_grad():
                ref_logits, ref_c = model.decode_step(ref_tok[:, None].to(torch.int32), ref_c, pos)
            logits, sh_c = decode(params, tok[:, None].to(torch.int32), sh_c, pos)
            check(_bits_equal(full(logits), ref_logits),
                  f"[sharded] decode step {i} after S={S}: logits differ from the unsharded step's")
            ref_tok, tok = ref_logits.argmax(-1), full(logits).argmax(-1)
            ref_stream.append(int(ref_tok))
            stream.append(int(tok))
        torch.cuda.synchronize()
        out["decode_s"].append((time.perf_counter() - t0) / SHARDED_DECODE_STEPS)
        check(stream == ref_stream, f"[sharded] S={S}: stream {stream} != {ref_stream}")
        say(f"[sharded] {cfg.name} S={S}: prefill launches {launches}; logits, "
            f"{len(cache)} cache leaves and {SHARDED_DECODE_STEPS} greedy decode steps "
            f"equal to the unsharded model's bit for bit; prefill sharded "
            f"{out['prefill_s'][-1] * 1e3:.1f} ms, unsharded "
            f"{out['plain_prefill_s'][-1] * 1e3:.1f} ms (eager, each after the other); "
            f"a decode step, both paths {out['decode_s'][-1] * 1e3:.1f} ms; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]")
        if S == SHARDED_PROMPT_LENS[-1]:
            colls = trace_collectives(
                lambda: decode(params, tok[:, None].to(torch.int32), sh_c,
                               torch.tensor(S + SHARDED_DECODE_STEPS, device="cuda")),
                torch.device("cuda"))
            by = Counter((c.op, c.ranks) for c in colls)
            out["collectives"] = [{"op": op, "ranks": ranks, "n": n}
                                  for (op, ranks), n in sorted(by.items(), key=str)]
            say(f"[sharded] one decode step's collectives, by op and group ranks: "
                + (", ".join(f"{op} {list(ranks) if ranks else ranks} x{n}"
                             for (op, ranks), n in sorted(by.items(), key=str))
                   or "none (every mesh dim holds one rank: DTensor moves nothing)")
                + f"  [{card}]")
        del cache, sh_c, ref_c, ref_cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _sharded_train(card, mesh, cfg, lr):
    """One sharded train step of ``cfg`` against `make_train_step`'s from
    the same weights and batch, under deterministic algorithms: loss, params
    and moments bit for bit; then a save and a restore under the mesh's
    shardings, bit for bit."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import jit_train_step, make_train_step, named
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.sharding import batch_specs, default_plan, opt_state_specs, param_specs
    from repro_torch.sharding.ctx import full, place_tree
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    plan = default_plan()
    B, S = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ
    cell = ShapeCell("train", "train", S, B)
    out = {}
    try:
        opt = AdamW(lr=lr)
        ds = SyntheticLM(cfg.vocab_size, S, B, seed=0, device="cuda")
        ref = Model(cfg, device="cuda", seed=0)
        ref_state = opt.init(ref.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, ref_loss, _ = make_train_step(ref, opt)(ref.params, ref_state, ds.batch_at(0))
        ref_loss = float(ref_loss)
        out["step_s"] = time.perf_counter() - t0
        model = Model(cfg, device="cuda", seed=0)
        pspecs = param_specs(cfg, plan)
        psh, osh = named(mesh, pspecs), named(mesh, opt_state_specs(pspecs))
        params = place_tree(model.params, psh)
        state = opt.init(params)
        step = jit_train_step(model, opt, mesh, plan, cell)
        batch = ds.sharded_batch_at(0, named(mesh, batch_specs(cfg, plan, cell)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss, _ = step(params, state, batch)
        loss = float(full(loss))
        out["sharded_step_s"] = time.perf_counter() - t0
        check(loss == ref_loss, f"[sharded train] loss {loss!r} != {ref_loss!r}")
        for key, got, want in (("params", params, ref.params), ("m", state["m"], ref_state["m"]),
                               ("v", state["v"], ref_state["v"])):
            for (name, g), (_, w) in zip(tree_util.items(got), tree_util.items(want)):
                check(_bits_equal(full(g), w), f"[sharded train] {key}/{name} differs from "
                                               "the unsharded step's")
        check(int(full(state["count"])) == int(ref_state["count"]) == 1,
              "[sharded train] step count")
        del ref, ref_state
        gc.collect()
        saved = {k: full(v).detach().cpu().clone()
                 for k, v in tree_util.items({"params": params, "opt": state})}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(root, 1, {"params": params, "opt": state})
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_no, restored = load_checkpoint(root, {"params": params, "opt": state},
                                            device="cuda", shardings={"params": psh, "opt": osh})
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        check(step_no == 1, f"[sharded train] restored step {step_no}")
        want_pl = {k: tuple(sh.placements) for k, sh in tree_util.items({"params": psh, "opt": osh})}
        for k, v in tree_util.items(restored):
            check(tuple(v.placements) == want_pl[k], f"[sharded train] restored {k} placements")
            check(_bits_equal(full(v), saved[k]),
                  f"[sharded train] restored {k} differs from the saved state")
        say(f"[sharded train] {cfg.name} B={B} x S={S}: one sharded step equals the unsharded "
            f"step bit for bit (loss {loss:.4f}, {len(saved) - 1} param and moment leaves); "
            f"unsharded {out['step_s']:.3f} s, sharded {out['sharded_step_s']:.3f} s (first "
            f"steps, eager); save {out['save_s']:.2f} s, restore under the mesh's shardings "
            f"{out['restore_s']:.2f} s, equal bit for bit  [{card}]")
        out["loss"] = loss
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    return out


#: the emulated tensor-parallel train step: the loss within this of the
#: whole step's (relative), and the first moments within atol 1e-7 + rtol
#: 1e-4 of it at all but this share of their coordinates (fp32 sums over
#: the two shards reassociate; no tf32)
TP_TRAIN_LOSS_REL = 1e-5
TP_TRAIN_M_SHARE = 1e-3


def _tp_train_emulated(card):
    """The tensor-parallel train step on the card, a model axis of 2
    emulated by two threads (`tools/tp_emulate.py`'s `train_case`): fp32
    Minitron-4B, Qwen1.5-MoE and Whisper-large-v3 (2 encoder layers too) at
    full width and 2 layers against the whole step; the loss and the first moments within `TP_TRAIN_LOSS_REL` and
    `TP_TRAIN_M_SHARE`, the replicated leaves' gradients equal on both
    threads, every group on its shard."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import tp_emulate
    dev = torch.device("cuda")
    out = {}
    for arch in tp_emulate.TRAIN_ARCHS:
        cfg, batch = tp_emulate.train_config(arch, dev, False)
        r = tp_emulate.train_case(dev, cfg, batch, tp_emulate.TRAIN_LR, card,
                                  "[sharded tp train emulated]",
                                  loss_chunk=tp_emulate.TRAIN_LOSS_CHUNK)
        for key in ("loss", "loss_rank1"):
            check(abs(r[key] - r["whole_loss"]) <= TP_TRAIN_LOSS_REL * abs(r["whole_loss"]),
                  f"[sharded tp train] {arch} {key} {r[key]} against the whole step's "
                  f"{r['whole_loss']}")
        check(r["m_outside"] <= TP_TRAIN_M_SHARE * r["m_total"],
              f"[sharded tp train] {arch}: m outside the tolerance at {r['m_outside']} of "
              f"{r['m_total']} coordinates")
        check(r["replicated_grads_equal"],
              f"[sharded tp train] {arch}: the replicated leaves' gradients differ between "
              "the two ranks")
        check(r["counts"].get("tp_local", 0) > 0 and not r["counts"].get("tp_gathered"),
              f"[sharded tp train] {arch}: groups ran gathered: {r['counts']}")
        out[arch] = r
        free_device()
    return out


def _tp_whisper_emulated(card):
    """Whisper-large-v3 served tensor-parallel on the card, a model axis of
    2 emulated by two threads (`tools/tp_emulate.py`'s `whisper_case`): fp32
    at full width, 2 encoder and 2 decoder layers, a prefill of 128 tokens
    over 1500 frames and 8 greedy decode steps against the whole model, each
    step's logits within `tp_emulate.DEC_REL` of its largest, picks equal,
    both threads' logits equal, every group on its shard, and flash launched
    once per decoder layer by each thread's prefill (on its 10 of the 20
    heads)."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import tp_emulate
    r = tp_emulate.whisper_case(torch.device("cuda"), False, card,
                                tag="[sharded tp whisper emulated]")
    for i, row in enumerate(r["steps"]):
        check(row["max_diff"] <= tp_emulate.DEC_REL * row["largest"] and row["picks_equal"],
              f"[sharded tp whisper] step {i}: {row}")
    check(r["ranks_agree"], "[sharded tp whisper] the two threads' logits differ")
    check(r["counts"].get("tp_local", 0) > 0 and not r["counts"].get("tp_gathered"),
          f"[sharded tp whisper] groups ran gathered: {r['counts']}")
    want = {"flash_attention": tp_emulate.N * tp_emulate.WHISPER_LAYERS, "moe_topk": 0,
            "ssd_scan": 0}
    check(r["launches"] == want, f"[sharded tp whisper] launches {r['launches']}, want {want}")
    free_device()
    return r


def _seq_decode_emulated(card):
    """Decode over a sequence-sharded cache on the card, a model axis of 2
    that cuts both the heads and the cache's sequence, emulated by two
    threads (`tools/tp_emulate.py`'s `decode_case`): fp32 Qwen1.5-MoE (heads
    local) and Minitron-4B (attention gathered) at full width, a few layers,
    8 greedy steps across the two halves of the cache against the whole
    model's decode from the same cache, each step's logits within
    `tp_emulate.DEC_REL` of its largest, picks equal; then the cache in
    fp8, against the whole model's fp8 decode on the CPU within
    `PATH_LOGITS_TOL`."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import tp_emulate
    dev = torch.device("cuda")
    out = {}
    for cache_dtype in (torch.float32, torch.float8_e4m3fn):
        for arch, layers, heads_local in tp_emulate.DEC_CASES:
            r = tp_emulate.decode_case(dev, arch, layers, heads_local, False, card,
                                       cache_dtype=cache_dtype,
                                       tag="[sharded seq decode emulated]")
            name = f"{arch} {str(cache_dtype)[6:]}"
            check(r["counts"].get("attn:seq_local") == layers * tp_emulate.DEC_NEW
                  and r["ranks_agree"],
                  f"[sharded seq decode] {name}: counts {r['counts']}, ranks agree "
                  f"{r['ranks_agree']}")
            for i, row in enumerate(r["steps"]):
                if cache_dtype == torch.float32:
                    check(row["max_diff"] <= tp_emulate.DEC_REL * row["largest"]
                          and row["picks_equal"], f"[sharded seq decode] {name} step {i}: {row}")
                else:
                    check(row["cpu_max_diff"] <= PATH_LOGITS_TOL["float32"]
                          and row["cpu_picks_equal"]
                          and row["max_diff"] <= PATH_LOGITS_TOL["float32"],
                          f"[sharded seq decode] {name} step {i}: {row}")
            out[name] = r
            free_device()
    return out


def _tp_padded_emulated(card):
    """Attention heads that do not divide a model axis of 16, emulated by
    16 threads on the card (`tools/tp_emulate.py`'s `padded_case` and
    `train_case`): fp32 Minitron-4B and MiniCPM3-4B at full width and 2
    layers served (a prefill and 8 greedy decode steps, each step's logits
    within `tp_emulate.DEC_REL` of its largest, picks equal, every thread's
    logits equal; flash launched once per layer by each thread's Minitron
    prefill), and Minitron's train step (the loss and first moments within
    `TP_TRAIN_LOSS_REL` and `TP_TRAIN_M_SHARE` of the whole step's); every
    attention counted padded, nothing gathered."""
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import tp_emulate
    dev = torch.device("cuda")
    out = {}
    with tp_emulate.ranks(tp_emulate.PADDED_TP):
        n = tp_emulate.N
        for arch in tp_emulate.PADDED_ARCHS:
            r = tp_emulate.padded_case(dev, arch, False, card, tag="[sharded tp padded emulated]")
            for i, row in enumerate(r["steps"]):
                check(row["max_diff"] <= tp_emulate.DEC_REL * row["largest"]
                      and row["picks_equal"], f"[sharded tp padded] {arch} step {i}: {row}")
            check(r["ranks_agree"], f"[sharded tp padded] {arch}: the threads' logits differ")
            mixer = "mla" if arch == "minicpm3_4b" else "attn"
            steps = tp_emulate.PADDED_LAYERS * (1 + tp_emulate.DEC_NEW)
            c = r["counts"]
            check(c.get(f"{mixer}:padded") == steps and not c.get("tp_gathered"),
                  f"[sharded tp padded] {arch}: attention not padded in every step: {c}")
            want = {"flash_attention": n * tp_emulate.PADDED_LAYERS if mixer == "attn" else 0,
                    "moe_topk": 0, "ssd_scan": 0}
            check(r["launches"] == want,
                  f"[sharded tp padded] {arch}: launches {r['launches']}, want {want}")
            out[arch] = r
            free_device()
        cfg, batch = tp_emulate.train_config("minitron_4b", dev, False)
        r = tp_emulate.train_case(dev, cfg, batch, tp_emulate.TRAIN_LR, card,
                                  "[sharded tp padded train emulated]",
                                  loss_chunk=tp_emulate.TRAIN_LOSS_CHUNK)
        for key in ("loss", "loss_rank1"):
            check(abs(r[key] - r["whole_loss"]) <= TP_TRAIN_LOSS_REL * abs(r["whole_loss"]),
                  f"[sharded tp padded train] {key} {r[key]} against the whole step's "
                  f"{r['whole_loss']}")
        check(r["m_outside"] <= TP_TRAIN_M_SHARE * r["m_total"],
              f"[sharded tp padded train]: m outside the tolerance at {r['m_outside']} of "
              f"{r['m_total']} coordinates")
        check(r["replicated_grads_equal"],
              "[sharded tp padded train]: the replicated leaves' gradients differ between ranks")
        c = r["counts"]
        check(c.get("attn:padded") == tp_emulate.TRAIN_LAYERS and not c.get("tp_gathered"),
              f"[sharded tp padded train]: attention not padded: {c}")
        out["train"] = r
        free_device()
    return out


def _sp_train_collectives(sharded) -> list:
    """One line for each emulated sequence-parallel train step of the
    sharded phase: the model-axis collectives rank 0's step issued, by
    kind, counted as the step ran (`tools/tp_emulate.py`'s tally), with
    their ring-model wire bytes a rank."""
    cases = [(arch, 2, r) for arch, r in sharded["tp_train"].items()]
    cases.append(("minitron_4b padded", 16, sharded["tp_padded"]["train"]))
    lines = []
    for name, n, r in cases:
        kinds = r["collectives"]
        total = sum(k["wire_bytes"] for k in kinds.values())
        parts = ", ".join(f"{kind}: {k['n']} x, operands {k['operand_bytes']} B, wire "
                          f"{k['wire_bytes']:.0f} B" for kind, k in sorted(kinds.items()))
        lines.append(f"[sp train collectives] {name} on {n} emulated ranks, one step, rank 0: "
                     f"{parts}; wire {total:.0f} B a rank")
    return lines


def phase_sharded(card):
    """The sharded builders on a one-rank NCCL mesh of the card, the
    tensor-parallel steps on two emulated ranks and padded heads on 16 (see
    the module docstring, phase 14); each model freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.sharding import rank_mesh
    t0 = time.perf_counter()
    out = {"stream": _sharded_stream(card)}
    with one_rank_group("nccl"):
        mesh = rank_mesh((1, 1, 1), device="cuda")
        out["serve"] = _sharded_serve(card, mesh, get_config(SERVE_ARCH))
        free_device()
        out["train"] = _sharded_train(card, mesh, get_config(SSM_ARCH), TRAIN_LR[SSM_ARCH])
        free_device()
    out["tp_train"] = _tp_train_emulated(card)
    out["tp_whisper"] = _tp_whisper_emulated(card)
    out["seq_decode"] = _seq_decode_emulated(card)
    out["tp_padded"] = _tp_padded_emulated(card)
    out["seconds"] = time.perf_counter() - t0
    say(f"[sharded] phase {out['seconds']:.1f} s  [{card}]")
    return out


# ---------------------------------------------------------------------------
# the engine across ranks
# ---------------------------------------------------------------------------

# steps after which the engine-ranks phase swaps across ranks and back; the
# second half of the serve prompts arrives at the first swap
ENGINE_RANKS_SWAPS = (2, 8)


def _empty_launches(card):
    """Each kernel wrapper on empty CUDA inputs (a rank without rows): the
    empty result of the right shape and dtype, and no launch."""
    import torch

    from repro_torch.kernels import ops
    ops.reset_launches()
    q = torch.zeros((0, 17, 16, 128), dtype=torch.bfloat16, device="cuda")
    o = ops.flash_attention(q, q, q)
    w, i = ops.moe_topk(torch.zeros((0, 60), device="cuda"), 4, norm_topk=False)
    x = torch.zeros((0, 256, 8, 64), dtype=torch.bfloat16, device="cuda")
    y, h = ops.ssd_scan(x, torch.zeros((0, 256, 8), device="cuda"), torch.zeros(8, device="cuda"),
                        torch.zeros((0, 256, 1, 128), dtype=torch.bfloat16, device="cuda"),
                        torch.zeros((0, 256, 1, 128), dtype=torch.bfloat16, device="cuda"))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ok = (o.shape == q.shape and w.shape == (0, 4) and i.dtype == torch.int32
          and y.shape == x.shape and h.shape == (0, 8, 64, 128)
          and not any(launches.values()))
    say(f"[engine ranks] empty inputs: flash {tuple(o.shape)}, moe_topk {tuple(w.shape)} "
        f"{i.dtype}, ssd_scan {tuple(y.shape)} / {tuple(h.shape)}; launches {launches}  "
        f"{'ok' if ok else 'FAIL'}  [{card}]")
    check(ok, "[engine ranks] a kernel wrapper launched on an empty input or returned "
              "the wrong empty result")


def _engine_ranks_drive(engine, submit, step, prompts, Request, swap=None):
    """The phase's schedule: the first half of ``prompts`` submitted, the
    rest at step `ENGINE_RANKS_SWAPS[0]` (after ``swap("across")``), and
    ``swap("back")`` after step `ENGINE_RANKS_SWAPS[1]`; every step's logits
    of the active lanes kept."""
    reqs = [Request(i, p, max_new_tokens=SERVE_NEW_TOKENS) for i, p in enumerate(prompts)]
    half = len(reqs) // 2
    for r in reqs[:half]:
        submit(r)
    logits, k = [], 0
    while (k < ENGINE_RANKS_SWAPS[0] or engine.queue
           or any(r is not None for r in engine.slot_req)):
        if k == ENGINE_RANKS_SWAPS[0]:
            if swap is not None:
                swap("across")
            for r in reqs[half:]:
                submit(r)
        if k == ENGINE_RANKS_SWAPS[1] and swap is not None:
            swap("back")
        step()
        k += 1
        active = [i for i, r in enumerate(engine.slot_req) if r is not None]
        logits.append((k, engine.last_logits.clone(), active))
    return reqs, logits


def phase_engine_ranks(card):
    """The engine across ranks on a one-rank NCCL mesh (module docstring,
    phase 16)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingCluster, ServingEngine
    from repro_torch.sharding import (
        default_plan,
        plan_to_placement,
        rank_mesh,
        single_device_mesh,
    )
    t0 = time.perf_counter()
    _empty_launches(card)
    cfg = get_config(SERVE_ARCH)
    model = Model(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPT_LENS]
    kw = dict(n_slots=8, s_max=512, page_size=16)

    oracle = ServingEngine(model, **kw)
    oracle.record_logits = True
    want_reqs, want_logits = _engine_ranks_drive(oracle, oracle.submit, oracle.step, prompts,
                                                 Request)
    out = {}
    with one_rank_group("nccl"):
        mesh = rank_mesh((1, 1, 1), device="cuda")
        cluster = ServingCluster(mesh, device="cuda")
        engine = ServingEngine(model, **kw)
        engine.record_logits = True
        cluster.register("e0", engine)
        plan = default_plan()
        one = plan_to_placement(plan, single_device_mesh(engine.device))
        reports = []

        def swap(where):
            t1 = time.perf_counter()
            rep = cluster.reconfigure("e0", plan, placement=None if where == "across" else one)
            reports.append((where, rep, time.perf_counter() - t1))
            check((engine.layout is not None) == (where == "across"),
                  f"[engine ranks] the swap {where} left the engine "
                  f"{'across ranks' if engine.layout is not None else 'on one device'}")

        torch.cuda.synchronize()
        ops.reset_launches()
        t1 = time.perf_counter()
        reqs, logits = _engine_ranks_drive(engine, cluster.submit, cluster.step, prompts,
                                           Request, swap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(ops.LAUNCHES)
        warmed = sum(rep.compiled_in_prepare - 1 for _, rep, _ in reports)
        want = launches_per_prefill(cfg, len(prompts) + warmed)
        for where, rep, sec in reports:
            say(f"[engine ranks] swap {where}: {rep.summary()}; reconfigure call "
                f"{sec:.2f} s  [{card}]")
        say(f"[engine ranks] launches {launches} (want {want}: {len(prompts)} request "
            f"prefills + {warmed} PREPARE warmed)  [{card}]")
        check(launches == want, f"[engine ranks] launches {launches} != {want}")
        same_streams = [r.tokens_out for r in reqs] == [r.tokens_out for r in want_reqs]
        bad = [k for (k, a, act), (_, b, _) in zip(logits, want_logits)
               if not _bits_equal(a[act], b[act])]
        pool = all(_bits_equal(engine.cache[k], oracle.cache[k]) for k in oracle.cache)
        s = dict(engine.decode_stats)
        across = s["multi_rank_eager"]
        say(f"[engine ranks] {len(reqs)} requests x {SERVE_NEW_TOKENS} tokens, {engine.steps} "
            f"decode steps ({across} across ranks, eager by design; {s['replays']} graph "
            f"replays, {s['captures']} captures) in {wall:.2f} s: streams "
            f"{'equal' if same_streams else 'DIFFER'}, logits of every step "
            f"{'equal bit for bit' if not bad else f'differ at steps {bad}'}, final pool "
            f"{'equal' if pool else 'DIFFERS'} to the unsharded engine's  [{card}]")
        check(same_streams and not bad and pool,
              "[engine ranks] the engine across ranks does not equal the unsharded engine")
        check(across == ENGINE_RANKS_SWAPS[1] - ENGINE_RANKS_SWAPS[0]
              and s["eager"] == 2 + across and s["captures"] == 2
              and s["replays"] == engine.steps - s["eager"],
              f"[engine ranks] {s} over {engine.steps} steps: one device replays its graph "
              "after each first step, across ranks every step is eager")
        out = {"launches": launches, "want": want, "wall_s": wall, "stats": s,
               "reports": [{"where": w, "prepare_s": r.prepare_s, "downtime_s": r.downtime_s,
                            "migrate_bytes": r.migrate_bytes,
                            "compiled": r.compiled_in_prepare, "call_s": c}
                           for w, r, c in reports]}
        del cluster, engine
    del oracle, model
    free_device()
    out["seconds"] = time.perf_counter() - t0
    say(f"[engine ranks] phase {out['seconds']:.1f} s  [{card}]")
    return out


# ---------------------------------------------------------------------------
# the dry run against the card
# ---------------------------------------------------------------------------

# (tag, arch, kind, seq, batch, config patch, Model kwargs, step kwargs): the
# steps the dry-run phase predicts and then runs, on a one-rank mesh
DRYRUN_STEPS = (
    ("qwen prefill", SERVE_ARCH, "prefill", 4096, 1, {}, {}, {}),
    ("mamba2 prefill", SSM_ARCH, "prefill", 4096, 1, {}, {}, {}),
    # 1 of 96 layers: the embedding and head alone are 18.9 GB
    ("nemotron prefill", "nemotron_4_340b", "prefill", 384, 1, {"num_layers": 1}, {}, {}),
    # the train phase's step: its shapes, loss chunk, fp32 moments and LR
    ("minitron train", TRAIN_ARCH, "train", TRAIN_SEQ, TRAIN_BATCH, {},
     {"loss_chunk": TRAIN_LOSS_CHUNK}, {"opt_state_dtype": None, "lr": TRAIN_LR[TRAIN_ARCH]}),
)
DRYRUN_PEAK_TOL = 0.05          # predicted peak against the measured one, relative
DRYRUN_CHILD_TIMEOUT_S = 400


def _dryrun_step(step, mesh, plan, model_device):
    """``(cfg, cell, model, StepInputs)`` of one `DRYRUN_STEPS` entry on
    ``mesh`` (the model's weights random from seed 0 on ``model_device``, or
    its shapes alone on ``"meta"``)."""
    import dataclasses

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    tag, arch, kind, S, B, patch, model_kw, step_kw = step
    cfg = dataclasses.replace(get_config(arch), **patch)
    cell = ShapeCell(tag.replace(" ", "_"), kind, S, B)
    model = Model(cfg, device=model_device, seed=0, **model_kw)
    return cfg, cell, model, dryrun.build_step(model, cell, mesh, plan, **step_kw)


def _real_args(inputs, model, device, gen):
    """Real tensors for a step's stand-ins, each placed under its sharding:
    the model's weights; random tokens; a full loss mask; AdamW's zeroed
    state in the stand-ins' dtype; a zeroed cache."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.sharding import ctx
    vocab = model.cfg.vocab_size

    def real(path, meta):
        if path.startswith("params/"):
            return None
        if meta.dtype in (torch.int32, torch.int64):
            return torch.randint(0, vocab, tuple(meta.shape), generator=gen, device=device,
                                 dtype=meta.dtype)
        if path.endswith("loss_mask"):
            return torch.ones(meta.shape, dtype=meta.dtype, device=device)
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)

    args = []
    for name, struct, sh in zip(inputs.names, inputs.structs, inputs.shardings):
        if name == "params":
            val = model.params
        elif isinstance(struct, dict):
            val = tree_util.map_tree(lambda p, m: real(f"{name}/{p}", m), struct)
        else:
            val = real(name, struct)
        args.append(ctx.place_tree(val, sh))
    return tuple(args)


def _same_counts(a, b) -> bool:
    keys = ("flops", "bytes", "kernel_calls", "argument_bytes", "peak_transient")
    ca, cb = a["collectives"], b["collectives"]
    return (all(a[k] == b[k] for k in keys) and ca["n"] == cb["n"]
            and ca["by_kind"] == cb["by_kind"]
            and ca["wire_bytes_per_device"] == cb["wire_bytes_per_device"])


def dryrun_child(card: str, real_device: str = "cuda", backend: str = "nccl") -> dict:
    """The dry-run phase's work, in a process of its own (`phase_dryrun`):
    each `DRYRUN_STEPS` step dry-run on a fake world of one rank with
    ``device=real_device`` and with ``device="cpu"`` (the counts must be
    equal), then the fake world torn down, and each step run for real over
    a one-rank ``backend`` mesh, once to warm up, once counted and once
    timed: kernel launches, FLOPs and bytes (`launch.cost.StepCost`, the
    same counter) and argument bytes must equal the prediction, the
    predicted peak must be within `DRYRUN_PEAK_TOL` of the measured one.
    The measured peak is ``max_memory_allocated`` less what was allocated
    before the step beyond its arguments (the CUDA context's cuBLAS
    workspace, made by the warm-up)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import cost as cost_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import plan as plan_lib
    from repro_torch.sharding import rank_mesh
    t0 = time.perf_counter()
    plan = plan_lib.default_plan()
    preds = {}
    for dev in (real_device, "cpu"):
        mesh = mesh_lib.fake_mesh((1, 1, 1), plan_lib.AXIS_NAMES, device=dev)
        for step in DRYRUN_STEPS:
            t1 = time.perf_counter()
            cfg, cell, _, inputs = _dryrun_step(step, mesh, plan, "meta")
            counts = dryrun.dry_run_step(inputs, mesh, torch.device(dev))
            preds[(step[0], dev)] = counts
            rec = dryrun.record_of(counts, cfg, cell, mesh)
            say(f"[dryrun] predicted {step[0]} on {dev}: args "
                f"{counts['argument_bytes']} B, peak "
                f"{counts['argument_bytes'] + counts['peak_transient']} B, flops "
                f"{counts['flops']:.6e}, bytes {counts['bytes']:.6e}, kernel calls "
                f"{counts['kernel_calls']}, collectives {counts['collectives']['by_kind']}, "
                f"bound {rec['roofline']['step_time_lower_bound_s'] * 1e3:.3f} ms "
                f"({rec['roofline']['bottleneck']}) in {time.perf_counter() - t1:.1f} s")
    for step in DRYRUN_STEPS:
        same = _same_counts(preds[(step[0], real_device)], preds[(step[0], "cpu")])
        check(same, f"[dryrun] {step[0]}: the dry run on {real_device} and on the CPU differ")
    say(f"[dryrun] the dry runs on {real_device} and on the CPU count the same, every step")
    dist.destroy_process_group()
    plan_lib._DEVICE_MESHES.clear()

    hbm = torch.cuda.get_device_properties(0).total_memory if real_device == "cuda" else 0
    say(f"[dryrun] the card's total_memory {hbm} B; launch.mesh.H100_HBM_BYTES "
        f"{mesh_lib.H100_HBM_BYTES} B  [{card}]")
    out = {"steps": {}, "hbm_bytes": hbm}
    gen = torch.Generator(device=real_device).manual_seed(0)
    with one_rank_group(backend):
        mesh = rank_mesh((1, 1, 1), device=real_device)
        for step in DRYRUN_STEPS:
            tag = step[0]
            cfg, cell, model, inputs = _dryrun_step(step, mesh, plan, real_device)
            args = _real_args(inputs, model, real_device, gen)
            sync = torch.cuda.synchronize if real_device == "cuda" else (lambda: None)
            res = inputs.step(*args)               # warm-up: workspaces, first uses
            del res
            sync()
            gc.collect()
            counter = cost_lib.StepCost(mesh)
            real_args = counter.add_arguments(args)
            base = torch.cuda.memory_allocated() if real_device == "cuda" else 0
            if real_device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            with counter:
                res = inputs.step(*args)
            sync()
            peak = torch.cuda.max_memory_allocated() if real_device == "cuda" else 0
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            del res
            gc.collect()
            t1 = time.perf_counter()
            res = inputs.step(*args)
            sync()
            wall = time.perf_counter() - t1
            del res
            real = counter.summary()
            pred = preds[(tag, real_device)]
            measured = peak - (base - real_args)
            predicted = pred["argument_bytes"] + pred["peak_transient"]
            rel = abs(predicted - measured) / max(measured, 1)
            bound = dryrun.record_of(pred, cfg, cell, mesh)["roofline"]
            say(f"[dryrun] {tag}: kernel launches {launches} (predicted "
                f"{pred['kernel_calls']}); flops {real['flops']:.6e} (predicted "
                f"{pred['flops']:.6e}); bytes {real['bytes']:.6e} (predicted "
                f"{pred['bytes']:.6e}); argument bytes {real_args} (predicted "
                f"{pred['argument_bytes']}); peak {measured} B measured (max_memory_allocated "
                f"{peak} - {base - real_args} B held before beyond the arguments) against "
                f"{predicted} B predicted ({rel * 100:.2f} %, limit "
                f"{DRYRUN_PEAK_TOL * 100:.0f} %); step {wall * 1e3:.1f} ms against the "
                f"roofline bound {bound['step_time_lower_bound_s'] * 1e3:.3f} ms "
                f"({bound['bottleneck']})  [{card}]")
            check(launches == pred["kernel_calls"],
                  f"[dryrun] {tag}: launches {launches} != predicted {pred['kernel_calls']}")
            check(real["flops"] == pred["flops"] and real["bytes"] == pred["bytes"],
                  f"[dryrun] {tag}: counted flops/bytes differ from the dry run's")
            check(real_args == pred["argument_bytes"],
                  f"[dryrun] {tag}: argument bytes {real_args} != {pred['argument_bytes']}")
            check(real_device != "cuda" or rel <= DRYRUN_PEAK_TOL,
                  f"[dryrun] {tag}: predicted peak {predicted} B is {rel * 100:.2f} % from "
                  f"the measured {measured} B")
            out["steps"][tag] = {"predicted": pred, "counted": real, "launches": launches,
                                 "measured_peak": measured, "max_memory_allocated": peak,
                                 "held_before": base - real_args, "peak_rel_err": rel,
                                 "step_s": wall, "bound": bound}
            del args, inputs, model
            gc.collect()
            if real_device == "cuda":
                torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    say(f"[dryrun] child {out['seconds']:.1f} s  [{card}]")
    return out


def phase_dryrun(card):
    """The dry run held to the card (module docstring, phase 15), in a
    child process: the fake world and the sharded phase's NCCL group must
    not meet in one process."""
    t0 = time.perf_counter()
    result = OUT / "dryrun_phase.json"
    result.unlink(missing_ok=True)
    OUT.mkdir(exist_ok=True)
    code = ("import sys, json, chip_smoke; "
            f"sys.path.insert(0, {str(SRC)!r}); "
            "out = chip_smoke.dryrun_child(sys.argv[1]); "
            f"open({str(result)!r}, 'w').write(json.dumps(out, default=str))")
    sys.stdout.flush()
    proc = subprocess.run([sys.executable, "-c", code, card], cwd=str(ROOT),
                          timeout=DRYRUN_CHILD_TIMEOUT_S)
    check(proc.returncode == 0 and result.is_file(),
          f"[dryrun] the child process failed (exit {proc.returncode})")
    out = json.loads(result.read_text())
    out["seconds"] = time.perf_counter() - t0
    say(f"[dryrun] phase {out['seconds']:.1f} s  [{card}]")
    return out


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
        after=lambda model: phase_prefill_graphs(card, model),
        n_slots=8, s_max=512, page_size=16)
    free_device()                   # the bf16 model is gone; make room for fp32
    mark("serve")
    serve["paths"] = phase_paths(card, bf16)
    mark("paths")
    del bf16
    free_device()
    # no profiled run 3 here (~40 s of the run on the H100): the scan's
    # device time in a serve mix is profiled in the families phase (Jamba)
    ssm_launches, ssm, ssm_bf16 = phase_serve(
        card, SSM_ARCH, SSM_PROMPT_LENS, _ssm_path_outputs, None,
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
    families = phase_families(card)
    mark("families")
    train = phase_train(card)
    mark("train")
    sharded = phase_sharded(card)
    mark("sharded")
    engine_ranks = phase_engine_ranks(card)
    mark("engine ranks")
    dryrun = phase_dryrun(card)
    mark("dryrun")
    phase_s = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    # each kernel's launches on the first serve path that runs it (Qwen's for
    # flash and MoE top-k, Mamba2's for the scan), and on every serve path
    graphs = serve["after"]
    by_path = {"qwen serve": launches, "mamba2 serve": ssm_launches,
               "qwen prefill graphs (replays)": graphs["qwen"]["launches"],
               "mamba2 prefill graphs (replays, 24 layers)": graphs["mamba2"]["launches"],
               **{f"{name} serve": f["launches"] for name, f in families.items()},
               "whisper prefill": train[WHISPER_ARCH]["prefill_launches"],
               "whisper tp prefill (two emulated ranks)": sharded["tp_whisper"]["launches"],
               "minitron tp padded prefill (16 emulated ranks)":
                   sharded["tp_padded"]["minitron_4b"]["launches"],
               "sharded prefill": {k: sum(n[k] for n in sharded["serve"]["launches"])
                                   for k in launches},
               "engine ranks": engine_ranks["launches"]}
    for row in rows:
        row["launches"] = (launches if launches[row["name"]] else ssm_launches)[row["name"]]
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": rows, "kernel_times": kernel_times, "serve": serve,
         "ssm_serve": ssm, "cluster": cluster, "families": families, "train": train,
         "sharded": sharded, "engine_ranks": engine_ranks, "dryrun": dryrun,
         "phase_s": phase_s},
        indent=1))
    for line in _sp_train_collectives(sharded):
        say(line)
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
