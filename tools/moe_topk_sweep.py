#!/usr/bin/env python3
"""Time variants of the MoE top-k kernel, and an earlier moe_topk source,
on one CUDA card.

    python3 tools/moe_topk_sweep.py [--baseline OLD.cu] [--variant NAME=V,...]...

``csrc/moe_topk.cu`` fixes its design in three constants: ``LANES`` (lanes
that share a row), ``BLOCK_WARPS`` (warps per block) and ``REDUX`` (the
max across lanes on ``redux.sync``). For each ``--variant`` (constants to
change, e.g. ``LANES=16,REDUX=false``; without any, a built-in set) this
writes a copy of the source with those constants changed into
``build/kernels/moe_sweep/`` and builds it alone, beside the source as
written and ``--baseline``, another moe_topk source with the same C
interface (an earlier version, e.g. from ``git show <commit>:src/
repro_torch/kernels/csrc/moe_topk.cu``). Each build is checked against the
plain version (exact ids, weights within 1e-6, tie rows included) and timed
(fp32 logits; E=60 k=4 and E=64 k=6; T = 17 ... 2048) the way
``chip_smoke.py`` times its kernels (CUDA events around a replayed CUDA
graph), every build and the empty kernel of the repository's library (the
launch floor) in turn and then in the reverse order, three times over (the
median is kept). Then the time per call as an eager caller sees it, at
T=384 E=60 k=4: the baseline through a copy of the launch path it shipped
with (a device switch and a `Stream` object per call), the current wrapper
and the empty kernel through the library's launch helper, in turn and then
in reverse, five times over (host time varies from run to run: the median
is kept). Prints the card's name and power limit, then the tables, and
writes them to ``moe_topk_sweep.json`` in ``chip_smoke.py``'s output
directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOKENS = (17, 64, 100, 150, 200, 256, 320, 384, 1024, 2048)
SHAPES = ((60, 4), (64, 6))           # (E, k): qwen2_moe, moonshot
ROUNDS = 3                            # graph-timed: every build in turn, then in reverse
EAGER_ROUNDS = 5
DEFAULT_VARIANTS = ("LANES=8,REDUX=false", "LANES=16,REDUX=false", "LANES=32,REDUX=false",
                    "LANES=8,REDUX=true", "LANES=16,REDUX=true", "BLOCK_WARPS=1",
                    "BLOCK_WARPS=4")
FLOOR = "launch floor"                # the empty kernel, timed beside the builds
CONST = r"constexpr (?:int|bool) {name} = [^;]+;"


def variant_source(text: str, spec: str) -> str:
    """``text`` with each ``NAME=VALUE`` of ``spec`` set."""
    for item in filter(None, spec.split(",")):
        name, value = item.split("=")
        text, n = re.subn(CONST.format(name=name),
                          lambda m: m.group(0).split("=")[0] + f"= {value};", text)
        if n != 1:
            raise ValueError(f"no single `constexpr ... {name} = ...;` to set")
    return text


def build(tag: str, text: str, out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = out_dir / f"{tag}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{tag}.so"
    cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, f"-I{_build.CSRC}",
           "-shared", str(src), "-o", str(lib)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{run.stdout}{run.stderr}")
    dll = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.moe_topk_fwd.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
    dll.moe_topk_fwd.restype = i32
    return dll


def shipped_launch(lib, logits, k):
    """The launch path of the baseline's wrapper: a device switch and a
    `Stream` object per call."""
    import torch
    T, E = logits.shape
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.moe_topk_fwd(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                               T, E, k, 0, 0, stream)
    if err != 0:
        raise RuntimeError(f"moe_topk_fwd launch failed: CUDA error {err}")
    return w, idx


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an earlier moe_topk source with the same C interface")
    ap.add_argument("--variant", action="append", default=None,
                    help="NAME=VALUE,... constants of csrc/moe_topk.cu to change")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("moe_topk_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import MOE_W_TOL, OUT, eager_ms, time_ms
    from repro_torch.kernels import _build, ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "build" / "kernels" / "moe_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "moe_topk.cu").read_text()
    sources = {}
    if args.baseline:
        sources["baseline"] = args.baseline.read_text()
    sources["source"] = text
    for spec in args.variant or DEFAULT_VARIANTS:
        sources[spec] = variant_source(text, spec)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda kv: build(f"v{list(sources).index(kv[0])}", kv[1], out_dir),
            sources.items())))

    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    dev = torch.device("cuda", torch.cuda.current_device())
    floor = lambda: _build.launch("launch_floor", dev)  # noqa: E731
    names = [*libs, FLOOR]
    times = {name: {} for name in names}
    for E, k in SHAPES:
        for T in TOKENS:
            x = torch.randn(T, E, generator=gen, device="cuda")
            x[3] = 0.5                                      # every expert ties
            x[5] = torch.tensor(([1.0, 2.0, 2.0] * E)[:E], device="cuda")
            wr, ir = ref.moe_topk_ref(x, k)
            calls = {}
            for name, lib in libs.items():
                w = torch.empty((T, k), dtype=torch.float32, device="cuda")
                i = torch.empty((T, k), dtype=torch.int32, device="cuda")

                def call(lib=lib, w=w, i=i):
                    err = lib.moe_topk_fwd(x.data_ptr(), w.data_ptr(), i.data_ptr(),
                                           T, E, k, 0, 0, stream())
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                err = (w - wr).abs().max().item()
                if not torch.equal(i, ir) or err > MOE_W_TOL:
                    print(f"moe_topk_sweep: FAIL: {name} E={E} k={k} T={T}: ids equal "
                          f"{torch.equal(i, ir)}, max|w err| {err:.3e}", file=sys.stderr)
                    return 1
                calls[name] = call
            calls[FLOOR] = floor
            order = (names + names[::-1]) * ROUNDS
            got = {name: [] for name in names}
            for name in order:
                got[name].append(time_ms(calls[name]))
            for name, ts in got.items():
                times[name][f"E={E} k={k} T={T}"] = ts
    print(f"ms per call, graph-timed, median (min-max) of {2 * ROUNDS}: each build in turn, "
          f"then in reverse, {ROUNDS} times over (fp32 logits):", flush=True)
    print("  " + " | ".join(f"[{i}] {n}" for i, n in enumerate(names)), flush=True)
    for case in times[names[0]]:
        print(f"  {case:>18}: " + "  ".join(
            f"[{i}] {statistics.median(times[n][case]):.5f} "
            f"({min(times[n][case]):.5f}-{max(times[n][case]):.5f})"
            for i, n in enumerate(names)), flush=True)

    eager = {}
    if args.baseline:
        x = torch.randn(384, 60, generator=gen, device="cuda")
        runs = {"baseline": lambda: shipped_launch(libs["baseline"], x, 4),
                "current": lambda: ops.moe_topk(x, 4), FLOOR: floor}
        for _ in range(EAGER_ROUNDS):
            for name in [*runs, *reversed(runs)]:
                eager.setdefault(name, []).append(eager_ms(runs[name], iters=200))
        print(f"eager ms per call, T=384 E=60 k=4 fp32, median (min) of {2 * EAGER_ROUNDS} "
              "runs of 200 calls, in turn then in reverse: " + ", ".join(
                  f"{n} {statistics.median(t):.5f} ({min(t):.5f})" for n, t in eager.items())
              + f"  [{card}]", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "moe_topk_sweep.json").write_text(json.dumps(
        {"card": card, "builds": names, "ms": times, "eager_ms": eager}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
