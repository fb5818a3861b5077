"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights made on the card from the seed, the kernels loaded from
``build/kernels``, the warm-start PREPARE, the cell's warm-up) runs from
process start to the first due request (``setup_s``); then the open-loop
window of ``--seconds``; then the drain; then, with the program's state
freed, the comparison with the plain reference that decides ``correct``.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (the recorder on, the profiler over a stretch of the
window). The last stdout line is the result; the numbers compared, each
beside its limit, are the last stderr lines and the result's last key.
Exits non-zero, printing no result, without enough CUDA cards, or if JAX
or the JAX package is loaded in this process.
"""
from __future__ import annotations

import os
import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Sequence  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the wall clock (``/proc``), or this module's
    import where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_IMPORT


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    the name compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernels' own build lands in ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             spec_override: Optional[Dict[str, Any]] = None,
             conf_override: Optional[Dict[str, Any]] = None,
             mix_override: Optional[Dict[str, Any]] = None,
             t_start: Optional[float] = None, drain_s: Optional[float] = None,
             log=None) -> Dict[str, Any]:
    """Build, set up, serve and judge one cell; returns the result line's
    object. The overrides replace the cell's files (tests run a reduced
    cell on the CPU this way)."""
    import torch

    from bench import serve, spec as spec_mod, stats, yardstick
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = process_start() if t_start is None else t_start
    drain_s = serve.DRAIN_S if drain_s is None else drain_s
    spec = spec_override or spec_mod.load_spec()
    cell = spec_mod.cell(spec, workload)
    conf = conf_override or spec_mod.load_config(spec, cell["config"])
    mix = mix_override or spec_mod.load_traffic(cell["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda":
        card = yardstick.card_power()
        log(f"[card] {card['name']}, power limit {card['power_limit']}")

    c = serve.Cell(conf, mix, seed, seconds, dev)
    recorder = None
    if trace:
        from repro_torch.obs import Recorder
        recorder = Recorder(capacity=1 << 20, trace_capacity=1 << 16)
    c.setup(warm_profiler=trace)
    profiler = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        profiler = lambda: profile(activities=acts)  # noqa: E731
        from repro_torch.obs import events as obs_events
        restore = obs_events.install_recorder(recorder)
    try:
        run = c.serve(profiler=profiler, recorder=recorder, drain_s=drain_s)
    finally:
        if trace:
            restore()
    setup_s = run.t0 - t_start
    log("[setup] " + json.dumps({"setup_s": setup_s, **c.timings}))
    e2e = stats.end_to_end(run, setup_s, drain_s)
    summary = stats.summary(run)
    log("[window] " + json.dumps(summary))
    if run.intent_t is not None:
        log(f"[intent] submitted {run.intent_t - run.t0:.3f} s into the window; "
            + (run.report.summary() if run.report is not None else "no swap by the drain's end"))
    log(f"[counts] prefill {json.dumps(run.prefill_delta)} decode {json.dumps(run.decode_delta)}")
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))
            if dev.type == "cuda" else 0)

    metrics: Dict[str, Any] = {}
    if trace:
        for m in spec_mod.metrics_for(spec, workload, "per_layer"):
            value = spec_mod.load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec_mod.metrics_for(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    judged = judge(c, run, seed, dev, conf)
    failed = summary["unfinished"]
    limit = float(conf["correct"]["mean_gap_limit"])
    ok = (judged["requests"] > 0 and judged["mean_gap"] <= limit
          and judged["tokens"] >= conf["correct"]["min_tokens"])
    checks = {"mean_logit_gap": {"value": judged["mean_gap"], "limit": limit},
              "sampled_tokens": {"value": judged["tokens"], "limit": conf["correct"]["min_tokens"]}}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": bool(ok), "attempted": len(run.requests),
                              "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        from bench import devtrace
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [[k, v] for k, v in devtrace.top_ops(run.trace)],
                               "idle_gaps": [[k, v] for k, v in run.trace.idle_gaps]}
    log(f"[judge] sampled {judged['requests']} requests, {judged['tokens']} served tokens, "
        f"{judged['disagree']} off the reference's best; widest gap {judged['gap']:.4f}, "
        "by request " + " ".join(f"{g:.4f}" for g in judged["per_request"]))
    for name, c_ in checks.items():
        log(f"[check] {name} {c_['value']} limit {c_['limit']}")
    result["checks"] = checks
    return result


def judge(c, run, seed: int, dev, conf: Dict[str, Any], control: bool = False) -> Dict[str, Any]:
    """The sample of finished requests held to the plain reference
    (`bench.reference.check`); the program's state is freed first, so the
    reference never sets the run's memory peak (it is read before)."""
    from bench.reference import check
    done = [r for r in run.requests if r.finished]
    strata = [r.phase for r in done]
    cc = conf["correct"]
    picked = check.sample(done, seed, cc["sample_tokens"], cc["sample_requests"], strata)
    params, model = c.params, conf["model"]
    c.close()
    return check.gaps(model, params, [done[i].prompt for i in picked],
                      [done[i].served for i in picked], [done[i].launched for i in picked],
                      dev, control=control)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench import spec as spec_mod
    spec = spec_mod.load_spec()
    chips = int(spec_mod.cell(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded in this process: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
