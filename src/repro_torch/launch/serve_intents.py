"""Intent-driven serving with online reconfiguration (the paper's scenario
on the serving fabric, evaluated on downtime / TTFT / TPOT).

    PYTHONPATH=src python -m repro_torch.launch.serve_intents
    PYTHONPATH=src python -m repro_torch.launch.serve_intents --device cpu --reduced

Public-API flow only (no private engine attributes, no plan fishing):

1. register a continuous-batching engine with a `ServingCluster`;
2. serve a first wave of mixed phi/general requests through the cluster;
3. submit the privacy intent "Phi traffic must remain inside the pod" with
   ``apply_to=cluster``: the orchestrator compiles and validates it
   fail-closed, then the cluster's PREPARE builds the new executables (the
   decode step, and a prefill at each prompt length the engine has seen;
   CUDA graphs on the card) and hot-swaps every affected engine (the
   blocking window holds the placement only, never a capture);
4. keep serving phi traffic under the restricted plan, each admission
   replaying the prefill executable of its length; the DowntimeReport
   finalizes its after-swap metrics automatically.

The default is full-width Qwen1.5-MoE-A2.7B (bf16, random weights from seed
0) on the card; ``--reduced`` takes the architecture's reduced config in
fp32, ``--device cpu`` the CPU.
"""
import argparse
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import Orchestrator
from repro_torch.models import Model
from repro_torch.serving import Request, RoutingError, ServingCluster, ServingEngine
from repro_torch.sharding import default_plan

INTENT = "Phi traffic must remain inside the pod and avoid untrusted switches."


def load(cluster: ServingCluster, cfg, rng: np.random.Generator, n: int, base: int,
         labels: Dict[str, str]) -> List[Request]:
    """Submit ``n`` requests of 8 random tokens (8 new each) with ``labels``,
    ids from ``base``."""
    reqs = []
    for rid in range(n):
        reqs.append(Request(base + rid, rng.integers(2, cfg.vocab_size, size=8).astype(np.int32),
                            max_new_tokens=8, labels=labels))
        cluster.submit(reqs[-1])
    return reqs


def build(arch: str, reduced: bool, device: str) -> Model:
    """The served model: ``arch`` at full width (its published dtype) or its
    reduced config in fp32, random weights from seed 0."""
    if reduced:
        cfg = dataclasses.replace(get_reduced_config(arch), param_dtype="float32",
                                  activ_dtype="float32")
    else:
        cfg = get_config(arch)
    return Model(cfg, device=device, seed=0)


def main(argv: Optional[Sequence[str]] = None, model: Optional[Model] = None) -> Dict[str, Any]:
    """Run the scenario and print each stage. ``model``: serve this model
    (its device) instead of building one from the arguments.

    Returns the two waves' streams (``{rid: tokens}``), the swap's
    `DowntimeReport` (``report``), the rejection's message and the
    engine's ``prefill_stats`` and ``decode_stats``.

    Raises:
        SystemExit: a non-compliant engine accepted phi traffic.
    """
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config in fp32")
    ap.add_argument("--device", default="cuda", help="where to serve (default: the card)")
    args = ap.parse_args(argv)
    if model is None:
        model = build(args.arch, args.reduced, args.device)
    cfg, device = model.cfg, model.device
    engine = ServingEngine(model, n_slots=4, s_max=48, device=device)

    cluster = ServingCluster(device=device)
    cluster.register("edge0", engine, plan=default_plan())
    rng = np.random.default_rng(0)

    print(f"== wave 1: mixed tenants, default plan ({cfg.name}, {device}) ==")
    wave1 = (load(cluster, cfg, rng, 4, 0, {"data-type": "phi"})
             + load(cluster, cfg, rng, 4, 10, {"data-type": "general"}))
    cluster.run()
    before = cluster.metrics("edge0")
    print("  ", before)

    print("== intent arrives: validate + reconfigure through the cluster ==")
    orch = Orchestrator()
    res = orch.submit(INTENT, apply_to=cluster)
    print("   validator:", res.report.summary())
    if not res.success:
        raise SystemExit("the validator refused the intent")
    report = res.reports["edge0"]
    print("   restricted plan:", cluster.engine("edge0").plan)
    print("   route constraints:", cluster.route_constraints())
    print("  ", report.summary())
    if report.compiled_in_prepare <= 0:
        raise SystemExit("PREPARE built no executable")

    print("== wave 2: serving continues under the restricted plan ==")
    wave2 = load(cluster, cfg, rng, 8, 100, {"data-type": "phi"})
    cluster.run()   # auto-finalizes report.metrics_after (post-swap window)
    after = report.metrics_after
    print("  ", after)
    print("   prefill:", engine.prefill_stats)

    print("== fail-closed routing ==")
    try:
        strict = ServingCluster(device=device)
        strict.register("noncompliant", ServingEngine(model, n_slots=2, s_max=48,
                                                      device=device))
        strict.set_route_constraint("phi", cluster.route_constraints()["phi"])
        strict.submit(Request(999, rng.integers(2, cfg.vocab_size, size=8).astype(np.int32),
                              labels={"data-type": "phi"}))
    except RoutingError as e:
        rejected = str(e)
        print("   rejected as expected:", e)
    else:
        raise SystemExit("FAIL-OPEN: a non-compliant engine accepted phi traffic — the "
                         "routing guarantee has regressed")

    print("== summary ==")
    print(f"  prepare (AOT x{report.compiled_in_prepare})"
          f" : {report.prepare_s*1e3:.1f} ms  (serving continues)")
    print(f"  downtime           : {report.downtime_s*1e3:.1f} ms")
    print(f"  TTFT before/after  : {report.metrics_before['ttft_mean_s']:.3f}"
          f" / {after['ttft_mean_s']:.3f} s")
    print(f"  TPOT before/after  : {report.metrics_before['tpot_mean_s']:.3f}"
          f" / {after['tpot_mean_s']:.3f} s")
    return {"wave1": {r.rid: list(r.tokens_out) for r in wave1},
            "wave2": {r.rid: list(r.tokens_out) for r in wave2},
            "report": report, "rejected": rejected,
            "prefill_stats": dict(engine.prefill_stats),
            "decode_stats": dict(engine.decode_stats)}


if __name__ == "__main__":
    main()
