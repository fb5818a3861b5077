"""Reduced cells for the CPU tests: the cells' configurations cut to the
port's reduced sizes in fp32, a small engine, a short mix."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

INTENT = "Phi traffic must remain inside the pod and avoid untrusted switches."
ARCH = {"qwen-chat-poisson": "qwen2_moe_a2_7b", "minitron-chat-poisson": "minitron_4b",
        "minitron-intent-swap": "minitron_4b"}
DROP = ("source", "max_seq_len", "mla", "ssm", "encdec", "hybrid_period",
        "hybrid_attn_offsets", "mrope_sections", "qk_norm", "tie_embeddings")


def reduced_conf(workload: str, limit: float = 1e-3) -> Dict[str, Any]:
    """A config file's content for the cell's architecture at the port's
    reduced size, in fp32."""
    from repro_torch.configs import get_reduced_config
    cfg = get_reduced_config(ARCH[workload])
    m = dataclasses.asdict(cfg)
    for k in DROP:
        m.pop(k, None)
    if m.get("moe") is None:
        m.pop("moe", None)
    m["head_dim"] = cfg.resolved_head_dim
    m["param_dtype"] = m["activ_dtype"] = "float32"
    return {"name": m["name"], "model": m,
            "engine": {"n_slots": 4, "s_max": 64, "page_size": 8, "prefill_buckets": True},
            "correct": {"mean_gap_limit": limit, "sample_tokens": 60, "sample_requests": 6,
                        "min_tokens": 10}}


def mix(intent: bool, rate: float = 6.0) -> Dict[str, Any]:
    return {"arrivals": "poisson", "rate_per_s": rate,
            "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.8, "min": 4, "max": 40},
            "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 16},
            "labels": {"data-type": {"phi": 1, "general": 1}} if intent else {},
            "events": ([{"kind": "intent", "at_fraction": 1 / 3, "text": INTENT}]
                       if intent else []),
            "warm_prompt_lens": [4, 20]}


def spec_with_intent() -> Dict[str, Any]:
    """BENCHMARK.json with the intent cell the readers and mix under
    ``bench/`` are kept for (``minitron-intent-swap``: PERF.md, Open
    questions) and its cluster metrics."""
    from bench import spec
    s = spec.load_spec()
    s["workloads"].append({"name": "minitron-intent-swap", "config": "minitron-4b",
                           "traffic": "azure-conv-intent", "chips": 1, "why": "test"})
    for name, unit in (("cluster.prepare_s", "s"), ("cluster.downtime_ms", "ms")):
        s["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                               "source": "program_span", "layer": "cluster",
                               "moves": "tpot_p95_ms", "workloads": ["minitron-intent-swap"]})
    for m in s["per_layer"]:
        if "workloads" in m and "minitron-chat-poisson" in m["workloads"]:
            m["workloads"].append("minitron-intent-swap")
    return s


def run_reduced(workload: str, seed: int = 12345678901, seconds: float = 3.0,
                trace: bool = False, limit: float = 1e-3, rate: float = 6.0) -> Dict[str, Any]:
    from bench import run
    intent = workload == "minitron-intent-swap"
    return run.run_cell(workload, seed, seconds, trace, device="cpu",
                        spec_override=spec_with_intent() if intent else None,
                        conf_override=reduced_conf(workload, limit),
                        mix_override=mix(intent, rate),
                        drain_s=20.0, log=lambda msg: None)
