"""Quickstart: natural-language privacy intent -> enforced fabric config.

    PYTHONPATH=src python -m repro_torch.launch.quickstart

Walks the paper's full control loop on the two-pod fabric model: interpret,
compile (placement + routing), fail-closed validation, apply; then shows a
deliberately unenforceable intent being rejected. Host work only
(`repro_torch.core`): nothing runs on a device.
"""
import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import Orchestrator

INTENTS = (
    "Ensure all personal health data remains within the European Union.",
    "Traffic from host 2 to host 4 must traverse switch s8 and avoid "
    "huawei switches.",
    "Place phi workloads on eu nodes and ensure their traffic avoids "
    "untrusted switches.",
    # unenforceable: no financial workload exists -> must fail closed
    "Prohibit financial database service deployment in the cloud zone.",
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Submit each of `INTENTS` to one `Orchestrator` and print each
    outcome. Returns, per intent, what was printed (``domain``,
    ``complexity``, ``summary``, ``checks``, ``applied``, the first
    manifest and flow rule or None), and the final ``placement`` and flow
    counts."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    orch = Orchestrator()
    results: List[Dict[str, Any]] = []
    for text in INTENTS:
        print("=" * 72)
        print("INTENT:", text)
        r = orch.submit(text)
        print("  domain      :", r.policy.intent.domain,
              "/", r.policy.intent.complexity)
        print("  validator   :", r.report.summary())
        for c in r.report.checks:
            print(f"    [{'ok' if c.passed else 'XX'}] {c.name}: {c.detail[:80]}")
        print("  applied     :", r.applied)
        print("  tokens      :", r.prompt_tokens + r.completion_tokens,
              " latency: %.1f ms" % (r.total_s * 1e3))
        manifest = r.policy.manifests[0] if r.applied and r.policy.manifests else None
        rule = r.policy.flow_rules[0] if r.applied and r.policy.flow_rules else None
        if manifest is not None:
            print("  manifest[0] :", json.dumps(manifest)[:110])
        if rule is not None:
            print("  flow_rule[0]:", json.dumps(rule)[:110])
        results.append({"intent": text, "domain": r.policy.intent.domain,
                        "complexity": r.policy.intent.complexity,
                        "summary": r.report.summary(),
                        "checks": [(c.name, c.passed) for c in r.report.checks],
                        "applied": r.applied, "manifest": manifest, "flow_rule": rule})
    print("=" * 72)
    print("final placement:", orch.state.placement)
    print("installed flows:", len(orch.state.flow_rules), "rules over",
          len(orch.state.flows), "paths")
    return {"intents": results, "placement": dict(orch.state.placement),
            "flow_rules": len(orch.state.flow_rules), "flows": len(orch.state.flows)}


if __name__ == "__main__":
    main()
