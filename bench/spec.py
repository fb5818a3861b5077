"""The benchmark's data: ``BENCHMARK.json``, the configuration and traffic
files a cell names, and the per-layer metric readers, all found by name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec(path: Path = SPEC_FILE) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def cell(spec: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The ``workloads`` entry named ``workload``.

    Raises:
        KeyError: no cell has that name.
    """
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_entry(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(spec: Dict[str, Any], name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The configuration file of ``name`` (its ``file`` in BENCHMARK.json)."""
    with open(root / config_entry(spec, name)["file"]) as f:
        return json.load(f)


def load_traffic(name: str, bench: Path = BENCH) -> Dict[str, Any]:
    """``bench/traffic/<name>.json``."""
    with open(bench / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(spec: Dict[str, Any], workload: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    without a ``workloads`` key, and those that list it."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str, bench: Path = BENCH) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of ``bench/metrics/<name>.py`` (a metric name
    may hold dots, so the module is loaded from its path)."""
    path = bench / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                      path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def kernel_names(kernel: str, bench: Path = BENCH) -> List[str]:
    """The kernel names (substrings of the device trace's names) that do
    ``kernel``'s work: one per non-empty line of every
    ``bench/metrics/kernel_names/<kernel>/*.txt``, so another
    implementation adds a file."""
    names: List[str] = []
    for f in sorted((bench / "metrics" / "kernel_names" / kernel).glob("*.txt")):
        names += [ln.strip() for ln in f.read_text().splitlines()
                  if ln.strip() and not ln.startswith("#")]
    return names
