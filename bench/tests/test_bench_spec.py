"""BENCHMARK.json and every file it names parse, the harness finds each by
name, and the file keeps the contract's shape."""
import json
import re
import statistics

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench_spec():
    return spec.load_spec()


def test_every_cell_finds_its_files(bench_spec):
    for w in bench_spec["workloads"]:
        assert spec.cell(bench_spec, w["name"]) is w
        conf = spec.load_config(bench_spec, w["config"])
        assert conf["name"] == w["config"]
        for key in ("model", "engine", "correct"):
            assert key in conf
        mix = spec.load_traffic(w["traffic"])
        assert mix["rate_per_s"] > 0
        for m in spec.metrics_for(bench_spec, w["name"], "per_layer"):
            assert callable(spec.load_reader(m["name"]))
    for kernel in ("flash_attention", "moe_topk"):
        assert spec.kernel_names(kernel)


def test_contract_shape(bench_spec):
    assert set(bench_spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert bench_spec["paths"] == ["bench"]
    assert 1 <= bench_spec["run_seconds"] <= 51
    # the full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (bench_spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench_spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.add((group, e["name"]))
    assert len(names) == sum(len(bench_spec[g]) for g in
                             ("configs", "workloads", "end_to_end", "per_layer"))
    e2e = {m["name"] for m in bench_spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench_spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench_spec["end_to_end"] + bench_spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench_spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in bench_spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert spec.metrics_for(bench_spec, w["name"], "per_layer")
        assert len(spec.metrics_for(bench_spec, w["name"], "end_to_end")) >= 2
    for c in bench_spec["configs"]:
        assert c["file"].startswith("bench/") and len(c["why"]) <= 200
    assert len(json.dumps(bench_spec)) < 64 * 1024


def test_spread_arithmetic_is_pythons():
    # the bound is set from statistics.quantiles' quartiles, as the check reads them
    q = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert q == [1.75, 3.5, 5.25]
