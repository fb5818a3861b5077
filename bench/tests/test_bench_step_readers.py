"""The readers of the program's own spans and counters inside the serving
step (``pool.kv_live_pct``, ``engine.decode_step_ms``): exact values from
given deltas of ``decode_stats``, and nothing where the program counted
nothing."""
import pytest

from bench import serve, spec
from bench.tests._cells import run_reduced

#: a paged decode step's counters over a window (a recorder installed)
PAGED = {"eager": 0, "replays": 40, "decode_s": 2.6, "decode_spans": 40,
         "kv_gathered_bytes": 40 * 9_663_676_416, "kv_live_bytes": 40 * 2_415_919_104}
#: the same on a slot pool: timed, nothing gathered
SLOT = {**PAGED, "kv_gathered_bytes": 0, "kv_live_bytes": 0}
#: a run without the recorder: every new key stays 0
UNRECORDED = {**PAGED, "decode_s": 0.0, "decode_spans": 0, "kv_gathered_bytes": 0,
              "kv_live_bytes": 0}
#: the parent program: no such keys at all
PARENT = {"eager": 0, "replays": 40, "captures": 0}


def _run(decode_delta):
    return serve.RunRecord(model={}, window_s=51.0, t0=0.0, requests=[],
                           prefill_delta={}, decode_delta=dict(decode_delta))


def _read(name, delta):
    return spec.load_reader(name)(_run(delta))


def test_exact_values_from_the_deltas():
    assert _read("pool.kv_live_pct", PAGED) == pytest.approx(25.0, rel=1e-12)
    assert _read("engine.decode_step_ms", PAGED) == pytest.approx(65.0, rel=1e-12)


@pytest.mark.parametrize("name,delta,want", [
    ("pool.kv_live_pct", SLOT, None),
    ("engine.decode_step_ms", SLOT, 65.0),
    ("pool.kv_live_pct", UNRECORDED, None),
    ("engine.decode_step_ms", UNRECORDED, None),
    ("pool.kv_live_pct", PARENT, None),
    ("engine.decode_step_ms", PARENT, None),
], ids=["slot-live", "slot-step", "unrecorded-live", "unrecorded-step", "parent-live",
        "parent-step"])
def test_nothing_counted_reads_none(name, delta, want):
    got = _read(name, delta)
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


def test_traced_reduced_cell_reports_both():
    res = run_reduced("minitron-chat-poisson", trace=True)
    m = res["metrics"]
    assert res["correct"] is True
    assert 0 < m["pool.kv_live_pct"]["value"] <= 100
    assert m["engine.decode_step_ms"]["value"] > 0
