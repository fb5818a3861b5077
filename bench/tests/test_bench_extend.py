"""A configuration, a traffic mix, an arrival process and a per-layer metric
are added as new files and entries, and the harness runs the new cells, in
a temporary copy, without an edit to any file that was there."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from bench.tests._cells import mix, reduced_conf

ROOT = Path(__file__).resolve().parents[2]

#: a closed loop, as a later mix might bring it: ``clients`` requests at
#: the start, each client's next one as soon as its last is done
CLOSED = """
class ClosedLoop:
    times = None

    def __init__(self, clients, n):
        self.clients, self.n, self._next, self._started = clients, n, 0, False

    def _send(self, el, k):
        out = []
        while k and self._next < self.n:
            out.append((self._next, el))
            self._next += 1
            k -= 1
        return out

    def due(self, el, done=()):
        if not self._started:
            self._started = el >= 0
            return self._send(el, self.clients if self._started else 0)
        return self._send(el, len(done))

    def next_due(self):
        return None


def make(mix, window_s, rng):
    return ClosedLoop(int(mix["clients"]), int(mix["max_requests"]))
"""


def test_add_a_cell_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    conf = reduced_conf("minitron-intent-swap")
    conf["name"] = "tiny"
    (tmp_path / "bench/configs/tiny.json").write_text(json.dumps(conf))
    (tmp_path / "bench/traffic/tiny-mix.json").write_text(json.dumps(mix(False, rate=5.0)))
    (tmp_path / "bench/traffic/arrivals/closed-test.py").write_text(CLOSED)
    (tmp_path / "bench/traffic/tiny-closed.json").write_text(json.dumps(
        dict(mix(False), arrivals="closed-test", clients=3, max_requests=5000)))
    (tmp_path / "bench/metrics/extra.due.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    spec["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2407.14679",
                            "file": "bench/configs/tiny.json", "reduced": [], "why": "test"})
    for name, traffic in (("tiny.cell", "tiny-mix"), ("tiny.closed", "tiny-closed")):
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "extra.due", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "engine",
                              "moves": "output_tokens_per_s",
                              "workloads": ["tiny.cell", "tiny.closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json, sys; from bench import run; "
            "[print(json.dumps(run.run_cell(w, 5, 3.0, True, device='cpu', "
            "drain_s=20.0, log=lambda m: None))) for w in ('tiny.cell', 'tiny.closed')]")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    opened, closed = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    for res in (opened, closed):
        assert res["correct"] is True and res["metrics"]["extra.due"]["value"] == res["attempted"]
    # the closed loop sent more than its 3 clients' first requests, fewer than its cap
    assert 3 < closed["attempted"] < 5000
    after = {p: p.read_bytes() for p in before}
    assert after == before
