"""The port's serving clock (`repro_torch.serving.clock`): the `FakeClock`
semantics of `tests/test_clock.py`, the installer over the port's own
modules, simulated stamps through the port's engine and cluster, and the
clock-discipline lint of `scripts/check_clock_discipline.py` for
``src/repro_torch/serving`` and ``src/repro_torch/obs``.
"""
import pathlib
import re
import time as wall

import numpy as np
import pytest
from test_torch_cluster import tiny

from repro_torch.serving import (
    SYSTEM_CLOCK,
    FakeClock,
    Request,
    ServingCluster,
    ServingEngine,
    SystemClock,
    install_clock,
    installed_clock,
    simulated_time,
)
from repro_torch.serving.clock import CLOCKED_MODULE_NAMES

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SCANNED = ("repro_torch/serving", "repro_torch/obs")
EXEMPT = "repro_torch/serving/clock.py"        # owns the real clock (as _time)
IMPORT_RE = re.compile(r"^\s*(import\s+time\b|from\s+time\s+import\b)", re.MULTILINE)
DATETIME_RE = re.compile(r"\bdatetime\.(?:now|utcnow|today)\s*\(|\bdatetime\.datetime\b")
HANDOFF_RE = re.compile(r"\bhandoff\b|\bpause_s\b")


@pytest.mark.parametrize("start,tick", [(10.0, 0.5), (1_000.0, 1e-3)])
def test_fakeclock_reads_advance_deterministically(start, tick):
    clock = FakeClock(start=start, tick=tick)
    assert clock.now == start
    assert clock.time() == pytest.approx(start + tick)
    assert clock.perf_counter() == pytest.approx(start + 2 * tick)
    assert clock.monotonic() == pytest.approx(start + 3 * tick)
    clock.advance(100.0)
    assert clock.now == pytest.approx(start + 3 * tick + 100.0)
    assert clock.is_simulated


def test_fakeclock_sleep_jumps_without_blocking():
    clock = FakeClock()
    t0 = wall.monotonic()
    clock.sleep(3600.0)
    assert wall.monotonic() - t0 < 1.0
    assert clock.now == pytest.approx(1_000.0 + 3600.0)


def test_system_clock_surface():
    assert not SYSTEM_CLOCK.is_simulated and isinstance(SYSTEM_CLOCK, SystemClock)
    assert abs(SYSTEM_CLOCK.time() - wall.time()) < 5.0
    assert SYSTEM_CLOCK.monotonic() <= SYSTEM_CLOCK.monotonic()
    assert abs(SYSTEM_CLOCK.now - wall.time()) < 5.0


def test_install_clock_swaps_and_restores_the_ports_modules():
    import importlib
    mods = [importlib.import_module(n) for n in CLOCKED_MODULE_NAMES]
    assert all(m.__name__.startswith("repro_torch.") for m in mods)
    before = installed_clock()
    clock = FakeClock()
    restore = install_clock(clock)
    try:
        assert all(m.time is clock for m in mods)
        assert installed_clock() is clock
    finally:
        restore()
    assert installed_clock() is before
    assert all(m.time is before for m in mods)


def test_the_reference_clock_is_left_alone():
    """Installing the port's clock swaps none of the JAX package's
    modules, and the reverse."""
    from repro.serving import clock as jclock
    from repro.serving import engine as jengine
    from repro_torch.serving import engine as tengine
    j_before, t_before = jengine.time, tengine.time
    with simulated_time():
        assert jengine.time is j_before and tengine.time is not t_before
    restore = jclock.install_clock(jclock.FakeClock())
    try:
        assert tengine.time is t_before
    finally:
        restore()


def test_simulated_time_stamps_requests_and_reports():
    """TTFT/TPOT stamps and a reconfigure's windows land in the simulated
    domain while the context is active."""
    cfg, _, _, model = tiny()
    rng = np.random.default_rng(0)
    with simulated_time() as clock:
        cluster = ServingCluster(device="cpu")
        cluster.register("e0", ServingEngine(model, n_slots=2, s_max=32, device="cpu"))
        req = Request(0, rng.integers(2, cfg.vocab_size, size=6).astype(np.int32),
                      max_new_tokens=4, labels={"data-type": "phi"})
        cluster.submit(req)
        cluster.step()
        report = cluster.reconfigure("e0", cluster.engine("e0").plan)
        cluster.run()
        assert 1_000.0 < req.t_submit < req.t_first <= req.t_done <= clock.now
        ticks = report.downtime_s / clock.tick
        assert abs(ticks - round(ticks)) < 1e-6 and round(ticks) >= 1
    assert not getattr(installed_clock(), "is_simulated", False)


def _scanned():
    for d in SCANNED:
        for path in sorted((SRC / d).rglob("*.py")):
            rel = path.relative_to(SRC).as_posix()
            if rel != EXEMPT:
                yield rel, ".".join(pathlib.Path(rel).with_suffix("").parts), path.read_text()


def test_clock_discipline_of_the_ports_serving_and_obs():
    """Every module under the port's serving and obs trees that imports
    ``time``, or stamps migration/handoff pauses, is registered with the
    installer; none reads the wall clock through ``datetime``."""
    registered = set(CLOCKED_MODULE_NAMES)
    violations = []
    scanned = list(_scanned())
    assert len(scanned) >= 9
    for rel, mod, text in scanned:
        if DATETIME_RE.search(text):
            violations.append(f"{rel}: datetime wall-clock read")
        if IMPORT_RE.search(text) and mod not in registered:
            violations.append(f"{rel}: imports time but {mod} is not registered")
        if rel.startswith("repro_torch/serving") and HANDOFF_RE.search(text) \
                and mod not in registered:
            violations.append(f"{rel}: on the pause path but {mod} is not registered")
    assert violations == []
    assert {m for _, m, _ in scanned} >= registered
    # the Watchtower modules read the clock (non-advancing) and are swapped
    assert {"repro_torch.obs.lineage", "repro_torch.obs.alerts"} <= registered


def test_clock_lint_patterns_catch_wall_clock_leaks():
    """The lint's patterns fire on the leaks they exist for."""
    assert IMPORT_RE.search("import numpy\nimport time\n")
    assert IMPORT_RE.search("from time import perf_counter\n")
    assert not IMPORT_RE.search("import timeit\n")
    assert DATETIME_RE.search("t = datetime.now()")
    assert HANDOFF_RE.search("record.pause_s") and not HANDOFF_RE.search("pause_sec")
