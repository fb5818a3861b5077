"""The serving layer's clock (a copy of `repro.serving.clock`'s contract).

Every timing-derived quantity in the port's serving stack — `Request`
TTFT/TPOT stamps, `DowntimeReport` blocking windows, migration pauses,
PREPARE durations — flows through the ``time`` attribute of the serving
modules (`engine`, `cluster`, `migration`, `prepare` — plus the flight
recorder's `repro_torch.obs.events`; see ``CLOCKED_MODULE_NAMES``). That
indirection is what lets a long replay run on a **simulated clock**:
install a `FakeClock` and wall-clock never gates scale (``cluster.run``'s
idle sleep becomes a virtual advance, not a real one).

Two clock implementations share the same duck-typed surface
(``time() / perf_counter() / monotonic() / sleep(dt)`` plus the
simulation-only ``advance(dt)`` / ``now``):

    SystemClock   delegates to the real :mod:`time` module — the default;
    FakeClock     deterministic simulated time: every read advances by a
                  fixed ``tick``, ``sleep`` jumps instead of blocking.

`install_clock` swaps the serving modules' time source and returns a
restore callable; `simulated_time` is the context-manager form.

A simulated clock stamps the host's view only: on the card, a window is
the device's time only when it ends in a synchronisation, which the
engine's `drain`, `export_slot` and `import_slot` do.
"""
from __future__ import annotations

import contextlib
import threading
import time as _time
from typing import Callable, Iterator, Optional


class SystemClock:
    """The real wall clock, with the same surface as `FakeClock` (minus
    ``advance`` — real time cannot be jumped; `is_simulated` tells the
    two apart)."""

    is_simulated = False

    time = staticmethod(_time.time)
    perf_counter = staticmethod(_time.perf_counter)
    monotonic = staticmethod(_time.monotonic)
    sleep = staticmethod(_time.sleep)

    @property
    def now(self) -> float:
        return _time.time()


#: Process-wide default clock (the serving modules start on it).
SYSTEM_CLOCK = SystemClock()


class FakeClock:
    """Drop-in for the ``time`` module inside the serving layer: every
    read advances the clock by ``tick`` seconds, so timestamps are
    strictly increasing AND fully deterministic (no wall-clock jitter in
    TTFT/TPOT/downtime assertions). Thread-safe.

    Args:
        start: initial simulated epoch, seconds.
        tick: seconds added per ``time()``/``perf_counter()`` read.
    """

    is_simulated = True

    def __init__(self, start: float = 1_000.0, tick: float = 1e-3):
        self._now = float(start)
        self.tick = float(tick)
        self._lock = threading.Lock()

    def time(self) -> float:
        with self._lock:
            self._now += self.tick
            return self._now

    perf_counter = time
    monotonic = time

    def sleep(self, dt: float) -> None:
        """A simulated sleep never blocks: it jumps the clock."""
        self.advance(dt)

    def advance(self, dt: float) -> None:
        """Jump the clock forward without a read."""
        with self._lock:
            self._now += float(dt)

    @property
    def now(self) -> float:
        with self._lock:
            return self._now


#: Module names whose ``time`` attribute `install_clock` swaps — the
#: registry the clock-discipline test (`tests/test_torch_clock.py`)
#: enforces: any file under ``src/repro_torch/serving`` or
#: ``src/repro_torch/obs`` that touches :mod:`time` must appear here (or
#: be this file).
CLOCKED_MODULE_NAMES = (
    "repro_torch.serving.engine",
    "repro_torch.serving.cluster",
    "repro_torch.serving.migration",
    "repro_torch.serving.prepare",
    "repro_torch.obs.events",
    "repro_torch.obs.lineage",
    "repro_torch.obs.alerts",
)


def _serving_modules():
    import importlib

    return tuple(importlib.import_module(name)
                 for name in CLOCKED_MODULE_NAMES)


def install_clock(clock) -> Callable[[], None]:
    """Install ``clock`` as the time source of the serving layer
    (engine / cluster / migration / prepare stamp requests, downtime
    windows, migration pauses, and PREPARE durations through it; the
    flight recorder — `repro_torch.obs` — timestamps its events on it too,
    via non-advancing reads).

    Returns:
        A zero-argument restore callable that puts the previous time
        sources back (call it in a ``finally``; `simulated_time` wraps
        this pattern).
    """
    mods = _serving_modules()
    previous = [(m, m.time) for m in mods]
    for m in mods:
        m.time = clock

    def restore() -> None:
        for m, prev in previous:
            m.time = prev

    return restore


def installed_clock():
    """The serving layer's current time source (the real :mod:`time`
    module unless a clock was installed)."""
    return _serving_modules()[0].time


@contextlib.contextmanager
def simulated_time(clock: Optional[FakeClock] = None,
                   ) -> Iterator[FakeClock]:
    """Run the body on a simulated serving-layer clock; restores the
    previous time source on exit.

    >>> with simulated_time() as clock:
    ...     clock.advance(3600.0)        # an hour passes instantly
    """
    clock = clock if clock is not None else FakeClock()
    restore = install_clock(clock)
    try:
        yield clock
    finally:
        restore()
