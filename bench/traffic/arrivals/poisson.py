"""Open-loop Poisson arrivals at the mix's ``rate_per_s``.

The window holds ``n = round(rate x window)`` arrivals, the first at its
start. The gaps between them are the exponential distribution's ``n``
mid-quantiles (a Poisson process's gaps), scaled to fill the window (a
mean of ``window / n``, ``1 / rate`` to the rounding of ``n``), the last
one running to the window's end, in an order drawn from the seed: every
seed offers the same gaps, bunched differently.

What the harness asks of an arrival process (``make`` returns one, fresh
for each run):

* ``n``: how many requests the run may send (the generator draws sizes for
  that many);
* ``times``: each request's due time in seconds into the window, where the
  process fixes them in advance, else None;
* ``due(el, done)``: the requests due by ``el`` seconds into the window
  and not yet released, as ``(index, due time)``; ``done`` lists the
  indices finished since the last call (a closed loop releases on them);
* ``next_due()``: the next due time known now, or None.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bench.traffic.generator import mid_quantiles


class OpenLoop:
    """Requests due at fixed times, whatever the system does."""

    def __init__(self, times: np.ndarray):
        self.times = times
        self.n = len(times)
        self._next = 0

    def due(self, el: float, done: Sequence[int] = ()) -> List[Tuple[int, float]]:
        out = []
        while self._next < self.n and self.times[self._next] <= el:
            out.append((self._next, float(self.times[self._next])))
            self._next += 1
        return out

    def next_due(self) -> Optional[float]:
        return float(self.times[self._next]) if self._next < self.n else None


def make(mix, window_s: float, rng: np.random.Generator) -> OpenLoop:
    rate = float(mix["rate_per_s"])
    n = max(1, int(round(rate * window_s)))
    gaps = -np.log1p(-mid_quantiles(n)) / rate
    gaps *= window_s / gaps.sum()
    gaps = rng.permutation(gaps)
    return OpenLoop(np.concatenate([[0.0], np.cumsum(gaps[:-1])]))
