"""Online reconfiguration — DEPRECATED single-engine shim (the reference's
`repro.core.reconfig`).

The reconfiguration protocol (PREPARE beside serving, then a blocking swap,
a `DowntimeReport` with the prepare/downtime split and the TTFT/TPOT band
before and after) lives in the cluster runtime:
`repro_torch.serving.ServingCluster.reconfigure`, which drives the engine's
public ``pause()``/``drain()``/``swap_plan()``/``resume()`` lifecycle and
finalizes the report's metrics itself.

`ReconfigEngine` is kept so pre-cluster callers keep working; it delegates
to the same engine lifecycle and emits a `DeprecationWarning`. New code
should use::

    cluster = ServingCluster()
    cluster.register("e0", engine)
    report = cluster.reconfigure("e0", new_plan)
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serving.cluster import DowntimeReport  # noqa: F401  (re-export)
from repro_torch.serving.engine import ServingEngine
from repro_torch.sharding.plan import is_shardings


class ReconfigEngine:
    """DEPRECATED: wraps one `ServingEngine` and swaps its placement.

    Use `ServingCluster.reconfigure` instead: it materialises a placement
    from a `ShardingPlan`, warms the executables in PREPARE, and finalizes
    the report itself."""

    def __init__(self, engine: ServingEngine):
        warnings.warn("ReconfigEngine is deprecated; use ServingCluster.reconfigure",
                      DeprecationWarning, stacklevel=2)
        self.engine = engine
        self.history: List[DowntimeReport] = []

    def reconfigure(self, *, new_shardings: Optional[Dict[str, Any]] = None,
                    make_decode: Optional[Callable] = None,
                    make_prefill: Optional[Callable] = None,
                    warm_requests: int = 0) -> DowntimeReport:
        """PREPARE (call ``make_decode`` / ``make_prefill``, whose results
        become the swap's executables), then pause → drain →
        ``swap_plan(placement=new_shardings)`` → resume.

        Args:
            new_shardings: the layout: a placement ``{"params": device,
                "cache": device}`` (`sharding.plan_to_placement`), or a
                layout across ranks (`sharding.plan_layout` of a rank mesh,
                the reference's shardings); None keeps it.
            make_decode / make_prefill: PREPARE callables; their results
                go to `ServingEngine.swap_plan` as the ``"decode"`` and
                ``"prefill"`` executables.
            warm_requests: unused, kept for the reference's signature.

        Returns:
            The `DowntimeReport` (also appended to ``history``).

        Raises:
            ValueError: the placement puts the params on another device.
        """
        eng = self.engine
        metrics_before = eng.metrics()

        # ---- 1. PREPARE (background: serving would continue) ----
        t0 = time.perf_counter()
        executables: Dict[str, Any] = {}
        if make_decode:
            executables["decode"] = make_decode()
        if make_prefill:
            executables["prefill"] = make_prefill()
        prepare_s = time.perf_counter() - t0

        # ---- 2. SWAP (the blocking window, through the public lifecycle) ----
        t0 = time.perf_counter()
        eng.pause()
        eng.drain()
        layout = ({"shardings": new_shardings} if is_shardings(new_shardings)
                  else {"placement": new_shardings})
        migrate_bytes = eng.swap_plan(**layout, executables=executables)
        eng.resume()
        downtime_s = time.perf_counter() - t0

        # ---- 3. RESUME (finalize_metrics refreshes metrics_after later) ----
        report = DowntimeReport(prepare_s=prepare_s, downtime_s=downtime_s,
                                migrate_bytes=migrate_bytes, metrics_before=metrics_before,
                                metrics_after=eng.metrics())
        self.history.append(report)
        return report

    def finalize_metrics(self, report: DowntimeReport) -> None:
        report.metrics_after = self.engine.metrics()
