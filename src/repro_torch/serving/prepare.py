"""Concurrent PREPARE: background preparation overlapped with serving (a
copy of `repro.serving.prepare`'s ticket state machine and worker).

In the reference, PREPARE compiles the target plan's executables ahead of
the swap. The port's PREPARE (`ServingEngine.prepare_executables`) builds
the decode executable at the live batch shape and a prefill executable at
each live prompt length and bucket, on the card CUDA graphs
(`serving/executable.py`: the decode graph captured over the live pool,
the prefill graphs over buffers of their own), so the graphs, the kernels'
library, the allocator's blocks and the library handles exist before the
swap, and the blocking SWAP window (pause, drain, install, resume) pays
none of them.

    PrepareTicket   the per-request handle of the pending-swap state
                    machine:

                        PREPARING ──warm-up done──► READY ──commit──► SWAPPED
                            │                         │
                            └──────── cancel() ───────┴──► CANCELLED
                            │
                            └── prepare raised ─────────► FAILED

                    A ticket that is CANCELLED (explicitly, or superseded
                    by a newer plan for the same engine) discards its
                    payload — it is NEVER installed.

    PrepareWorker   a small thread-pool executor that runs the PREPARE
                    closures (`plan_to_placement` + `prepare_executables`)
                    off the serving thread. PyTorch releases the GIL in its
                    kernels, so decode keeps flowing while the worker warms.

The cluster (`ServingCluster.reconfigure_async` / `spawn_engine_async`)
creates tickets, hands the closure to the worker, and commits READY
tickets at the next safe step boundary (`step()` / `run()` /
`commit_ready()`).
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from repro_torch.obs import events as obs_events

# ticket states
PREPARING = "preparing"   # warm-up in flight on the worker
READY = "ready"           # warm-up finished; awaiting a step boundary
SWAPPED = "swapped"       # committed — the engine runs the new plan
CANCELLED = "cancelled"   # explicit cancel or superseded; never installed
FAILED = "failed"         # the PREPARE closure (or spawn commit) raised

TERMINAL = (SWAPPED, CANCELLED, FAILED)


class PrepareCancelled(RuntimeError):
    """The awaited ticket was cancelled (or superseded by a newer plan)
    before its swap committed — its plan was never installed."""


class PrepareTicket:
    """Handle for one pending swap (reconfigure or spawn).

    Returned immediately by `ServingCluster.reconfigure_async` /
    `spawn_engine_async`; the caller keeps serving and either polls
    (`state` / `done()`) while stepping the cluster, or blocks on
    `wait()` / `result()`.

    Attributes:
        engine: target engine name.
        kind: ``"reconfigure"`` | ``"spawn"``.
        plan: the target `ShardingPlan`.
        prepare_s: background PREPARE time, set when the worker finishes.
        report: the committed swap's `DowntimeReport` (state SWAPPED).
        error: the exception that failed the ticket (state FAILED), or a
            post-commit verification error recorded after SWAPPED (the
            swap window was really paid; the engine is quarantined).
        superseded_by: the newer ticket that cancelled this one, if any.
    """

    def __init__(self, engine: str, kind: str, plan: Any = None, *,
                 engine_obj: Any = None):
        self._cond = threading.Condition()
        self._state = PREPARING
        self._payload: Optional[Dict[str, Any]] = None
        self._committing = False
        self.engine = engine
        self.kind = kind
        self.plan = plan
        self.prepare_s = 0.0
        self.report = None
        self.error: Optional[BaseException] = None
        self.superseded_by: Optional["PrepareTicket"] = None
        # the not-yet-registered ServingEngine a spawn ticket carries; let go
        # at every terminal state (the cluster owns a committed engine), so
        # a caller that keeps its tickets (`WorkloadPlanner.log`) does not
        # keep a retired engine's pool and decode graph alive
        self._engine_obj = engine_obj
        self._emit_state(PREPARING)

    def _emit_state(self, state: str, **data: Any) -> None:
        """Flight-recorder hook: one ``ticket.<state>`` event per
        state-machine transition (no-op when recording is off)."""
        rec = obs_events.RECORDER
        if rec is not None:
            rec.emit(f"ticket.{state}", engine=self.engine,
                     ticket_kind=self.kind, **data)

    def __repr__(self) -> str:
        return (f"PrepareTicket({self.kind} {self.engine!r} "
                f"state={self.state})")

    # -- observation ---------------------------------------------------
    @property
    def state(self) -> str:
        """Current state (one of preparing/ready/swapped/cancelled/failed)."""
        with self._cond:
            return self._state

    def done(self) -> bool:
        """True once the ticket reached a terminal state."""
        return self.state in TERMINAL

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the background warm-up finishes (or the ticket
        dies). Returns True iff the warm-up is (or was) done."""
        with self._cond:
            self._cond.wait_for(lambda: self._state != PREPARING, timeout)
            return self._state in (READY, SWAPPED)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until terminal (swap committed, cancelled, or failed).

        NB: a READY ticket only commits at a cluster step boundary —
        `wait()` from the thread that is supposed to drive `step()`
        would deadlock; poll `done()` while stepping instead (or call
        `ServingCluster.run(wait_pending=True)`).
        """
        with self._cond:
            self._cond.wait_for(lambda: self._state in TERMINAL, timeout)
            return self._state in TERMINAL

    def result(self, timeout: Optional[float] = None):
        """`wait()`, then return the committed `DowntimeReport`.

        Fail-closed parity with the sync paths: a swap that committed
        but then failed post-swap collective verification (engine quarantined)
        re-raises that error here, exactly as the blocking
        `reconfigure()` would — the report stays readable on
        ``self.report``.

        Raises:
            TimeoutError: not terminal within ``timeout``.
            PrepareCancelled: the ticket was cancelled/superseded.
            Exception: whatever failed the PREPARE closure, or the
                post-commit verification error.
        """
        if not self.wait(timeout):
            raise TimeoutError(f"{self!r} still pending after {timeout}s")
        if self._state == CANCELLED:
            raise PrepareCancelled(
                f"{self.kind} of engine {self.engine!r} was cancelled"
                + (" (superseded)" if self.superseded_by is not None else ""))
        if self._state == FAILED or self.error is not None:
            raise self.error
        return self.report

    # -- cancellation / supersession ------------------------------------
    def cancel(self, *, superseded_by: Optional["PrepareTicket"] = None
               ) -> bool:
        """Cancel a not-yet-committed ticket, discarding its payload so
        its plan can never be installed. Returns False when the
        ticket already committed/terminated (or its commit has begun)."""
        with self._cond:
            if self._state in TERMINAL or self._committing:
                return False
            self._state = CANCELLED
            self._payload = None           # payload discarded, provably
            self._engine_obj = None
            self.superseded_by = superseded_by
            self._cond.notify_all()
        self._emit_state(CANCELLED, superseded=superseded_by is not None)
        return True

    # -- worker/cluster internals ---------------------------------------
    def _set_ready(self, payload: Dict[str, Any], prepare_s: float) -> None:
        with self._cond:
            self.prepare_s = prepare_s
            if self._state != PREPARING:   # cancelled mid-warm-up: discard
                return
            self._payload = payload
            self._state = READY
            self._cond.notify_all()
        self._emit_state(READY, prepare_s=prepare_s)

    def _fail(self, error: BaseException) -> None:
        with self._cond:
            if self._state in TERMINAL:
                return
            self.error = error
            self._state = FAILED
            self._payload = None
            self._engine_obj = None
            self._cond.notify_all()
        self._emit_state(FAILED, error=repr(error))

    def _take_for_commit(self) -> Optional[Dict[str, Any]]:
        """Atomically claim a READY ticket for committing (cancel() can
        no longer land). Returns the payload, or None if not READY."""
        with self._cond:
            if self._state != READY or self._committing:
                return None
            self._committing = True
            return self._payload

    def _committed(self, report) -> None:
        with self._cond:
            self.report = report
            self._state = SWAPPED
            self._payload = None
            self._engine_obj = None
            self._cond.notify_all()
        self._emit_state(SWAPPED,
                         downtime_s=getattr(report, "downtime_s", 0.0))

    def _commit_failed(self, error: BaseException) -> None:
        with self._cond:
            self.error = error
            self._state = FAILED
            self._payload = None
            self._engine_obj = None
            self._committing = False
            self._cond.notify_all()
        self._emit_state(FAILED, error=repr(error))

    def _abandon(self) -> None:
        """The commit found the ticket's target gone (engine retired
        between READY and the step boundary): back to cancelled."""
        with self._cond:
            self._state = CANCELLED
            self._payload = None
            self._engine_obj = None
            self._committing = False
            self._cond.notify_all()
        self._emit_state(CANCELLED, abandoned=True)


class PrepareWorker:
    """Thread-pool executor for PREPARE closures.

    The pool is created lazily (a cluster that never goes async never
    spawns a thread) and shared: warm-ups from several engines/clusters
    can be in flight at once, bounded by ``max_workers``.
    """

    def __init__(self, max_workers: Optional[int] = None):
        self._max = max_workers or min(4, os.cpu_count() or 1)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    def submit(self, ticket: PrepareTicket,
               fn: Callable[[], Dict[str, Any]], *, always: bool = False) -> None:
        """Run ``fn`` on a worker thread; its return value becomes the
        ticket's payload (ticket -> READY), its exception fails it.
        ``always``: run it even when the ticket was cancelled before it
        started (its payload is then discarded): a PREPARE that issues
        collectives runs on every rank, whatever each rank's timing."""
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max,
                    thread_name_prefix="prepare-worker")
            pool = self._pool
        pool.submit(self.run_inline, ticket, fn, always=always)

    @staticmethod
    def run_inline(ticket: PrepareTicket,
                   fn: Callable[[], Dict[str, Any]], *, always: bool = False) -> None:
        """Execute one PREPARE closure on the calling thread (the sync
        `reconfigure`/`spawn_engine` paths reuse the exact ticket state
        machine without a thread hop); ``always`` as in `submit`."""
        if ticket.state != PREPARING and not always:   # cancelled before it started
            return
        t0 = time.perf_counter()
        try:
            payload = fn()
        except BaseException as e:         # noqa: BLE001 - ticket carries it
            ticket._fail(e)
            return
        ticket._set_ready(payload, time.perf_counter() - t0)

    def shutdown(self, wait: bool = True) -> None:
        """Join the pool (in-flight warm-ups finish; nothing new starts)."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait)


_default_worker: Optional[PrepareWorker] = None
_default_lock = threading.Lock()


def default_worker() -> PrepareWorker:
    """The process-wide shared `PrepareWorker` (lazily created)."""
    global _default_worker
    with _default_lock:
        if _default_worker is None:
            _default_worker = PrepareWorker()
        return _default_worker
