"""One cell's serving run: the cluster and its engine as a deployment
builds them, set-up, the open-loop window, the drain, and what the metric
readers read (`RunRecord`).

The entry the window drives is `ServingCluster.submit` / `.step` over one
`ServingEngine`, and, in a mix with an intent, `Orchestrator.submit(text,
apply_to=cluster, async_reconfig=True)`: PREPARE on the cluster's worker
thread beside serving, the swap at a step boundary. One thread submits
every request when it is due and steps the cluster whenever there is
work; it stamps each new token after the step that made it (the first at
the engine's own first-token stamp).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.traffic import generator as gen_mod

#: seconds a request due in the window may take to finish after it closes
DRAIN_S = 60.0
#: a refused client's wait before it sends its request again
RETRY_S = 0.05
#: the traced run's profiled stretch: the window's last ``PROFILE_S``
#: seconds (its last fifth under 30 s), from the first step boundary in
#: it to the close, so the profiler's stop, which takes seconds, falls
#: after the window
PROFILE_S = 6.0


@dataclasses.dataclass
class ReqRecord:
    """One scheduled request and what became of it."""

    arrival: gen_mod.Arrival
    prompt: np.ndarray
    due: Optional[float] = None     # wall-clock time it was due (set when released)
    submitted: float = 0.0
    accepted: float = 0.0           # when an engine took it
    req: Any = None                 # the program's `Request`
    stamps: List[float] = dataclasses.field(default_factory=list)
    refused: int = 0                # times the router refused it (fail-closed)
    launched: int = 0               # the prefill's launched length
    admit_step: int = -1
    phase: str = "steady"           # before | prepare | after an intent

    @property
    def served(self) -> List[int]:
        return list(self.req.tokens_out) if self.req is not None else []

    @property
    def finished(self) -> bool:
        return self.req is not None and self.req.t_done > 0


@dataclasses.dataclass
class RunRecord:
    """What a run hands the metric readers."""

    model: Dict[str, Any]           # the config file's ``model`` section
    window_s: float
    t0: float                       # window start (wall clock)
    requests: List[ReqRecord]
    prefill_delta: Dict[str, float]
    decode_delta: Dict[str, float]
    report: Any = None              # the intent's `DowntimeReport`
    intent_t: Optional[float] = None
    admit_events: List[Any] = dataclasses.field(default_factory=list)
    steps: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)
    trace: Any = None               # `bench.devtrace.TraceSummary`

    @property
    def t_close(self) -> float:
        return self.t0 + self.window_s


def bucket_ladder_pick(S: int, exact: Sequence[int], buckets: Sequence[int]) -> int:
    """The launched length of a prompt of ``S`` tokens under the
    reference's pick: its exact length's entry, else the smallest bucket
    that holds it, else eager at ``S``."""
    if S in exact:
        return S
    return next((b for b in sorted(buckets) if b >= S), S)


class Cell:
    """A cell built and set up: model, engine, cluster, schedule."""

    def __init__(self, conf: Dict[str, Any], mix: Dict[str, Any], seed: int, seconds: float,
                 device, params: Optional[Dict[str, Any]] = None):
        from repro_torch.models import Model
        from repro_torch.serving import PrepareWorker, ServingCluster, ServingEngine
        from repro_torch.sharding import default_plan

        from bench.weights import make_params, model_config
        self.conf, self.seed, self.window_s = conf, seed, float(seconds)
        self.device = torch.device(device)
        self.cfg = model_config(conf["model"])
        t = time.perf_counter()
        self.params = params if params is not None else make_params(self.cfg, seed, self.device)
        _sync(self.device)
        t_w = time.perf_counter() - t
        self.model = Model(self.cfg, params=self.params, device=self.device)
        eng = conf["engine"]
        self.worker = PrepareWorker(max_workers=1)
        self.cluster = ServingCluster(device=self.device, prepare_worker=self.worker)
        self.engine = ServingEngine(self.model, n_slots=eng["n_slots"], s_max=eng["s_max"],
                                    page_size=eng["page_size"],
                                    prefill_buckets=eng.get("prefill_buckets", False),
                                    device=self.device)
        self.cluster.register("edge0", self.engine, plan=default_plan())
        self.timings = {"weights_s": t_w}
        self.reschedule(mix, seed)

    def reschedule(self, mix: Dict[str, Any], seed: int) -> None:
        """The requests of the next window: ``mix``'s sizes in ``seed``'s
        order, their tokens, a fresh arrival process (the weights stay
        ``self.seed``'s)."""
        self.mix = mix
        self.proc = gen_mod.process(mix, self.window_s, seed)
        self.sched = gen_mod.schedule(mix, self.window_s, seed, self.proc)
        self.prompts = gen_mod.prompt_tokens(self.sched, self.cfg.vocab_size, seed)

    def setup(self, warm_profiler: bool = False) -> None:
        """The deployment's warm start and the cell's own warm-up: one
        PREPARE at ``default_plan()`` (the decode graph, and with
        ``prefill_buckets`` the bucket ladder's prefill graphs), then a few
        requests through the cluster; where the mix holds an intent, its
        pipeline once without applying it and an eager prefill."""
        from repro_torch.core import Orchestrator
        from repro_torch.serving import Request
        from repro_torch.sharding import default_plan
        eng = self.conf["engine"]
        t = time.perf_counter()
        self.cluster.reconfigure("edge0", default_plan(),
                                 prefill_buckets=eng.get("prefill_buckets", False))
        self.timings["prepare_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rng = np.random.default_rng([gen_mod.seed_key(self.seed), 3])
        warm = [int(x) for x in self.mix.get("warm_prompt_lens", (16, 200))]
        for i, n in enumerate(warm):
            self.cluster.submit(Request(-1 - i, rng.integers(2, self.cfg.vocab_size, size=n)
                                        .astype(np.int32), max_new_tokens=4))
        self.cluster.run()
        intent = gen_mod.first_event(self.sched, "intent")
        if intent is not None:
            res = Orchestrator().submit(intent[1]["text"])
            if not res.success:
                raise RuntimeError(f"the intent does not validate: {res.report.summary()}")
            for n in warm:
                tokens = torch.as_tensor(rng.integers(2, self.cfg.vocab_size, size=(1, n + 1)),
                                         device=self.device)
                self.model.prefill({"tokens": tokens})
        self.cluster.drain_completed()
        if warm_profiler:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            with profile(activities=acts):
                torch.zeros(1, device=self.device).add_(1)
                _sync(self.device)
        _sync(self.device)
        self.timings["warm_s"] = time.perf_counter() - t
        gc.collect()
        gc.freeze()

    def serve(self, profiler: Optional[Callable[[], Any]] = None, recorder: Any = None,
              drain_s: float = DRAIN_S) -> RunRecord:
        """The measured window and the drain after it."""
        from repro_torch.core import Orchestrator
        from repro_torch.serving import Request, RoutingError
        cluster, engine = self.cluster, self.engine
        W = self.window_s
        proc = self.proc
        intent = gen_mod.first_event(self.sched, "intent")
        stats0 = (dict(engine.prefill_stats), dict(engine.decode_stats))
        t0 = time.time()
        recs = [ReqRecord(a, p) for a, p in zip(self.sched.arrivals, self.prompts)]
        inflight: List[ReqRecord] = []
        finished: List[int] = []            # finished since the process last looked
        steps: List[Tuple[float, float, int]] = []
        state = {"step": 0, "ticket": None, "intent_t": None, "prof": None, "retry_t": 0.0,
                 "prof_t": None, "phase": "before" if intent else "steady"}

        retry: List[ReqRecord] = []

        def submit(r: ReqRecord) -> None:
            """Send ``r``; a client the router refuses (no compliant engine:
            fail-closed) sends it again every `RETRY_S` until an engine
            takes it, its first token still timed from when it was due."""
            a = r.arrival
            if r.req is None:
                r.req = Request(a.rid, r.prompt, max_new_tokens=a.new_tokens,
                                labels=gen_mod.labels_of(a))
                r.submitted = time.time()
                r.phase = state["phase"]
            try:
                cluster.submit(r.req)
            except RoutingError:
                r.refused += 1
                if r.refused == 1:
                    retry.append(r)
                return
            if r.refused:
                retry.remove(r)
            r.accepted = time.time()
            inflight.append(r)

        def stamp(te: float) -> None:
            tables = None
            done = []
            for r in inflight:
                n = len(r.req.tokens_out)
                had = len(r.stamps)
                if n > had:
                    if had == 0:
                        tables = tables or engine.prefill_executables
                        r.stamps.append(r.req.t_first)
                        r.launched = bucket_ladder_pick(len(r.prompt), *tables)
                        r.admit_step = state["step"] - 1     # index into ``steps``
                    r.stamps.extend([te] * (n - len(r.stamps)))
                if r.req.t_done > 0:
                    done.append(r)
            for r in done:
                inflight.remove(r)
                finished.append(r.arrival.rid)

        def release(el: float) -> None:
            """Send what the arrival process says is due by ``el``."""
            for k, off in proc.due(el, tuple(finished)):
                if off < W:
                    recs[k].due = t0 + off
                    submit(recs[k])
            finished.clear()

        def pending() -> bool:
            t = state["ticket"]
            return t is not None and not t.done()

        def step() -> None:
            ts = time.time()
            if state["prof"] is not None:
                with torch.profiler.record_function("cluster.step"):
                    n = cluster.step()
            else:
                n = cluster.step()
            te = time.time()
            state["step"] += 1
            steps.append((ts, te, n))
            stamp(te)
            if state["phase"] == "prepare" and not pending():
                state["phase"] = "after"

        def profile_boundary(el: float) -> None:
            if profiler is None:
                return
            if state["prof"] is None and state["prof_t"] is None:
                if el >= self.profile_start():
                    _sync_stream(self.device)
                    state["prof"] = profiler()
                    state["prof"].__enter__()
                    state["prof_t"] = [time.time(), None]

        while True:
            el = time.time() - t0
            if el >= W:
                break
            if retry and time.time() >= state["retry_t"]:
                state["retry_t"] = time.time() + RETRY_S
                for r in list(retry):
                    submit(r)
            release(el)
            if intent is not None and state["intent_t"] is None and el >= intent[0]:
                state["intent_t"] = time.time()
                res = Orchestrator().submit(intent[1]["text"], apply_to=cluster,
                                            async_reconfig=True)
                if not res.success or "edge0" not in res.reports:
                    raise RuntimeError(f"the intent did not reconfigure edge0: "
                                       f"{res.report.summary()}")
                state["ticket"] = res.reports["edge0"]
                state["phase"] = "prepare"
            profile_boundary(el)
            if engine.load:
                step()
            elif pending() or retry:         # commit the swap once PREPARE is ready
                _idle(0.002, profiler is not None)
                step()
            else:
                nxt_due = proc.next_due()
                nxt = min([W if nxt_due is None else nxt_due, W]
                          + ([intent[0]] if intent and state["intent_t"] is None else []))
                _idle(max(0.0, min(nxt - (time.time() - t0), 0.002)), profiler is not None)
        release(W)                           # due before the close, not yet sent
        if state["prof"] is not None:        # the stretch ends at the close
            _sync_stream(self.device)
            state["prof_t"][1] = time.time()
            _stop_profiler(state["prof"])
            state["prof_obj"] = state["prof"]
        deadline = time.time() + drain_s
        while (inflight or retry or pending()) and time.time() < deadline:
            if retry and time.time() >= state["retry_t"]:
                state["retry_t"] = time.time() + RETRY_S
                for r in list(retry):
                    submit(r)
            if not engine.load:
                time.sleep(0.001)
            step()
        report = None
        if state["ticket"] is not None and state["ticket"].done():
            report = state["ticket"].result()
        stats1 = (dict(engine.prefill_stats), dict(engine.decode_stats))
        run = RunRecord(
            model=self.conf["model"], window_s=W, t0=t0,
            requests=[r for r in recs if r.due is not None],
            prefill_delta={k: stats1[0][k] - stats0[0][k] for k in stats0[0]},
            decode_delta={k: stats1[1][k] - stats0[1][k] for k in stats0[1]},
            report=report, intent_t=state["intent_t"], steps=steps)
        if recorder is not None:
            run.admit_events = recorder.events("request.admit")
        if state.get("prof_obj") is not None:
            from bench import devtrace
            run.trace = devtrace.summarize(state["prof_obj"], state["prof_t"], run)
        return run

    def profile_start(self) -> float:
        return self.window_s - (PROFILE_S if self.window_s >= 30 else 0.2 * self.window_s)

    def close(self) -> None:
        """Free the program's state (engine, pool, graphs); the weights
        stay for the reference."""
        self.worker.shutdown(wait=True)
        self.cluster = self.engine = self.model = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def _idle(seconds: float, annotate: bool) -> None:
    """The serving thread has nothing to do until the next due request."""
    if seconds <= 0:
        return
    if annotate:
        with torch.profiler.record_function("bench.idle"):
            time.sleep(seconds)
    else:
        time.sleep(seconds)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stop_profiler(prof) -> None:
    """Stop ``prof`` (a `torch.profiler.profile`) without its device-wide
    synchronisation, which a graph capture on PREPARE's thread forbids; the
    serving stream is synchronised before."""
    for obj in (prof, getattr(prof, "profiler", None)):
        if obj is not None and hasattr(obj, "use_device"):
            obj.use_device = None
    prof.__exit__(None, None, None)


def _sync_stream(device) -> None:
    """Wait for the serving thread's stream alone: a device-wide
    synchronisation is not permitted while PREPARE's thread captures a
    graph."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()
