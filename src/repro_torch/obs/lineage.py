"""Per-request critical-path attribution over the flight recorder.

`RequestLineage` assembles the rid-keyed event stream (the flight
recorder's ``request.*`` / ``migration.pause`` / ``cluster.*`` taxonomy)
into one `RequestTimeline` per completed request, decomposing the
measured latency into named components:

  * **TTFT** = queue wait + admission overhead + prefill compute
    + PREPARE/compile wait + (pre-admission) handoff pause.
  * **decode span** (= TPOT x decode steps) = decode compute
    + migration pauses + first-token handoff pause
    + prefill-interference stalls.

The decomposition is *conserved by construction* against the event
stream (queue wait and decode compute are residuals), and *checked*
against an independent measurement path: the engine-side ``t_submit`` /
``t_first`` / ``t_done`` stamps carried on ``request.complete``
(``ttft_s`` / ``tpot_s``). Under a `FakeClock` the two paths agree
exactly; under the wall clock they differ by the emit-site skew, which
`conservation()` bounds. A decomposition whose parts do not sum to the
independently measured value within ε means dropped events, a wall-clock
leak, or an unaccounted pause — exactly the corruption the Watchtower
exists to catch.

Component semantics (simulated vs wall clock): under a `FakeClock` only
*advancing* reads move time, so ``admission`` / ``prefill`` are ~0 and
queue wait + pauses carry the whole story — which is the truth of the
simulation. Under the wall clock the same fields carry real compute
durations measured with non-advancing reads in the engine.

Chrome flow events (`chrome_flows`) stitch a request's path across
engines through handoff/migration: pass them to
`repro_torch.obs.trace.export_chrome(..., flows=...)` and Perfetto draws
arrows from the source engine's lane to the destination's across each
pause.
"""
from __future__ import annotations

import dataclasses
import math
import time  # swapped for the installed clock by install_clock
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from repro_torch.obs.events import Event, Recorder

#: TTFT decomposition keys, reporting order.
TTFT_COMPONENTS = ("queue_wait", "admission", "prefill", "prepare_wait",
                   "handoff_pause")
#: decode-span decomposition keys, reporting order.
TPOT_COMPONENTS = ("decode", "migration_pause", "handoff_pause",
                   "interference")


def _now() -> float:
    """Non-advancing read of the recording clock (same contract as
    `repro_torch.obs.events.now`): assembling a lineage never perturbs a
    simulated run."""
    t = getattr(time, "now", None)
    return time.time() if t is None else t


def _pctl(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending sequence (q in [0, 1])."""
    if not sorted_vals:
        return math.nan
    idx = max(0, min(len(sorted_vals) - 1,
                     math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class RequestTimeline:
    """One completed request's attributed latency.

    Attributes:
        rid: request id.
        label: ``data-type`` label.
        role: serving role of the completing engine.
        engines: engine path, submission order (handoff/migration hops).
        t_submit / t_admit / t_complete: event-bus timestamps.
        ttft_s / tpot_s / tokens_out: the engine-stamped measurements
            from ``request.complete`` (the independent check path).
        ttft_parts: `TTFT_COMPONENTS` -> seconds.
        tpot_parts: `TPOT_COMPONENTS` -> seconds (decode-span units).
    """

    rid: int
    label: str
    role: str
    engines: Tuple[str, ...]
    t_submit: float
    t_admit: float
    t_complete: float
    ttft_s: float
    tpot_s: float
    tokens_out: int
    ttft_parts: Mapping[str, float]
    tpot_parts: Mapping[str, float]
    #: cross-engine moves: (pause_start, pause_end, src, dst, reason)
    hops: Tuple[Tuple[float, float, str, str, str], ...] = ()

    @property
    def decode_steps(self) -> int:
        """Decode intervals the measured TPOT averages over."""
        return max(self.tokens_out - 1, 1)

    @property
    def decode_span_s(self) -> float:
        """Measured decode span: ``tpot_s`` x decode steps (equals
        ``t_done - t_first`` by the engine's TPOT definition)."""
        return self.tpot_s * self.decode_steps

    def ttft_error(self) -> float:
        """Relative conservation error: |sum(parts) - measured| / measured."""
        total = sum(self.ttft_parts.values())
        return abs(total - self.ttft_s) / max(abs(self.ttft_s), 1e-12)

    def tpot_error(self) -> float:
        total = sum(self.tpot_parts.values())
        return abs(total - self.decode_span_s) \
            / max(abs(self.decode_span_s), 1e-12)

    def critical(self, which: str = "ttft") -> str:
        """The dominant component name of one decomposition."""
        parts = self.ttft_parts if which == "ttft" else self.tpot_parts
        return max(parts, key=lambda k: parts[k])


def _reconfig_windows(events: Iterable[Event]) -> Dict[str, List[Tuple[float, float]]]:
    """Per-engine [start, end] pause windows from committed swap/spawn
    events (``downtime_s`` backdates the window from the emit stamp)."""
    out: Dict[str, List[Tuple[float, float]]] = {}
    for ev in events:
        if ev.kind in ("cluster.swap", "cluster.spawn"):
            dur = float(ev.data.get("downtime_s", 0.0))
            out.setdefault(ev.engine, []).append((ev.ts - dur, ev.ts))
    return out


def _overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


class RequestLineage:
    """Assembled per-request timelines plus aggregate views.

    Build with `from_recorder` (live `Recorder`) or `from_events`
    (e.g. events reloaded from a debug bundle). Requests whose
    submit/admit events fell off the bounded event ring are counted in
    ``partial_rids`` and excluded — attribution never guesses.
    """

    def __init__(self, timelines: Sequence[RequestTimeline],
                 partial_rids: Sequence[int] = ()):
        self.timelines = sorted(timelines, key=lambda tl: tl.rid)
        self.partial_rids = sorted(partial_rids)
        self.built_at = _now()
        self._by_rid = {tl.rid: tl for tl in self.timelines}

    def __len__(self) -> int:
        return len(self.timelines)

    def get(self, rid: int) -> Optional[RequestTimeline]:
        return self._by_rid.get(rid)

    # -- assembly ------------------------------------------------------
    @classmethod
    def from_recorder(cls, rec: Recorder) -> "RequestLineage":
        return cls.from_events(rec.events())

    @classmethod
    def from_events(cls, events: Sequence[Event]) -> "RequestLineage":
        submits: Dict[int, Event] = {}
        admits: Dict[int, Event] = {}
        pauses: Dict[int, List[Event]] = {}
        for ev in events:
            if ev.kind == "request.submit":
                submits[ev.rid] = ev
            elif ev.kind == "request.admit":
                admits[ev.rid] = ev
            elif ev.kind == "migration.pause" and ev.rid >= 0:
                pauses.setdefault(ev.rid, []).append(ev)
        reconfig = _reconfig_windows(events)

        timelines: List[RequestTimeline] = []
        partial: List[int] = []
        for ev in events:
            if ev.kind != "request.complete":
                continue
            sub = submits.get(ev.rid)
            adm = admits.get(ev.rid)
            if sub is None or adm is None:
                partial.append(ev.rid)
                continue
            timelines.append(cls._assemble(
                sub, adm, ev, pauses.get(ev.rid, []), reconfig))
        return cls(timelines, partial)

    @staticmethod
    def _assemble(sub: Event, adm: Event, done: Event,
                  pauses: Sequence[Event],
                  reconfig: Mapping[str, Sequence[Tuple[float, float]]]
                  ) -> RequestTimeline:
        ttft_s = float(done.data.get("ttft_s", math.nan))
        tpot_s = float(done.data.get("tpot_s", 0.0))
        if not math.isfinite(tpot_s):
            tpot_s = 0.0
        tokens_out = int(done.data.get("tokens_out", 1))

        # TTFT side: components measured in the engine (non-advancing
        # reads), prepare windows overlapped from swap/spawn commits on
        # the admitting engine, pre-admission handoff pauses, and queue
        # wait as the conserved residual.
        prefill = float(adm.data.get("prefill_s", 0.0))
        admission = float(adm.data.get("admit_s", 0.0))
        prepare_wait = sum(
            _overlap(sub.ts, adm.ts, w0, w1)
            for w0, w1 in reconfig.get(adm.engine, ()))
        ttft_handoff = sum(float(p.data.get("pause_s", 0.0))
                           for p in pauses
                           if p.ts <= adm.ts
                           and p.data.get("reason") == "handoff")
        ttft_ev = adm.ts - sub.ts
        queue_wait = ttft_ev - prefill - admission - prepare_wait \
            - ttft_handoff
        ttft_parts = {"queue_wait": queue_wait, "admission": admission,
                      "prefill": prefill, "prepare_wait": prepare_wait,
                      "handoff_pause": ttft_handoff}

        # decode side: pauses after admission split handoff vs migration
        # (never double counted — keyed on the event's reason, like the
        # SLO ledger), interference stalls when the engine reports them,
        # decode compute as the conserved residual.
        mig = hand = 0.0
        for p in pauses:
            if p.ts <= adm.ts:
                continue
            pause_s = float(p.data.get("pause_s", 0.0))
            if p.data.get("reason") == "handoff":
                hand += pause_s
            else:
                mig += pause_s
        interference = float(done.data.get("interference_s", 0.0))
        span_ev = done.ts - adm.ts
        decode = span_ev - mig - hand - interference
        tpot_parts = {"decode": decode, "migration_pause": mig,
                      "handoff_pause": hand, "interference": interference}

        engines: List[str] = [sub.engine]
        hops: List[Tuple[float, float, str, str, str]] = []
        for p in sorted(pauses, key=lambda p: (p.ts, p.seq)):
            dst = str(p.data.get("dst", ""))
            if dst and dst != engines[-1]:
                pause_s = float(p.data.get("pause_s", 0.0))
                hops.append((p.ts - pause_s, p.ts, engines[-1], dst,
                             str(p.data.get("reason", "migration"))))
                engines.append(dst)
        if done.engine and done.engine != engines[-1]:
            engines.append(done.engine)

        return RequestTimeline(
            rid=done.rid, label=done.label,
            role=str(done.data.get("role", "unified") or "unified"),
            engines=tuple(engines),
            t_submit=sub.ts, t_admit=adm.ts, t_complete=done.ts,
            ttft_s=ttft_s, tpot_s=tpot_s, tokens_out=tokens_out,
            ttft_parts=ttft_parts, tpot_parts=tpot_parts,
            hops=tuple(hops))

    # -- conservation --------------------------------------------------
    def conservation(self, eps: float = 0.01) -> Dict[str, Any]:
        """Check every timeline's components against the independently
        measured TTFT / decode span; returns max/mean relative error and
        the rids violating ``eps``."""
        ttft_errs = [tl.ttft_error() for tl in self.timelines
                     if math.isfinite(tl.ttft_s)]
        tpot_errs = [tl.tpot_error() for tl in self.timelines
                     if tl.decode_span_s > 0]
        bad = [tl.rid for tl in self.timelines
               if (math.isfinite(tl.ttft_s) and tl.ttft_error() > eps)
               or (tl.decode_span_s > 0 and tl.tpot_error() > eps)]
        return {
            "n": len(self.timelines),
            "n_partial": len(self.partial_rids),
            "eps": eps,
            "ttft_max_rel_err": max(ttft_errs) if ttft_errs else 0.0,
            "ttft_mean_rel_err": (sum(ttft_errs) / len(ttft_errs))
            if ttft_errs else 0.0,
            "tpot_max_rel_err": max(tpot_errs) if tpot_errs else 0.0,
            "tpot_mean_rel_err": (sum(tpot_errs) / len(tpot_errs))
            if tpot_errs else 0.0,
            "violations": bad,
        }

    # -- aggregation ---------------------------------------------------
    def critical_path(self) -> Dict[str, Dict[str, Any]]:
        """Per-label component percentiles and the dominant component.

        For each label and each decomposition, reports every component's
        p50/p99 over that label's requests plus ``dominant_p50`` /
        ``dominant_p99`` — the component with the largest value at that
        percentile of its own distribution (ties break on
        `TTFT_COMPONENTS` / `TPOT_COMPONENTS` order).
        """
        by_label: Dict[str, List[RequestTimeline]] = {}
        for tl in self.timelines:
            by_label.setdefault(tl.label or "*", []).append(tl)
        out: Dict[str, Dict[str, Any]] = {}
        for label in sorted(by_label):
            tls = by_label[label]
            entry: Dict[str, Any] = {"n": len(tls)}
            for which, comps in (("ttft", TTFT_COMPONENTS),
                                 ("tpot", TPOT_COMPONENTS)):
                parts = {c: sorted(
                    (tl.ttft_parts if which == "ttft"
                     else tl.tpot_parts)[c] for tl in tls)
                    for c in comps}
                view: Dict[str, Any] = {}
                for q, name in ((0.50, "p50"), (0.99, "p99")):
                    vals = {c: _pctl(parts[c], q) for c in comps}
                    view[name] = vals
                    view[f"dominant_{name}"] = max(
                        comps, key=lambda c: vals[c])
                entry[which] = view
            out[label] = entry
        return out

    # -- Chrome flow events --------------------------------------------
    def chrome_flows(self) -> List[Dict[str, Any]]:
        """Flow-event specs stitching multi-engine requests across
        handoff/migration pauses, for
        `repro_torch.obs.trace.export_chrome(..., flows=...)`: one ``"s"`` on
        the source lane at pause start, one ``"f"`` on the destination
        lane at pause end, keyed by rid."""
        flows: List[Dict[str, Any]] = []
        for tl in self.timelines:
            for hop, (t0, t1, src, dst, reason) in enumerate(tl.hops):
                fid = tl.rid * 16 + hop   # unique per (request, hop)
                flows.append({"name": f"rid {tl.rid} {reason}",
                              "id": fid, "ph": "s",
                              "track": src, "ts": t0})
                flows.append({"name": f"rid {tl.rid} {reason}",
                              "id": fid, "ph": "f",
                              "track": dst, "ts": max(t1, t0)})
        return flows
