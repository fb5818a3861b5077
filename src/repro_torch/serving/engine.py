"""Continuous-batching serving engine with per-request TTFT/TPOT metrics
and the reference's reconfiguration lifecycle.

The reference's engine (`repro.serving.engine.ServingEngine`) on one of two
pools, chosen by the model's cache:

- paged (attention models, the default for them): KV lives in a
  `PagedKVPool`; a request is admitted with a single-sequence ``prefill``
  whose cache is written into the pages it reserved, and all resident
  requests decode together in one batched paged ``decode_step``, packed
  into the lowest lanes every step.
- slot-granular (SSM models, whose recurrent state has no sequence axis to
  page; attention models too with ``paged=False``): the pool is
  ``model.init_cache(n_slots, s_max)``, a request owns one slot (batch row)
  for its life, its exact-length prefill is written into that slot, and
  every slot decodes in one ``decode_step`` at its own position.

Lifecycle (the public swap protocol):

    engine.pause()                     # stop stepping; submissions queue
    engine.drain()                     # wait for the device's queued work
    engine.swap_plan(plan,             # place params/cache by the plan and
                     placement=...,    #   install what PREPARE warmed
                     executables=...)
    engine.resume()

The decode step runs as a `DecodeExecutable` (`serving/executable.py`), the
counterpart of the reference's compiled decode: static token, position and
page-table buffers and an on-device greedy pick. On the card it is a CUDA
graph of the whole step: PREPARE (`prepare_executables`) captures it beside
serving, the swap installs it, and `step` replays it; an engine with none
installed runs its first decode eagerly and captures for the steps after it
(the reference's JIT at first call). On the CPU the same executable runs the
step eagerly over the same buffers. PREPARE also warms prefill at each live
prompt length and bucket on scratch state (prefill stays eager: PyTorch has
no ahead-of-time compile for it). Live migration moves one
request's state between engines (`export_slot` / `import_slot`); each ends
in a device synchronisation, so a pause it stamps is the device's time.
Cluster knobs (``labels``, ``role``, ``plan``) only steer the cluster.

Greedy sampling takes the first index on ties, as the reference's
``np.argmax`` does (decode picks with ``torch.argmax`` on the device). The
engine runs on the card unless it is given ``device="cpu"`` (and a model on
the CPU).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.models.lm import POSITIONAL_LEAVES
from repro_torch.obs import events as obs_events
from repro_torch.serving import kvpool, migration
from repro_torch.serving.clock import SYSTEM_CLOCK
from repro_torch.serving.executable import DecodeExecutable
from repro_torch.serving.migration import MigrationError, SlotSnapshot, sync
from repro_torch.sharding.plan import ShardingPlan, default_plan

METRIC_KEYS = ("completed", "ttft_mean_s", "ttft_p99_s",
               "tpot_mean_s", "tpot_p99_s")


class EngineStateError(RuntimeError):
    """Raised when a lifecycle method is called in the wrong state."""


@dataclasses.dataclass
class Request:
    """One generation request flowing through an engine.

    Attributes:
        rid: caller-chosen request id.
        prompt: ``(S_prompt,)`` int32 token ids.
        max_new_tokens: decode budget; generation also stops at the KV
            pool's sequence capacity.
        labels: tenancy labels (e.g. ``{"data-type": "phi"}``) — the
            cluster routes and aggregates on these.
        t_submit / t_first / t_done: wall-clock stamps set by the engine at
            submission, first token, and completion.
        tokens_out: generated token ids (first entry comes from prefill).
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    tokens_out: List[int] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float:
        """Time to first token (seconds): first-token stamp - submit."""
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float:
        """Mean time per output token (seconds) over the decode phase."""
        n = max(len(self.tokens_out) - 1, 1)
        return (self.t_done - self.t_first) / n


def compute_metrics(done: Sequence[Request]) -> Dict[str, float]:
    """TTFT/TPOT summary over completed requests: always the full
    `METRIC_KEYS` set, NaN for undefined statistics."""
    out: Dict[str, float] = {
        "completed": len(done),
        "ttft_mean_s": math.nan, "ttft_p99_s": math.nan,
        "tpot_mean_s": math.nan, "tpot_p99_s": math.nan,
    }
    if done:
        ttfts = [r.ttft for r in done]
        tpots = [r.tpot for r in done]
        out.update(
            ttft_mean_s=float(np.mean(ttfts)),
            ttft_p99_s=float(np.percentile(ttfts, 99)),
            tpot_mean_s=float(np.mean(tpots)),
            tpot_p99_s=float(np.percentile(tpots, 99)),
        )
    return out


class ServingEngine:
    """Single-model engine; decode batch of ``n_slots`` sequences, greedy
    sampling.

    Args:
        model: the `repro_torch.models.Model` to serve (its params). Engines
            of one cluster on one card may share one model: the engine
            never copies or casts its params.
        n_slots: continuous-batching width (decode batch dim).
        s_max: KV sequence capacity per request.
        plan: initial `ShardingPlan`; `default_plan()` when omitted.
        labels: tenancy labels. Under cluster routing an engine label only
            EXCLUDES requests that carry a contradicting value; an
            unlabeled engine serves all.
        role: ``"unified"`` (default: serves a request end to end),
            ``"prefill"`` (receives new requests; the cluster hands each one
            off to a decode engine at its first token) or ``"decode"``
            (never routed new requests; receives in-flight work by
            migration). The engine serves alike in every role.
        paged: the paged pool (True) or the slot-granular one (False);
            None picks paged exactly when the model's cache can be paged
            (`kvpool.supports_paging`).
        page_size: tokens per KV page (clamped to ``s_max``; paged only).
        kv_tokens: token capacity of the pool (admission budget); defaults
            to ``n_slots * ceil(s_max / page_size) * page_size`` (paged
            only).
        watermark: free pages admissions must leave behind, allocated on
            top of ``kv_tokens`` (headroom for migration imports, which may
            spend it; paged only).
        prefill_buckets: pad each prompt to the smallest power-of-two bucket
            (`bucket_lengths`) and read its logits at ``true_len - 1``,
            instead of a prefill of the exact length. A model that cannot
            be padded (`supports_padded_prefill`) has no buckets. A swap
            that installs PREPARE's buckets turns this on too.
        device: where the engine runs; must be the model's device.
            ``"cuda"`` unless the caller names the CPU.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
        ValueError: the model lives on another device, ``paged=True`` for a
            model that cannot be paged, or an unknown ``role``.
    """

    ROLES = ("unified", "prefill", "decode")
    # cap on the prompt lengths PREPARE warms when it is given none: only
    # the most recently seen lengths predict live traffic
    MAX_AOT_PREFILL = 8
    BUCKET_MIN = 8

    def __init__(self, model: Model, *, n_slots: int = 4, s_max: int = 128,
                 plan: Optional[ShardingPlan] = None,
                 labels: Optional[Dict[str, str]] = None,
                 role: str = "unified",
                 paged: Optional[bool] = None, page_size: int = 16,
                 kv_tokens: Optional[int] = None, watermark: int = 0,
                 prefill_buckets: bool = False,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.model = model
        self.n_slots = n_slots
        self.s_max = s_max
        self.vocab = model.cfg.vocab_size
        self.plan = plan or default_plan()
        self.labels = dict(labels or {})
        self.role = role
        # display name for flight-recorder events; the cluster sets it to
        # the registered engine name
        self.obs_name = ""

        can_page = kvpool.supports_paging(model)
        if paged and not can_page:
            raise ValueError(f"{model.cfg.name}: the cache holds recurrent (SSM) "
                             "state, which cannot be paged")
        self.paged = can_page if paged is None else bool(paged)
        if self.paged:
            self.page_size = min(page_size, s_max)
            self.pages_per_seq = -(-s_max // self.page_size)
            if kv_tokens is None:
                kv_tokens = n_slots * self.pages_per_seq * self.page_size
            self.pool: Optional[kvpool.PagedKVPool] = kvpool.PagedKVPool(
                self.page_size, -(-kv_tokens // self.page_size) + watermark,
                watermark=watermark)
            self._pax, self._sax = kvpool.page_axes(model)
            self.cache = self.pool.init_store(model)
            # per-lane page tables (scratch-padded to pages_per_seq) and the
            # owned-page lists the allocator accounting tracks
            self.page_tables = np.full((n_slots, self.pages_per_seq),
                                       kvpool.SCRATCH_PAGE, dtype=np.int64)
            self.slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
            self._decode = kvpool.make_paged_decode(model, self._pax, self._sax)
        else:
            self.pool = None
            self.cache = model.init_cache(n_slots, s_max)
        self._bucket_lengths = self.bucket_lengths() if prefill_buckets else []

        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self.steps = 0
        self.paused = False
        self.seen_prompt_lengths: Dict[int, int] = {}   # length -> last seq
        self._submit_seq = 0
        self._batch_axes: Optional[Dict[str, int]] = None
        self._migration_warm = False
        self._collectives: Optional[List[Collective]] = None
        # guards the bucket ladder and the installed decode executable
        # against a swap committed from a control thread while
        # step()/_admit() pick their path
        self._exec_lock = threading.Lock()
        self._decode_exec: Optional[DecodeExecutable] = None
        # page_tables changed since the executable's table buffer was written
        self._tables_dirty = True
        # executables replaced by a swap, freed at the next step: outside
        # the swap window, after the device is done with them
        self._retired: List[DecodeExecutable] = []
        #: decode-path counts: steps run eagerly (every step on the CPU, the
        #: first on the card) and graph replays; captures (the first step's
        #: and PREPARE's) and their seconds; PREPARE executables a swap
        #: installed or discarded (bound to a pool the swap replaced)
        self.decode_stats = {"eager": 0, "replays": 0, "captures": 0,
                             "capture_s": 0.0, "installs": 0, "discards": 0}

    @property
    def role(self) -> str:
        """Disaggregation role (``"unified"``/``"prefill"``/``"decode"``);
        assignment validates fail-closed."""
        return self._role

    @role.setter
    def role(self, value: str) -> None:
        if value not in self.ROLES:
            raise ValueError(f"unknown engine role {value!r} "
                             f"(expected one of {self.ROLES})")
        self._role = value

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def pause(self) -> None:
        """Stop stepping. Submissions still queue; `step()` raises while
        paused."""
        self.paused = True

    def drain(self) -> int:
        """Block until all queued device work has finished. Returns the
        number of requests still resident (drain is a barrier, not an
        eviction)."""
        sync(self.device)
        return sum(r is not None for r in self.slot_req)

    def swap_plan(self, plan: Optional[ShardingPlan] = None, *,
                  placement: Optional[Dict[str, torch.device]] = None,
                  executables: Optional[Dict[str, Any]] = None) -> int:
        """Install a new plan: place params and cache by ``placement`` and
        install what PREPARE warmed (``executables``). Must be called
        paused — this is the blocking window.

        Args:
            plan: the new `ShardingPlan` to record (routing reads it);
                ``None`` keeps the current plan.
            placement: ``{"params": device, "cache": device}`` from
                `plan_to_placement`. The cache moves there (a no-op on its
                own device); the params, which engines may share, are never
                copied or cast, so they must already live there.
            executables: ``{"decode": DecodeExecutable, "prefill": prompt
                lengths warmed, "prefill_buckets": bucket lengths,
                "collectives": the decode step's}`` from
                `prepare_executables`; the decode executable is installed
                when it is bound to the pool as it stands after the
                placement, else discarded (counted in `decode_stats`) and
                the next step captures anew; a non-empty bucket list turns
                on padded prefill over those buckets, and the collectives
                become `decode_collectives`. Nothing is captured or
                compiled here: the window stays a pointer swap.

        Returns:
            The bytes the placement covers — params + cache whenever a
            placement is given (the reference's count), else 0.

        Raises:
            EngineStateError: the engine is not paused.
            ValueError: the placement puts the params on another device.
        """
        if not self.paused:
            raise EngineStateError("swap_plan requires a paused engine "
                                   "(call pause(); drain() first)")
        migrated = 0
        if placement is not None:
            dev = placement.get("params", self.device)
            if torch.device(dev) != self.model.device:
                raise ValueError(f"placement puts the params on {dev}, but they "
                                 f"live on {self.model.device} and may be shared")
            migrated = migration.state_bytes(self.model.params) + migration.state_bytes(self.cache)
            if "cache" in placement:
                self.cache = {k: v.to(placement["cache"]) for k, v in self.cache.items()}
            sync(self.device)
            self._migration_warm = False
            self._collectives = None
        # an executable over a pool that is no longer the engine's is
        # stale: the next step captures anew
        if self._decode_exec is not None and not self._decode_exec.bound_to(self.cache):
            self._install(None)
        if executables:
            with self._exec_lock:
                buckets = executables.get("prefill_buckets")
                if buckets:
                    self._bucket_lengths = sorted(buckets)
            decode = executables.get("decode")
            if decode is not None and decode.bound_to(self.cache):
                self._install(decode)
                self.decode_stats["installs"] += 1
            elif decode is not None:
                self._retired.append(decode)
                self.decode_stats["discards"] += 1
            if "collectives" in executables:
                self._collectives = list(executables["collectives"])
        if plan is not None:
            self.plan = plan
        return migrated

    def resume(self) -> None:
        """Leave the paused state and serve again (idempotent)."""
        self.paused = False

    @property
    def decode_executable(self) -> Optional[DecodeExecutable]:
        """The installed decode executable that `step` runs, if any."""
        with self._exec_lock:
            return self._decode_exec

    def _install(self, exe: Optional[DecodeExecutable]) -> None:
        """Make ``exe`` the executable `step` runs; the one it replaces is
        freed at the next step. Its table buffer is written at that step."""
        with self._exec_lock:
            old, self._decode_exec = self._decode_exec, exe
        if old is not None and old is not exe:
            self._retired.append(old)
        self._tables_dirty = True

    # ------------------------------------------------------------------
    # PREPARE (runs while serving continues)
    # ------------------------------------------------------------------
    def supports_padded_prefill(self) -> bool:
        """Whether bucket-padded prefill is sound for this model: every
        mixer must be attention (causal attention never reads the padding),
        the condition under which the cache can be paged too. An SSM mixer
        folds the whole padded sequence into its state."""
        return kvpool.supports_paging(self.model)

    def recent_prompt_lengths(self, cap: Optional[int] = None) -> Tuple[int, ...]:
        """Snapshot of the most recently seen distinct prompt lengths (at
        most ``cap``, default `MAX_AOT_PREFILL`), sorted ascending; safe to
        hand to a PREPARE thread."""
        cap = cap or self.MAX_AOT_PREFILL
        seen = dict(self.seen_prompt_lengths)    # atomic copy under the GIL
        return tuple(sorted(sorted(seen, key=seen.get)[-cap:]))

    def bucket_lengths(self) -> List[int]:
        """The padded-prefill bucket ladder: powers of two from
        `BUCKET_MIN` up to (and always including) ``s_max``. Empty when
        the model cannot be padded (`supports_padded_prefill`)."""
        if not self.supports_padded_prefill():
            return []
        out: List[int] = []
        b = self.BUCKET_MIN
        while b < self.s_max:
            out.append(b)
            b *= 2
        out.append(self.s_max)
        return out

    def _scratch_decode_inputs(self):
        """A decode step's inputs at the live batch shape on scratch state:
        every lane at position 0 of a one-page scratch store (paged) or of
        a fresh slot pool — never the live pool."""
        tokens = torch.zeros((self.n_slots, 1), dtype=torch.long, device=self.device)
        pos = torch.zeros(self.n_slots, dtype=torch.long, device=self.device)
        if self.paged:
            store = self.model.init_cache(1, self.page_size)     # page 0 only
            tables = torch.full((self.n_slots, self.pages_per_seq),
                                kvpool.SCRATCH_PAGE, dtype=torch.long,
                                device=self.device)
            return lambda: self._decode(tokens, store, pos, tables)
        cache = self.model.init_cache(self.n_slots, self.s_max)
        return lambda: self.model.decode_step(tokens, cache, pos)

    def prepare_executables(self, placement: Dict[str, torch.device],
                            prefill_lengths: Sequence[int] = (), *,
                            prefill_buckets: bool = False,
                            ) -> Tuple[Dict[str, Any], int]:
        """The PREPARE phase (the reference's ``aot_executables``): one
        decode step at the live batch shape on scratch state, then the
        decode executable (`DecodeExecutable`) built over the live pool, on
        the card captured as a CUDA graph without running it; then prefill
        warmed at each prompt length (and each bucket) on scratch inputs,
        and a synchronisation. Runs beside serving: the live pool is never
        written. Prefill stays eager, so its warm-up only builds the
        kernels' library at first use and grows the allocator and library
        handles before the swap window.

        Args:
            placement: the target ``{"params": ..., "cache": ...}``.
            prefill_lengths: prompt lengths to warm; when empty, the
                engine's most recently seen lengths (`recent_prompt_lengths`).
            prefill_buckets: also warm the padded-bucket ladder
                (`bucket_lengths`), which the swap then installs.

        Returns:
            ``(executables, n_compiled)`` in the shape `swap_plan` takes;
            ``n_compiled`` counts as the reference does: 1 (decode) + the
            lengths + the buckets.

        Raises:
            ValueError: the placement is not this engine's device.
            RuntimeError: the decode step could not be captured.
        """
        dev = torch.device(placement.get("cache", self.device))
        if dev != self.device:
            raise ValueError(f"placement on {dev}; this engine runs on {self.device}")
        lengths = (sorted(set(prefill_lengths)) if prefill_lengths
                   else list(self.recent_prompt_lengths()))
        buckets = self.bucket_lengths() if prefill_buckets else []
        # the decode warm-up, traced where a process group exists: the swap
        # installs its collectives, so the post-swap check never traces on
        # the serving thread. With no group none can be dispatched.
        step = self._scratch_decode_inputs()
        if _has_process_group():
            collectives = _trace_collectives(step, self.device)
        else:
            step()
            collectives = []
        decode = self._capture(DecodeExecutable(self))
        for S in lengths:
            self.model.prefill({"tokens": torch.zeros(
                (1, S), dtype=torch.long, device=self.device)})
        for S in buckets:
            self.model.prefill({"tokens": torch.zeros(
                (1, S), dtype=torch.long, device=self.device), "true_len": 1})
        sync(self.device)
        return ({"decode": decode, "prefill": tuple(lengths),
                 "prefill_buckets": tuple(buckets), "collectives": tuple(collectives)},
                1 + len(lengths) + len(buckets))

    def _capture(self, exe: DecodeExecutable) -> DecodeExecutable:
        """Capture ``exe``'s graph (on the card), counted in `decode_stats`.

        Timed on the wall clock (`SYSTEM_CLOCK`, which `install_clock`
        never swaps): a capture is host work the reference's engine has no
        counterpart of, so it must not advance a simulated clock — a replay
        reads the installed clock as often, and in the same order, as the
        reference's."""
        t0 = SYSTEM_CLOCK.perf_counter()
        if exe.capture(lambda: self._scratch_decode_inputs()()):
            dt = SYSTEM_CLOCK.perf_counter() - t0
            with self._exec_lock:
                self.decode_stats["captures"] += 1
                self.decode_stats["capture_s"] += dt
        return exe

    def decode_collectives(self) -> List["Collective"]:
        """The collectives one decode step issues (the reference's
        ``decode_hlo_text`` check, over the port's dispatched ops): what
        the last PREPARE recorded, else one step traced now on scratch
        state (`_trace_collectives`). With no process group no collective
        can be dispatched, so nothing is traced and the list is empty.
        Recorded once per placement.

        Raises:
            RuntimeError: the step could not be traced; the cluster fails
                closed on it.
        """
        if self._collectives is None:
            self._collectives = (_trace_collectives(self._scratch_decode_inputs(),
                                                    self.device)
                                 if _has_process_group() else [])
        return list(self._collectives)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request (stamps ``t_submit``; records its prompt length
        for PREPARE). Works while paused."""
        req.t_submit = time.time()
        self.note_prompt_length(len(req.prompt))
        self.queue.append(req)
        rec = obs_events.RECORDER
        if rec is not None:
            rec.emit("request.submit", engine=self.obs_name, rid=req.rid,
                     label=req.labels.get("data-type", ""),
                     prompt_len=len(req.prompt),
                     max_new_tokens=req.max_new_tokens)

    def note_prompt_length(self, length: int) -> None:
        """Record a prompt length as recently seen (feeds PREPARE's default
        lengths) without re-stamping the request — used when a request
        migrates onto this engine."""
        self._submit_seq += 1
        self.seen_prompt_lengths[length] = self._submit_seq

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    @property
    def load(self) -> int:
        """Queued + resident requests."""
        return len(self.queue) + sum(r is not None for r in self.slot_req)

    @property
    def free_slots(self) -> int:
        """Decode lanes currently unoccupied."""
        return sum(r is None for r in self.slot_req)

    @property
    def kv_token_capacity(self) -> int:
        """Total KV tokens this engine can hold for admissions (>= 0); a
        slot pool holds ``s_max`` per slot."""
        if self.paged:
            return max(self.pool.n_pages - self.pool.watermark, 0) * self.page_size
        return self.n_slots * self.s_max

    @property
    def free_tokens(self) -> int:
        """KV tokens still available to admissions (>= 0): admittable
        pages, or free slots times ``s_max``."""
        if self.paged:
            return max(self.pool.admittable_pages, 0) * self.page_size
        return self.free_slots * self.s_max

    @property
    def kv_allocated_tokens(self) -> int:
        """KV tokens reserved by resident requests: their pages, or a full
        ``s_max`` per occupied slot."""
        if self.paged:
            return self.pool.allocated_tokens
        return sum(r is not None for r in self.slot_req) * self.s_max

    @property
    def kv_used_tokens(self) -> int:
        """KV tokens written by resident requests (their positions)."""
        return int(sum(int(self.slot_pos[i])
                       for i, r in enumerate(self.slot_req) if r is not None))

    @property
    def kv_utilization(self) -> float:
        """Used / allocated KV tokens; 0.0 when nothing is resident."""
        alloc = self.kv_allocated_tokens
        return self.kv_used_tokens / alloc if alloc else 0.0

    def admission_tokens(self, need: int) -> int:
        """Token capacity that admitting a ``need``-token extent would take
        (page-rounded; a slot pool always spends a whole slot)."""
        if self.paged:
            return self.pool.pages_for(min(need, self.s_max)) * self.page_size
        return self.s_max

    def fits_inflight(self, needs: Sequence[int]) -> bool:
        """Could decoding requests with these capacity needs be imported now
        (lanes, and pages with the watermark included)?"""
        if len(needs) > self.free_slots:
            return False
        if self.paged:
            pages = sum(self.pool.pages_for(min(n, self.s_max)) for n in needs)
            return pages <= self.pool.free_pages
        return True

    @property
    def cache_batch(self) -> int:
        """Batch dim of the live KV store: the page count, or ``n_slots``."""
        return self.pool.store_batch if self.paged else self.n_slots

    def single_layout(self) -> Dict[str, tuple]:
        """Shapes of one request's single-sequence cache in this engine's
        layout: the page-rounded extent, or ``s_max`` for a slot pool."""
        S = self.pages_per_seq * self.page_size if self.paged else self.s_max
        return self.model.cache_shapes(1, S)

    def _admit(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            # attribution stamps: non-advancing reads on the recording clock
            rec = obs_events.RECORDER
            t_adm0 = obs_events.now() if rec is not None else 0.0
            pages: List[int] = []
            if self.paged:
                head = self.queue[0]
                need = min(len(head.prompt) + head.max_new_tokens, self.s_max)
                try:
                    pages = self.pool.alloc(self.pool.pages_for(need))
                except kvpool.PoolOOM:
                    return    # fail closed: stays queued, FIFO order kept
            req = self.queue.pop(0)
            S = len(req.prompt)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None, :]
            batch: Dict[str, Any] = {"tokens": prompt}
            with self._exec_lock:
                bucket = next((b for b in self._bucket_lengths if b >= S), None)
            if bucket is not None:
                batch = {"tokens": torch.nn.functional.pad(prompt, (0, bucket - S)),
                         "true_len": S}
            t_pre0 = obs_events.now() if rec is not None else 0.0
            logits, cache1 = self.model.prefill(batch)
            tok = int(np.argmax(logits[0, : self.vocab].float().cpu().numpy()))
            t_pre1 = obs_events.now() if rec is not None else 0.0
            req.tokens_out.append(tok)
            req.t_first = time.time()
            if rec is not None:
                rec.emit("request.admit", engine=self.obs_name, rid=req.rid,
                         label=req.labels.get("data-type", ""),
                         queue_wait_s=req.t_first - req.t_submit,
                         admit_s=max(0.0, t_pre0 - t_adm0),
                         prefill_s=max(0.0, t_pre1 - t_pre0),
                         role=self.role)
            if self.paged:
                # the scratch-padded table tail absorbs bucket slack (never
                # read: decode masks by position)
                row = pages + [kvpool.SCRATCH_PAGE] * (self.pages_per_seq - len(pages))
                kvpool.write_pages(self.cache, cache1, row, self._pax, self._sax)
                self.page_tables[slot] = row
                self.slot_pages[slot] = pages
                self._tables_dirty = True
            else:
                _write_slot(self.cache, cache1, slot)
            self.slot_req[slot] = req
            self.slot_pos[slot] = S

    def _release_lane(self, slot: int) -> None:
        """Clear a lane; a paged lane's pages go back to the pool at once (a
        slot's state stays until the next admission overwrites it)."""
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        if self.paged:
            self.pool.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self.page_tables[slot] = kvpool.SCRATCH_PAGE
            self._tables_dirty = True

    def _compact(self) -> None:
        """Pack active requests into the lowest decode lanes; the page-table
        rows travel with their requests (decode is row-wise)."""
        order = [i for i, r in enumerate(self.slot_req) if r is not None]
        if order == list(range(len(order))):
            return
        n = len(order)
        req = [self.slot_req[i] for i in order]
        pos = [int(self.slot_pos[i]) for i in order]
        pages = [self.slot_pages[i] for i in order]
        tables = self.page_tables[order].copy()
        self.slot_req = req + [None] * (self.n_slots - n)
        self.slot_pos[:] = 0
        self.slot_pos[:n] = pos
        self.slot_pages = pages + [[] for _ in range(self.n_slots - n)]
        self.page_tables[:] = kvpool.SCRATCH_PAGE
        self.page_tables[:n] = tables
        self._tables_dirty = True

    # ------------------------------------------------------------------
    # live migration (export / import one request's state)
    # ------------------------------------------------------------------
    def _migration_axes(self) -> Dict[str, int]:
        """Per-leaf batch axis of the pool's layout (cached)."""
        if self._batch_axes is None:
            self._batch_axes = migration.batch_axis_tree(self.model, self.s_max)
        return self._batch_axes

    def warm_migration(self) -> None:
        """Run the pool surgery the migration path uses once, at the live
        shapes and dtypes, on scratch state — a one-page store (paged) or
        a one-slot pool — so no live row is touched and a later
        `export_slot`/`import_slot` pays no first use. Idempotent."""
        if self._migration_warm:
            return
        if self.paged:
            store = self.model.init_cache(1, self.page_size)     # page 0 only
            row = [kvpool.SCRATCH_PAGE] * self.pages_per_seq
            kv = kvpool.gather_pages(store, torch.as_tensor([row], device=self.device),
                                     self._pax, self._sax)
            single = migration.place_like(
                migration.fit_single(kv, self.single_layout()), store)
            kvpool.write_pages(store, single, row, self._pax, self._sax)
        else:
            axes = self._migration_axes()
            pool = self.model.init_cache(1, self.s_max)
            kv = migration.slice_slot(pool, axes, 0)
            single = migration.place_like(
                migration.fit_single(kv, self.single_layout()), pool)
            migration.write_single(pool, single, axes, 0)
        sync(self.device)
        self._migration_warm = True

    def export_slot(self, rid: int) -> SlotSnapshot:
        """Detach request ``rid`` from this engine as a `SlotSnapshot`.

        A resident request's state is copied out of the pool (its pages
        gathered, or its slot sliced) and its lane freed; the device is
        synchronised before this returns. A queued request exports as a
        ``phase="queued"`` snapshot. In both cases ``max_new_tokens`` is
        clamped to what THIS pool could still have produced.

        Raises:
            KeyError: ``rid`` is neither resident nor queued here.
        """
        for slot, r in enumerate(self.slot_req):
            if r is not None and r.rid == rid:
                pos = int(self.slot_pos[slot])
                room = self.s_max - 1 - pos
                if r.max_new_tokens - len(r.tokens_out) > room:
                    r.max_new_tokens = len(r.tokens_out) + room
                if self.paged:
                    # full-width table: the scratch-padded tail lies at
                    # positions >= pos, masked on the importer
                    kv = kvpool.gather_pages(
                        self.cache,
                        torch.as_tensor(self.page_tables[slot][None, :],
                                        device=self.device),
                        self._pax, self._sax)
                else:
                    kv = migration.slice_slot(self.cache, self._migration_axes(), slot)
                sync(self.device)
                self._release_lane(slot)
                return SlotSnapshot(rid=rid, request=r, phase="decoding",
                                    pos=pos, kv=kv, src_s_max=self.s_max)
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(i)
                r.max_new_tokens = min(r.max_new_tokens, self.s_max - len(r.prompt))
                return SlotSnapshot(rid=rid, request=r, phase="queued",
                                    pos=len(r.prompt), kv=None, src_s_max=self.s_max)
        raise KeyError(f"request {rid} is not on this engine")

    def import_slot(self, snapshot: SlotSnapshot, *,
                    kv_fitted: Optional[Dict[str, torch.Tensor]] = None) -> int:
        """Adopt a migrated request: re-queue a ``"queued"`` snapshot, or
        write a ``"decoding"`` snapshot's state into a free lane (refit to
        this pool's single-sequence layout; a paged pool reserves its
        pages, spending the watermark if needed) and resume decode at the
        snapshot position. The device is synchronised before this returns.
        Submission stamps are kept.

        Args:
            kv_fitted: the snapshot's state already fitted and placed for
                this engine (`migration.migrate_many` moves a cohort at
                once and hands each request its row).

        Returns:
            State bytes written into the pool (0 for a queued snapshot).

        Raises:
            MigrationError: fail-closed, with this engine unchanged — the
                pool cannot finish the request's generation, no lane is
                free, or the paged pool is out of pages.
        """
        need = migration.required_capacity(snapshot)
        if need > self.s_max:
            raise MigrationError(
                f"request {snapshot.rid} needs sequence capacity {need} "
                f"but this pool has s_max={self.s_max} — failing closed")
        req = snapshot.request
        if snapshot.phase == "queued":
            self.note_prompt_length(len(req.prompt))
            self.queue.append(req)
            return 0
        slot = self._free_slot()
        if slot is None:
            raise MigrationError(
                f"no free decode slot for request {snapshot.rid} "
                f"(n_slots={self.n_slots}) — failing closed")
        if kv_fitted is not None:
            single = kv_fitted
        else:
            single = migration.place_like(
                migration.fit_single(snapshot.kv, self.single_layout()), self.cache)
        if self.paged:
            try:
                pages = self.pool.alloc(self.pool.pages_for(need), reserve=True)
            except kvpool.PoolOOM as e:
                raise MigrationError(str(e)) from e
            # full-width write: the scratch-padded tail goes to page 0
            row = pages + [kvpool.SCRATCH_PAGE] * (self.pages_per_seq - len(pages))
            kvpool.write_pages(self.cache, single, row, self._pax, self._sax)
            self.page_tables[slot] = row
            self.slot_pages[slot] = pages
            self._tables_dirty = True
        else:
            migration.write_single(self.cache, single, self._migration_axes(), slot)
        sync(self.device)
        self.slot_req[slot] = req
        self.slot_pos[slot] = snapshot.pos
        self.note_prompt_length(len(req.prompt))
        return snapshot.nbytes

    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit queued requests (prefill), then run one decode step over
        all active lanes through the installed `DecodeExecutable`: its
        replay on the card. With none installed the step runs eagerly and
        the executable is built after it (on the card, its graph
        captured). Returns the number of lanes that decoded.

        Raises:
            EngineStateError: if the engine is paused.
            RuntimeError: the installed executable is bound to a pool that
                is no longer the engine's, or its capture or replay failed.
        """
        if self.paused:
            raise EngineStateError("engine is paused (resume() to serve)")
        while self._retired:
            self._retired.pop().release()
        self._admit()
        if self.paged:
            self._compact()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.n_slots, 1), dtype=np.int64)
        for i in active:
            tokens[i, 0] = self.slot_req[i].tokens_out[-1]
        with self._exec_lock:
            exe = self._decode_exec
        first = exe is None
        if first:
            exe = DecodeExecutable(self)
        elif not exe.bound_to(self.cache):
            raise RuntimeError("the installed decode executable is bound to a "
                               "pool this engine no longer holds")
        # inactive lanes sit at position 0 (of the scratch page, or of a free
        # slot, which its next admission overwrites)
        exe.load(tokens, self.slot_pos,
                 self.page_tables if self.paged and (first or self._tables_dirty) else None)
        self._tables_dirty = False
        if first:
            exe.forward()
            self.decode_stats["eager"] += 1
        else:
            exe.run()
            self.decode_stats["replays" if exe.graph is not None else "eager"] += 1
        picks = exe.next_tok.cpu().numpy()
        now = time.time()
        rec = obs_events.RECORDER
        for i in active:
            req = self.slot_req[i]
            req.tokens_out.append(int(picks[i]))
            self.slot_pos[i] += 1
            if (len(req.tokens_out) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.s_max - 1):
                req.t_done = now
                self.done.append(req)
                self._release_lane(i)
                if rec is not None:
                    rec.emit("request.complete", engine=self.obs_name, rid=req.rid,
                             label=req.labels.get("data-type", ""),
                             ttft_s=req.ttft, tpot_s=req.tpot,
                             tokens_out=len(req.tokens_out), role=self.role)
        self.steps += 1
        if rec is not None and self.steps % rec.decode_stride == 0:
            rec.emit("engine.decode", engine=self.obs_name, step=self.steps,
                     active=len(active))
        if first:       # after the step's bookkeeping: a failed capture loses no token
            self._install(self._capture(exe))
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        """Step until the queue and all lanes are empty (or the engine's
        lifetime step count reaches ``max_steps``).

        Raises:
            EngineStateError: if the engine is paused.
        """
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and self.steps < max_steps:
            self.step()

    def metrics(self) -> Dict[str, float]:
        """Full `METRIC_KEYS` summary over everything completed so far."""
        return compute_metrics(self.done)


#: the op namespaces of PyTorch's collectives (eager c10d and functional)
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a traced step issued: its op (``namespace.name``) and
    the global ranks of its process group, ``None`` where they could not
    be read (a check then assumes it crosses every axis)."""

    op: str
    ranks: Optional[Tuple[int, ...]] = None


def _has_process_group() -> bool:
    """Whether this process has a default process group: without one no
    collective can be dispatched."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _group_ranks(args, kwargs) -> Optional[Tuple[int, ...]]:
    """The ranks of the process group among a collective's arguments: a
    group object (eager ``c10d`` ops) or a group name (functional ops)."""
    import torch.distributed as dist
    if not _has_process_group():
        return None
    for a in list(args) + list(kwargs.values()):
        try:
            if isinstance(a, str):
                from torch.distributed.distributed_c10d import _resolve_process_group
                a = _resolve_process_group(a)
            return tuple(dist.get_process_group_ranks(a))
        except (AttributeError, KeyError, RuntimeError, TypeError, ValueError):
            continue
    return None


def _trace_collectives(step, device: torch.device) -> List[Collective]:
    """Run ``step`` under a `TorchDispatchMode` (thread-local: a PREPARE
    thread's trace sees none of the serving thread's ops) that records
    every op of the `COLLECTIVE_NAMESPACES`, with its process group's ranks
    where they can be read; synchronise after.

    Raises:
        RuntimeError: the step failed under the trace.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    found: List[Collective] = []

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns = getattr(func, "namespace", "")
            if ns in COLLECTIVE_NAMESPACES:
                found.append(Collective(f"{ns}.{func.overloadpacket.__name__}",
                                        _group_ranks(args, kwargs or {})))
            return func(*args, **(kwargs or {}))

    try:
        with _Record():
            step()
        sync(device)
    except Exception as e:
        raise RuntimeError(f"decode step could not be traced for its "
                           f"collectives: {e!r}") from e
    return found


def _write_slot(pool: Dict[str, torch.Tensor], single: Dict[str, torch.Tensor],
                slot: int) -> None:
    """Write a one-sequence prefill cache into slot ``slot`` of the pool, IN
    PLACE. Every leaf is ``(L, batch, ...)``, so the slot is axis 1 of each,
    by the layout (the reference's ``_write_slot`` guesses the axis from
    shapes and finds none when the pool has one slot). A positional leaf's
    sequence axis (axis 2) is zero-padded up to the pool's ``s_max``; every
    leaf is cast to the pool's dtype (the bf16 conv histories of an fp32
    model round here, as in the reference)."""
    for name, dst in pool.items():
        src = single[name][:, 0]
        if name in POSITIONAL_LEAVES:
            n = src.shape[1]
            dst[:, slot, :n].copy_(src)
            dst[:, slot, n:].zero_()
        else:
            dst[:, slot].copy_(src)
