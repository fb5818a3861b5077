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
step eagerly over the same buffers.

Prefill runs as the reference's does. PREPARE builds a `PrefillExecutable`
for each prompt length it is given and, on request, for each padded bucket
(`bucket_lengths`): on the card a CUDA graph of ``model.prefill`` over the
executable's own token (and ``true_len``) buffers, the graphs of one
PREPARE in one memory pool. The swap installs them, and `_admit` picks as
the reference's `_admit` does: the exact length's executable, else the
smallest bucket that holds the prompt, else an eager prefill (the
reference's JIT), counted in `prefill_stats`. The request's cache is then
written into its pages or slot eagerly, outside the graph. Only attention
models pad (`supports_padded_prefill`); the slot pools of SSM and hybrid
models get exact lengths only. Live migration moves one
request's state between engines (`export_slot` / `import_slot`); each ends
in a device synchronisation, so a pause it stamps is the device's time.
Cluster knobs (``labels``, ``role``, ``plan``) only steer the cluster.

Across ranks. Under a plan that resolves to several process ranks (a
`sharding.plan_layout` of a rank mesh: ``mesh=``, or a swap onto its
``shardings``), the engine holds its own DTensor tree of params and a pool
laid out by the reference's `cache_specs` (the paged store split by pages,
the slot pool by slots, over the batch axes). Every rank of the world runs
the same engine with the same requests, so the host state (queue, lanes,
positions, page tables, the allocator) is equal on every rank and admission
decides as on one device. The compute is the sharded steps'
(`launch.steps`): each rank of the engine's mesh gathers a layer's params
over the FSDP axes, keeps its shard of the tensor axis (heads, ``d_ff``
columns, experts, SSM heads, vocab: `lm.tp_groups`) and runs its own rows
of the decode batch on it (a one-prompt prefill is not split over the rows:
every rank of a tensor-axis group runs its shard of it), the partial
outputs summed over the tensor axis; the greedy pick reads the vocab
shards (`ctx.tp_argmax`). A paged step exchanges only the pages the tables
name (`kvpool.gather_named_pages`), writing each new entry on the rank
that holds its page. Token values live on the engine's ranks only
(a rank outside them records -1 for each, and keeps every count); a swap
onto ranks that did not hold the engine sends them the resident requests'
tokens with their state. Such an engine decodes and prefills eagerly, BY
DESIGN (counted in ``decode_stats["multi_rank_eager"]``): a paged step's
exchange has sizes that follow the page tables, and its layer gathers are
DTensor collectives, so no static graph is captured across ranks. Its
PREPARE warms each length and bucket on scratch state and installs the
reference's tables without executables, so admission still picks the
exact length, a bucket or neither as the reference does. PREPARE builds
its scratch state over process groups of its own (`sharding.PREPARE_TAG`),
so a worker thread's collectives never share a group with serving's.

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

from repro_torch import tree as tree_util
from repro_torch.models import Model
from repro_torch.models.common import padded_vocab, resolve_device
from repro_torch.models.lm import is_positional
from repro_torch.obs import events as obs_events
from repro_torch.obs.trace import NO_SPAN, StepSpan
from repro_torch.serving import kvpool, migration
from repro_torch.serving.clock import SYSTEM_CLOCK
from repro_torch.serving.executable import DecodeExecutable, PrefillExecutable
from repro_torch.serving.migration import MigrationError, SlotSnapshot, sync
from repro_torch.sharding import ctx
from repro_torch.sharding.plan import (
    LeafSharding,
    P,
    ShardingPlan,
    default_plan,
    is_shardings,
    leaf_sharding,
)

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
            instead of a prefill of the exact length, eagerly. A model that
            cannot be padded (`supports_padded_prefill`) has no buckets. A
            swap installs PREPARE's bucket executables in their place.
        mesh: start laid out across ranks: the engine's layout under
            ``plan`` on this mesh of process ranks (`plan_layout`); its
            params and pool are placed there (a model whose params are
            DTensors under that layout keeps them). Every rank of the world
            builds the engine.
        device: where the engine runs; must be the model's device.
            ``"cuda"`` unless the caller names the CPU.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
        ValueError: the model lives on another device, ``paged=True`` for a
            model that cannot be paged, an unknown ``role``, or a model
            whose params are DTensors without ``mesh``.
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
                 mesh: Optional[Any] = None,
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
        # the reference's prefill tables: {length: executable} for exact
        # lengths and for buckets, and the bucket lengths in order. An entry
        # without an executable (None) runs eagerly at its shape: the
        # constructor's buckets, and every entry of an engine across ranks
        self._prefill_exec: Dict[int, Optional[PrefillExecutable]] = {}
        self._bucket_exec: Dict[int, Optional[PrefillExecutable]] = {}
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
        # guards the prefill tables and the installed decode executable
        # against a swap committed from a control thread while
        # step()/_admit() pick their path
        self._exec_lock = threading.Lock()
        self._decode_exec: Optional[DecodeExecutable] = None
        # page_tables changed since the executable's table buffer was written
        self._tables_dirty = True
        # executables replaced by a swap, freed at the next step: outside
        # the swap window, after the device is done with them
        self._retired: List[Union[DecodeExecutable, PrefillExecutable]] = []
        #: decode-path counts: steps run eagerly (every step on the CPU, the
        #: first on the card) and graph replays; captures (the first step's
        #: and PREPARE's) and their seconds; PREPARE executables a swap
        #: installed or discarded (bound to a pool the swap replaced)
        #: ``multi_rank_eager`` counts the steps of a multi-rank layout, eager
        #: by design (see the module doc); ``tp_local`` / ``tp_padded`` /
        #: ``tp_gathered`` its decode steps' sub-layers that ran on their
        #: tensor-axis shard, on their padded head slots or gathered whole
        #: (`ctx.note_tp`; none where the axis has one rank). While a
        #: recorder is installed (`repro_torch.obs`), and only then:
        #: ``decode_s`` / ``decode_spans`` sum the ``engine.decode`` spans
        #: (the first input load to the picks on the host, on the recording
        #: clock) on every path; ``kv_gathered_bytes`` adds the KV bytes a
        #: step moves to give attention its context (the dense copy
        #: `kvpool.gather_pages` writes: the executable's `gathered_bytes`)
        #: and ``kv_live_bytes`` the bytes of the positions attention needs
        #: (each decoded lane's ``slot_pos + 1`` times
        #: `kvpool.position_bytes`), both on the paged pool on one device
        #: only: a slot pool gathers nothing, and a layout across ranks
        #: counts 0 for both
        self.decode_stats = {"eager": 0, "replays": 0, "captures": 0,
                             "capture_s": 0.0, "installs": 0, "discards": 0,
                             "multi_rank_eager": 0, "tp_local": 0, "tp_padded": 0,
                             "tp_gathered": 0, "decode_s": 0.0, "decode_spans": 0,
                             "kv_gathered_bytes": 0, "kv_live_bytes": 0}
        #: prefill-path counts: admissions through an exact length's
        #: entry, a bucket's, or neither (eager at the prompt's length, the
        #: reference's JIT); graph replays among them; PREPARE's prefill
        #: captures and their seconds
        self.prefill_stats = {"exact": 0, "bucket": 0, "eager": 0, "replays": 0,
                              "captures": 0, "capture_s": 0.0}
        #: when set, `step` keeps the step's logits ``(n_slots, V_pad)`` in
        #: ``last_logits`` (on every rank of a multi-rank engine's mesh) and
        #: the ``(lane, rid)`` pairs it decoded in ``last_lanes``, for checks
        #: that hold a layout's decode to another's
        self.record_logits = False
        self.last_logits: Optional[torch.Tensor] = None
        self.last_lanes: List[Tuple[int, int]] = []
        #: and each admitted request's prefill logits ``(V_pad,)`` by rid
        self.prefill_logits: Dict[int, torch.Tensor] = {}
        #: the params an engine laid out across ranks holds (a DTensor
        #: tree); None on one device, where engines share the model's
        self.params: Optional[Dict[str, Any]] = None
        #: the `plan_layout` across ranks the state lives on; None on one
        #: device
        self.layout: Optional[Dict[str, Any]] = None
        if mesh is not None:
            from repro_torch.sharding.plan import plan_layout
            layout = plan_layout(model.cfg, self.plan, mesh, n_slots=self.cache_batch)
            self._check_layout(layout)
            self._move_state(layout)
        elif any(ctx.is_dtensor(v) for v in _leaves(model.params)):
            raise ValueError("the model's params are DTensors: give the engine the mesh "
                             "they lie on")

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
                  shardings: Optional[Dict[str, Any]] = None,
                  executables: Optional[Dict[str, Any]] = None) -> int:
        """Install a new plan: place params and cache by ``placement`` or
        ``shardings`` and install what PREPARE warmed (``executables``).
        Must be called paused — this is the blocking window.

        Args:
            plan: the new `ShardingPlan` to record (routing reads it);
                ``None`` keeps the current plan.
            placement: ``{"params": device, "cache": device}`` from
                `plan_to_placement`: the one-device layout. The cache moves
                there (a no-op on its own device; gathered whole on every
                rank from a layout across ranks); the params, which engines
                may share, are never copied or cast, so the model's must
                already live there.
            shardings: a `plan_layout` across ranks (the reference's
                ``shardings``): the params and the cache move onto it
                between meshes of any rank counts (`ctx.move`, a leaf at a
                time; the old and new layouts coexist leaf by leaf), the
                old layout is freed, and ranks that join the engine get
                the resident requests' tokens. Every rank of the world
                calls this at the same point.
            executables: ``{"decode": DecodeExecutable, "prefill":
                {length: PrefillExecutable}, "prefill_buckets": {bucket:
                PrefillExecutable}, "collectives": the decode step's}`` from
                `prepare_executables`; the decode executable is installed
                when it is bound to the pool as it stands after the
                placement, else discarded (counted in `decode_stats`) and
                the next step captures anew; a ``"prefill"`` dict replaces
                the exact-length table and a ``"prefill_buckets"`` dict the
                bucket table (empty: no buckets), as the reference's swap
                does; the collectives become `decode_collectives`. A swap
                that places the state drops both tables first (they were
                built for the old layout). Nothing is captured or compiled
                here: on one device the window stays a pointer swap.

        Returns:
            The bytes the layout covers — params + cache (DTensors by their
            global size) whenever a placement or shardings are given (the
            reference's count), else 0.

        Raises:
            EngineStateError: the engine is not paused.
            ValueError: the placement puts the params on another device.
        """
        if not self.paused:
            raise EngineStateError("swap_plan requires a paused engine "
                                   "(call pause(); drain() first)")
        migrated = 0
        if placement is not None or shardings is not None:
            params = self.params if self.params is not None else self.model.params
            migrated = migration.state_bytes(params) + migration.state_bytes(self.cache)
            if shardings is not None:
                self._move_state(shardings)
            else:
                dev = placement.get("params", self.device)
                if torch.device(dev) != self.model.device:
                    raise ValueError(f"placement puts the params on {dev}, but they "
                                     f"live on {self.model.device} and may be shared")
                if self.layout is not None:
                    self._move_state(None)
                if "cache" in placement:
                    self.cache = {k: v.to(placement["cache"]) for k, v in self.cache.items()}
            sync(self.device)
            self._migration_warm = False
            self._collectives = None
            self._install_prefill({}, {})
        # an executable over a pool that is no longer the engine's is
        # stale: the next step captures anew
        if self._decode_exec is not None and (
                self.layout is not None or not self._decode_exec.bound_to(self.cache)):
            self._install(None)
        if executables:
            exact, buckets = executables.get("prefill"), executables.get("prefill_buckets")
            self._install_prefill(exact if isinstance(exact, dict) else None,
                                  buckets if isinstance(buckets, dict) else None)
            decode = executables.get("decode")
            if decode is not None and self.layout is None and decode.bound_to(self.cache):
                self._install(decode)
                self.decode_stats["installs"] += 1
            elif decode is not None:
                self._retired.append(decode)
                self.decode_stats["discards"] += 1
            if "collectives" in executables:
                self._collectives = self._agree(list(executables["collectives"]))
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

    def _install_prefill(self, exact: Optional[Dict[int, Optional[PrefillExecutable]]],
                         buckets: Optional[Dict[int, Optional[PrefillExecutable]]]) -> None:
        """Replace the exact-length table with ``exact`` and the bucket
        table (and the bucket ladder) with ``buckets``; None keeps a table.
        The executables no table holds any longer are freed at the next
        step."""
        with self._exec_lock:
            old = list(self._prefill_exec.values()) + list(self._bucket_exec.values())
            if exact is not None:
                self._prefill_exec = dict(exact)
            if buckets is not None:
                self._bucket_exec = dict(buckets)
                self._bucket_lengths = sorted(buckets)
            kept = {id(e) for e in list(self._prefill_exec.values())
                    + list(self._bucket_exec.values())}
        self._retired.extend(e for e in old if e is not None and id(e) not in kept)

    @property
    def prefill_executables(self) -> Tuple[Dict[int, Optional[PrefillExecutable]],
                                           Dict[int, Optional[PrefillExecutable]]]:
        """The installed prefill tables: ``({length: executable}, {bucket:
        executable})``, None where an entry runs eagerly."""
        with self._exec_lock:
            return dict(self._prefill_exec), dict(self._bucket_exec)

    def _install(self, exe: Optional[DecodeExecutable]) -> None:
        """Make ``exe`` the executable `step` runs; the one it replaces is
        freed at the next step. Its table buffer is written at that step."""
        with self._exec_lock:
            old, self._decode_exec = self._decode_exec, exe
        if old is not None and old is not exe:
            self._retired.append(old)
        self._tables_dirty = True

    # ------------------------------------------------------------------
    # layouts across ranks
    # ------------------------------------------------------------------
    @property
    def ranks(self) -> Tuple[int, ...]:
        """The process ranks that hold the engine's state: its layout's
        mesh, or every rank of the world on one device."""
        return _ranks_of(self.layout)

    def _is_member(self) -> bool:
        import torch.distributed as dist
        return self.layout is None or dist.get_rank() in self.ranks

    def _row_axes(self, layout: Optional[Dict[str, Any]] = None) -> Tuple[str, ...]:
        """The mesh axes the decode batch's rows split over: the plan's
        batch axes the layout's mesh carries."""
        layout = self.layout if layout is None else layout
        names = layout["mesh"].axis_names
        return tuple(a for a in layout["plan"].batch_axes if a in names)

    def _check_layout(self, layout: Dict[str, Any]) -> None:
        """Refuse a layout across ranks the reference's jit would refuse:
        the decode batch (``n_slots`` lanes) and the pool must split evenly
        over their axes. A paged pool keeps its sequence whole.

        Raises:
            ValueError: a dim does not divide over its axes' extent, or the
                plan shards a paged pool's sequence.
        """
        from repro_torch.launch.steps import check_even
        b_ax = self._row_axes(layout) if self.n_slots > 1 else None
        check_even(torch.empty((self.n_slots, 1), device="meta"),
                   leaf_sharding(layout["mesh"], P(b_ax, None)), "decode tokens")
        check_even({k: torch.empty(v.shape, device="meta") for k, v in self.cache.items()},
                   layout["cache"], "cache")
        if self.paged and layout["plan"].seq_axis:
            raise ValueError("a paged pool keeps its sequence whole across ranks "
                             f"(the plan shards it over {layout['plan'].seq_axis})")

    def _move_state(self, layout: Optional[Dict[str, Any]]) -> None:
        """Move the params and the pool onto ``layout`` (None: one device,
        the model's params and a plain pool on every rank), a leaf at a
        time, and send the resident requests' tokens to ranks that join."""
        holders = self.ranks
        if layout is None:
            dst = ctx.world_ranks()
            self.cache = {k: ctx.move(self.cache[k], dst, holders=holders)
                          for k in sorted(self.cache)}
            self.params = None
        else:
            # the old and the new layouts coexist until the move ends; then
            # the old one is freed (the model's params stay, engines share
            # them on one device)
            src = self.params if self.params is not None else self.model.params
            self.params = tree_util.map_tree(
                lambda _, x, sh: ctx.move(x, sh, holders=holders), src, layout["params"])
            del src
            self.cache = {k: ctx.move(self.cache[k], layout["cache"][k], holders=holders)
                          for k in sorted(self.cache)}
        if _has_process_group():
            lanes = [(i, r.tokens_out) for i, r in enumerate(self.slot_req) if r is not None]
            got = ctx.relay_object(lanes, holders, _ranks_of(layout))
            for i, toks in got:
                self.slot_req[i].tokens_out = list(toks)
        self.layout = layout

    def _agree(self, collectives: List["Collective"]) -> List["Collective"]:
        """A multi-rank engine's traced collectives, the same on every rank
        of the world: the first rank of its mesh traced them (a rank
        outside the mesh issues none), and sends them to all, so every
        rank reaches the same verdict. The list is metadata, not state."""
        if self.layout is None or not _has_process_group():
            return collectives
        import torch.distributed as dist
        box = [collectives]
        dist.broadcast_object_list(box, src=self.ranks[0])
        return list(box[0])

    def _tp(self, layout: Dict[str, Any], dm, **kw):
        """The tensor-parallel serving context of ``layout`` over ``dm``'s
        process groups (PREPARE's own, or serving's)."""
        return ctx.activation_sharding(layout["mesh"], layout["plan"], tensor_parallel=True,
                                       device_mesh=dm, **kw)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """Each row's greedy pick over the real vocab, from this rank's
        logits: all the columns, or its vocab shard (`ctx.tp_argmax`, the
        first maximum of the whole row either way)."""
        n_local = logits.shape[1]
        if n_local == padded_vocab(self.model.cfg.vocab_size):
            return torch.argmax(logits[:, : self.vocab], dim=-1)
        lo = ctx.tp()[1] * n_local
        keep = max(0, min(self.vocab - lo, n_local))
        if keep < n_local:
            logits = logits.clone()
            logits[:, keep:] = -float("inf")
        return ctx.tp_argmax(logits, lo)

    def _whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's logits with every vocab column (gathered over the
        tensor axis where it holds a shard)."""
        if logits.shape[1] == padded_vocab(self.model.cfg.vocab_size):
            return logits
        return ctx.tp_gather(logits, 1)

    def _sharded_prefill(self, params: Dict[str, Any], layout: Dict[str, Any],
                         batch: Dict[str, Any]):
        """One prompt's prefill on a layout across ranks (a rank of its mesh
        only): the batch is not split over the rows; every rank runs it over
        the layers gathered over the FSDP axes, on its tensor-axis shards
        (`launch.steps`' serving params). Returns ``(pick, logits, cache)``:
        the greedy pick, the whole logits row where the engine records
        logits (else None), and the prompt's cache (its SSM leaves this
        rank's shard where their heads ran local)."""
        from repro_torch.launch.steps import _serving_params
        dm = next(iter(tree_util.leaves(params))).device_mesh
        with torch.no_grad(), self._tp(layout, dm):
            logits, cache = self.model.prefill(batch,
                                               params=_serving_params(self.model.cfg, params))
            pick = self._pick(logits)
            whole = self._whole_logits(logits) if self.record_logits else None
        return pick, whole, cache

    def _sharded_decode(self, params: Dict[str, Any], cache: Dict[str, Any],
                        layout: Dict[str, Any], dm, tokens: np.ndarray, pos: np.ndarray,
                        tables: Optional[np.ndarray]) -> np.ndarray:
        """One decode step of every lane on a layout across ranks (a rank
        of its mesh only), over ``cache`` in place: each rank runs its rows
        of the batch (``dm``'s chunk over the row axes) over the layers
        gathered whole; a paged pool's named pages are gathered first and
        each new entry written on the rank that holds its page; a slot pool
        runs its own slots (its SSM leaves' tensor-axis shard in place where
        their heads run local). Returns every lane's greedy pick."""
        from repro_torch.launch.steps import _serving_params, _tp_keys
        n = self.n_slots
        row_axes = self._row_axes(layout)
        lo, hi = ctx.my_rows(dm, row_axes, n)
        dev = self.device
        tok = torch.as_tensor(tokens[lo:hi], device=dev)
        p = torch.as_tensor(pos[lo:hi], device=dev)
        with torch.no_grad(), self._tp(layout, dm, row_axes=row_axes, rows=n):
            served = _serving_params(self.model.cfg, params)
            axis, kept = _tp_keys(self.model.cfg)
            if tables is not None:
                pages = sorted(set(int(x) for x in tables.reshape(-1)))
                named = kvpool.gather_named_pages(cache, pages)
                dense = kvpool.dense_rows(named, {q: i for i, q in enumerate(pages)},
                                          tables[lo:hi], self._pax, self._sax)
                del named
                logits, dense = self.model.decode_step(tok, dense, p, params=served)
                rows = torch.arange(hi - lo, device=dev)
                new = {k: ctx.rows_whole(v[:, rows, p], dm, row_axes, n, dim=1)
                       for k, v in dense.items()}
                kvpool.scatter_token_sharded(cache, new, tables, pos)
            else:
                keep = {k: (axis,) if k in kept else () for k in cache}
                local = {k: ctx.local_rows(v, 1, keep=keep[k]) for k, v in cache.items()}
                logits, local = self.model.decode_step(tok, local, p, params=served)
                for k, v in cache.items():
                    if v.to_local().data_ptr() != local[k].data_ptr():
                        v.to_local().copy_(ctx.from_rows(local[k], _sharding_of(v),
                                                         tuple(v.shape), dim=1,
                                                         keep=keep[k]).to_local())
            picks = self._pick(logits)
            if self.record_logits and cache is self.cache:
                self.last_logits = ctx.rows_whole(self._whole_logits(logits), dm, row_axes, n)
            return ctx.rows_whole(picks, dm, row_axes, n).cpu().numpy()

    def _scratch_state(self, sh: Dict[str, Any]):
        """Scratch params and pool under the shardings ``sh`` (``{"params",
        "cache"}``; PREPARE's are the target layout over its own process
        groups): zeros, the layer stacks one layer deep in memory (a
        stride-0 view over the layers: each layer gathered is that one), a
        pool at the target's shape."""
        from repro_torch.launch.steps import STACKED
        src = self.params if self.params is not None else self.model.params

        def one(path, x, leaf_sh):
            shape = tuple(x.shape)
            local, _ = ctx.local_shape_and_offset(shape, leaf_sh)
            if path.split("/")[0] in STACKED and len(local) > 1:
                z = torch.zeros(local[1:], dtype=x.dtype, device=self.device).expand(local)
            else:
                z = torch.zeros(local, dtype=x.dtype, device=self.device)
            return ctx.to_dtensor(z, leaf_sh, shape)

        params = tree_util.map_tree(one, src, sh["params"])
        cache = {k: ctx.to_dtensor(torch.zeros(
            ctx.local_shape_and_offset(tuple(v.shape), sh["cache"][k])[0], dtype=v.dtype,
            device=self.device), sh["cache"][k], tuple(v.shape)) for k, v in self.cache.items()}
        return params, cache

    # ------------------------------------------------------------------
    # PREPARE (runs while serving continues)
    # ------------------------------------------------------------------
    def supports_padded_prefill(self) -> bool:
        """Whether bucket-padded prefill is sound for this model: every
        mixer must be attention, GQA or MLA (causal attention never reads
        the padding), the condition under which the cache can be paged too.
        An SSM mixer folds the whole padded sequence into its state."""
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

    def prepare_executables(self, placement: Dict[str, Any],
                            prefill_lengths: Sequence[int] = (), *,
                            prefill_buckets: bool = False,
                            ) -> Tuple[Dict[str, Any], int]:
        """The PREPARE phase (the reference's ``aot_executables``): one
        decode step at the live batch shape on scratch state, then the
        decode executable (`DecodeExecutable`) built over the live pool, on
        the card captured as a CUDA graph without running it; then a
        `PrefillExecutable` for each prompt length (and each bucket), on
        the card run once on its own buffers and captured, every graph of
        this call in one fresh memory pool; and a synchronisation. Runs
        beside serving: the live pool is never written, and no graph holds
        its addresses but the decode graph's.

        A layout across ranks (``placement`` a `plan_layout` of a rank
        mesh) is prepared on scratch state of its own (`_scratch_state`):
        zero params and pool at the target layout over PREPARE's process
        groups, one decode step on it, traced for its collectives (on the
        ranks of the target mesh; the swap shares them with every rank),
        then prefill warmed at each length and bucket. No graph: such an
        engine decodes and prefills eagerly by design (module doc); its
        tables name the same lengths and buckets without executables.
        Every rank of the world calls this for the same layouts in the
        same order, on one thread (the cluster's PREPARE worker).

        Args:
            placement: the target ``{"params": ..., "cache": ...}``: a
                `plan_to_placement` or a `plan_layout` across ranks.
            prefill_lengths: prompt lengths to warm; when empty, the
                engine's most recently seen lengths (`recent_prompt_lengths`).
            prefill_buckets: also warm the padded-bucket ladder
                (`bucket_lengths`), which the swap then installs.

        Returns:
            ``(executables, n_compiled)`` in the shape `swap_plan` takes:
            ``"prefill"`` and ``"prefill_buckets"`` map each length to its
            executable, as the reference's do; ``n_compiled`` counts as the
            reference does: 1 (decode) + the lengths + the buckets.

        Raises:
            ValueError: the placement is not this engine's device; a layout
                across ranks the reference would refuse (`_check_layout`).
            RuntimeError: the decode step or a prefill could not be
                captured.
        """
        lengths = (sorted(set(prefill_lengths)) if prefill_lengths
                   else list(self.recent_prompt_lengths()))
        buckets = self.bucket_lengths() if prefill_buckets else []
        if is_shardings(placement):
            return (self._prepare_sharded(placement, lengths, buckets),
                    1 + len(lengths) + len(buckets))
        dev = torch.device(placement.get("cache", self.device))
        if dev != self.device:
            raise ValueError(f"placement on {dev}; this engine runs on {self.device}")
        # the decode warm-up, traced where a process group exists: the swap
        # installs its collectives, so the post-swap check never traces on
        # the serving thread. With no group none can be dispatched.
        step = self._scratch_decode_inputs()
        if _has_process_group():
            collectives = trace_collectives(step, self.device)
        else:
            step()
            collectives = []
        # from a layout across ranks the swap makes a new pool, which no
        # graph captured now could be bound to: the first step captures
        decode = self._capture(DecodeExecutable(self)) if self.layout is None else None
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        prefill = {S: self._capture_prefill(S, False, pool) for S in lengths}
        bucket = {S: self._capture_prefill(S, True, pool) for S in buckets}
        sync(self.device)
        return ({"decode": decode, "prefill": prefill, "prefill_buckets": bucket,
                 "collectives": tuple(collectives)},
                1 + len(lengths) + len(buckets))

    def _capture_prefill(self, length: int, padded: bool, pool) -> PrefillExecutable:
        """One `PrefillExecutable`, captured in ``pool`` on the card and
        counted in `prefill_stats` (timed on `SYSTEM_CLOCK`, as `_capture`
        is)."""
        exe = PrefillExecutable(self.model, length, padded=padded, device=self.device)
        t0 = SYSTEM_CLOCK.perf_counter()
        if exe.capture(pool):
            dt = SYSTEM_CLOCK.perf_counter() - t0
            with self._exec_lock:
                self.prefill_stats["captures"] += 1
                self.prefill_stats["capture_s"] += dt
        return exe

    def _prepare_sharded(self, layout: Dict[str, Any], lengths: Sequence[int],
                         buckets: Sequence[int]) -> Dict[str, Any]:
        """`prepare_executables` for a layout across ranks."""
        import torch.distributed as dist
        self._check_layout(layout)
        collectives: List[Collective] = []
        if dist.get_rank() in _ranks_of(layout):
            params, cache = self._scratch_state(layout["prepare"])
            dm = next(iter(layout["prepare"]["cache"].values())).mesh
            zeros = np.zeros(self.n_slots, dtype=np.int64)
            tables = (np.full((self.n_slots, self.pages_per_seq), kvpool.SCRATCH_PAGE,
                              dtype=np.int64) if self.paged else None)
            collectives = trace_collectives(
                lambda: self._sharded_decode(params, cache, layout, dm, zeros[:, None], zeros,
                                             tables), self.device)
            for S in lengths:
                self._sharded_prefill(params, layout, {"tokens": torch.zeros(
                    (1, S), dtype=torch.long, device=self.device)})
            for S in buckets:
                self._sharded_prefill(params, layout, {"tokens": torch.zeros(
                    (1, S), dtype=torch.long, device=self.device), "true_len": 1})
            del params, cache
            sync(self.device)
        return {"decode": None, "prefill": dict.fromkeys(lengths),
                "prefill_buckets": dict.fromkeys(buckets), "collectives": tuple(collectives)}

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
        state (`trace_collectives`). With no process group no collective
        can be dispatched, so nothing is traced and the list is empty.
        Recorded once per placement.

        Raises:
            RuntimeError: the step could not be traced; the cluster fails
                closed on it.
        """
        if self._collectives is None and self.layout is not None:
            found: List[Collective] = []
            if self._is_member():
                dm = next(iter(self.cache.values())).device_mesh
                params, cache = self._scratch_state(self.layout)
                zeros = np.zeros(self.n_slots, dtype=np.int64)
                tables = (np.full((self.n_slots, self.pages_per_seq), kvpool.SCRATCH_PAGE,
                                  dtype=np.int64) if self.paged else None)
                found = trace_collectives(lambda: self._sharded_decode(
                    params, cache, self.layout, dm, zeros[:, None], zeros, tables), self.device)
            self._collectives = self._agree(found)
        elif self._collectives is None:
            self._collectives = (trace_collectives(self._scratch_decode_inputs(),
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

    def _export_sharded(self, slot: int, *, scratch: bool = False) -> Dict[str, torch.Tensor]:
        """Lane ``slot``'s state gathered whole on the ranks of the engine's
        mesh, as the one-device engine exports it: its pages in table order
        (the scratch page's when ``scratch``), or its slot; meta tensors of
        the same shapes on the other ranks."""
        if self.paged:
            row = ([kvpool.SCRATCH_PAGE] * self.pages_per_seq if scratch
                   else [int(x) for x in self.page_tables[slot]])
            got = kvpool.gather_named_pages(self.cache, row) if self._is_member() else None
            out = {}
            for name, leaf in self.cache.items():
                p, sx = self._pax[name], self._sax[name]
                shape = (leaf.shape[:p] + (1, len(row) * leaf.shape[sx])
                         + tuple(leaf.shape[sx + 1:]))
                out[name] = (got[name].reshape(shape) if got is not None
                             else torch.empty(shape, dtype=leaf.dtype, device="meta"))
            return out
        out = {}
        for name, leaf in self.cache.items():
            g = ctx.gather_index(leaf, [slot], 1) if self._is_member() else None
            out[name] = g if g is not None else torch.empty(
                (leaf.shape[0], 1) + tuple(leaf.shape[2:]), dtype=leaf.dtype, device="meta")
        return out

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
            # the reference's pick: the exact length's executable, else the
            # smallest bucket that holds the prompt, else eager (its JIT);
            # under the lock, so a swap is never seen half-installed
            with self._exec_lock:
                way, exe, bucket = "eager", None, None
                if S in self._prefill_exec:
                    way, exe = "exact", self._prefill_exec[S]
                else:
                    bucket = next((b for b in self._bucket_lengths if b >= S), None)
                    if bucket is not None:
                        way, exe = "bucket", self._bucket_exec.get(bucket)
            self.prefill_stats[way] += 1
            with NO_SPAN if rec is None else StepSpan("engine.admit"):
                t_pre0 = obs_events.now() if rec is not None else 0.0
                with NO_SPAN if rec is None else StepSpan("engine.prefill"):
                    if self.layout is None and exe is not None:
                        exe.load(req.prompt)
                        exe.run()
                        if exe.graph is not None:
                            self.prefill_stats["replays"] += 1
                        logits, cache1 = exe.logits, exe.cache1
                        tok = int(exe.next_tok[0])
                    else:
                        batch = self._prefill_batch(req.prompt, bucket)
                        if self.layout is None:
                            logits, cache1 = self.model.prefill(batch)
                            tok = int(torch.argmax(logits[0, : self.vocab]))
                        elif self._is_member():
                            pick, logits, cache1 = self._sharded_prefill(
                                self.params, self.layout, batch)
                            tok = int(pick[0])
                        else:       # outside the engine's ranks: counts, no values
                            logits, cache1, tok = None, None, -1
                if self.record_logits and logits is not None:
                    self.prefill_logits[req.rid] = logits[0].clone()
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
                    with NO_SPAN if rec is None else StepSpan("pool.write"):
                        if self.layout is None:
                            kvpool.write_pages(self.cache, cache1, row, self._pax, self._sax)
                        elif cache1 is not None:
                            kvpool.write_pages_sharded(self.cache, cache1, row, self._pax,
                                                       self._sax)
                    self.page_tables[slot] = row
                    self.slot_pages[slot] = pages
                    self._tables_dirty = True
                elif self.layout is None:
                    _write_slot(self.cache, cache1, slot)
                elif cache1 is not None:
                    _write_slot_sharded(self.cache, cache1, slot)
                self.slot_req[slot] = req
                self.slot_pos[slot] = S

    def _prefill_batch(self, prompt: np.ndarray, bucket: Optional[int]) -> Dict[str, Any]:
        """An eager prefill's batch: the prompt on the device, right-padded
        to ``bucket`` with its length as ``true_len`` when one is given. No
        positions: the model's default is the token positions (on all
        three streams for M-RoPE), the text-only positions the reference's
        engine passes."""
        tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=self.device)[None, :]
        if bucket is None:
            return {"tokens": tokens}
        return {"tokens": torch.nn.functional.pad(tokens, (0, bucket - len(prompt))),
                "true_len": len(prompt)}

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
        rec = obs_events.RECORDER
        with NO_SPAN if rec is None else StepSpan("pool.compact"):
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
        if self.layout is not None:
            # the scratch page's (or slot 0's) surgery over the engine's
            # mesh, written back where it was read
            if self._is_member():
                kv = self._export_sharded(0, scratch=True)
                if self.paged:
                    kvpool.write_pages_sharded(self.cache, kv,
                                               [kvpool.SCRATCH_PAGE] * self.pages_per_seq,
                                               self._pax, self._sax)
        elif self.paged:
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
                ranks = None
                if self.layout is not None:
                    # gathered whole on the engine's ranks: the lane's pages
                    # (the one-device layout of `gather_pages`) or its slot
                    kv = self._export_sharded(slot)
                    ranks = self.ranks
                elif self.paged:
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
                                    pos=pos, kv=kv, src_s_max=self.s_max, ranks=ranks)
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
            kv = snapshot.kv
            if snapshot.ranks is not None or self.layout is not None:
                # the state reaches every rank that holds this engine
                holders = snapshot.ranks if snapshot.ranks is not None else ctx.world_ranks()
                kv = {k: ctx.relay(None if v.is_meta else v, holders, self.ranks,
                                   shape=v.shape, dtype=v.dtype, device=self.device)
                      for k, v in sorted(kv.items())}
            single = (migration.place_like(migration.fit_single(kv, self.single_layout()),
                                           self.cache) if self._is_member() else None)
        if self.paged:
            try:
                pages = self.pool.alloc(self.pool.pages_for(need), reserve=True)
            except kvpool.PoolOOM as e:
                raise MigrationError(str(e)) from e
            # full-width write: the scratch-padded tail goes to page 0
            row = pages + [kvpool.SCRATCH_PAGE] * (self.pages_per_seq - len(pages))
            if self.layout is None:
                kvpool.write_pages(self.cache, single, row, self._pax, self._sax)
            elif single is not None:
                kvpool.write_pages_sharded(self.cache, single, row, self._pax, self._sax)
            self.page_tables[slot] = row
            self.slot_pages[slot] = pages
            self._tables_dirty = True
        elif self.layout is None:
            migration.write_single(self.cache, single, self._migration_axes(), slot)
        elif single is not None:
            _write_slot_sharded(self.cache, single, slot)
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

        With a recorder installed the step's phases are `StepSpan`s
        (``engine.step`` around the whole; ``engine.admit``,
        ``engine.prefill``, ``pool.write``, ``pool.compact``,
        ``engine.decode`` around ``engine.decode.launch``,
        ``engine.bookkeeping``) and the decode step's counters in
        `decode_stats` accrue; with none, each site costs one ``is None``
        test.

        Raises:
            EngineStateError: if the engine is paused.
            RuntimeError: the installed executable is bound to a pool that
                is no longer the engine's, or its capture or replay failed.
        """
        if self.paused:
            raise EngineStateError("engine is paused (resume() to serve)")
        rec = obs_events.RECORDER
        with NO_SPAN if rec is None else StepSpan("engine.step"):
            while self._retired:
                self._retired.pop().release()
            if self.record_logits:
                self.last_lanes = []
            self._admit()
            if self.paged:
                self._compact()
            active = [i for i, r in enumerate(self.slot_req) if r is not None]
            if not active:
                return 0
            tokens = np.zeros((self.n_slots, 1), dtype=np.int64)
            for i in active:
                tokens[i, 0] = self.slot_req[i].tokens_out[-1]
            if self.record_logits:
                self.last_lanes = [(i, self.slot_req[i].rid) for i in active]
            exe, first = None, False
            if self.layout is None:
                with self._exec_lock:
                    exe = self._decode_exec
                first = exe is None
                if first:
                    exe = DecodeExecutable(self)
                elif not exe.bound_to(self.cache):
                    raise RuntimeError("the installed decode executable is bound to a "
                                       "pool this engine no longer holds")
            with NO_SPAN if rec is None else StepSpan("engine.decode", self.decode_stats,
                                                      "decode"):
                if exe is None:
                    picks = self._decode_across_ranks(tokens)
                else:
                    picks = self._decode_step(exe, tokens, first, rec)
            if rec is not None and self.paged and exe is not None:
                self.decode_stats["kv_gathered_bytes"] += exe.gathered_bytes
                self.decode_stats["kv_live_bytes"] += kvpool.position_bytes(
                    self.cache, self._pax, self._sax) * sum(int(self.slot_pos[i]) + 1
                                                            for i in active)
            with NO_SPAN if rec is None else StepSpan("engine.bookkeeping"):
                now = time.time()
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

    def _decode_step(self, exe: DecodeExecutable, tokens: np.ndarray, first: bool,
                     rec) -> np.ndarray:
        """One decode step through ``exe`` (eager when ``first``, else its
        replay on the card); returns each lane's pick on the host."""
        # inactive lanes sit at position 0 (of the scratch page, or of a
        # free slot, which its next admission overwrites)
        exe.load(tokens, self.slot_pos,
                 self.page_tables if self.paged and (first or self._tables_dirty) else None)
        self._tables_dirty = False
        with NO_SPAN if rec is None else StepSpan("engine.decode.launch"):
            if first:
                exe.forward()
                self.decode_stats["eager"] += 1
            else:
                exe.run()
                self.decode_stats["replays" if exe.graph is not None else "eager"] += 1
        picks = exe.next_tok.cpu().numpy()
        if self.record_logits:
            self.last_logits = exe.logits.clone()
        return picks

    def _decode_across_ranks(self, tokens: np.ndarray) -> np.ndarray:
        """One decode step of a layout across ranks: eager by design (module
        doc); a rank outside the engine's mesh keeps the counts and records
        no values."""
        before = ctx.tp_counts()
        picks = (self._sharded_decode(self.params, self.cache, self.layout,
                                      next(iter(self.cache.values())).device_mesh,
                                      tokens, self.slot_pos.copy(),
                                      self.page_tables if self.paged else None)
                 if self._is_member() else np.full(self.n_slots, -1, dtype=np.int64))
        after = ctx.tp_counts()
        for k in ("tp_local", "tp_padded", "tp_gathered"):
            self.decode_stats[k] += after.get(k, 0) - before.get(k, 0)
        self.decode_stats["eager"] += 1
        self.decode_stats["multi_rank_eager"] += 1
        return picks

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
#: ops of those namespaces that move no data between ranks: waiting on a
#: functional collective's result, and wrapping it for autograd
NON_COMMUNICATING = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a traced step issued: its op (``namespace.name``) and
    the global ranks of its process group, ``None`` where they could not
    be read (a check then assumes it crosses every axis); ``shape``, the
    shape of the tensor it sends (its first tensor operand; not compared)."""

    op: str
    ranks: Optional[Tuple[int, ...]] = None
    shape: Optional[Tuple[int, ...]] = dataclasses.field(default=None, compare=False)


def _has_process_group() -> bool:
    """Whether this process has a default process group: without one no
    collective can be dispatched."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _group_ranks(args, kwargs) -> Optional[Tuple[int, ...]]:
    """The ranks of the process group among a collective's arguments: a
    group object (eager ``c10d`` ops carry it boxed as a script object) or
    a group name (functional ops); None where none can be read."""
    import torch.distributed as dist
    if not _has_process_group():
        return None
    for a in list(args) + list(kwargs.values()):
        try:
            if isinstance(a, str):
                from torch.distributed.distributed_c10d import _resolve_process_group
                a = _resolve_process_group(a)
            elif isinstance(a, torch.ScriptObject):
                a = dist.ProcessGroup.unbox(a)
            if isinstance(a, dist.ProcessGroup):
                return tuple(dist.get_process_group_ranks(a))
        except (AttributeError, KeyError, RuntimeError, TypeError, ValueError):
            continue
    return None


def trace_collectives(step, device: torch.device) -> List[Collective]:
    """Run ``step`` under a `TorchDispatchMode` (thread-local: a PREPARE
    thread's trace sees none of the serving thread's ops) that records
    every op of the `COLLECTIVE_NAMESPACES` but the `NON_COMMUNICATING`
    ones, with its process group's ranks where they can be read;
    synchronise after.

    Raises:
        RuntimeError: the step failed under the trace.
    """
    from torch.utils._python_dispatch import TorchDispatchMode

    found: List[Collective] = []

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ns = getattr(func, "namespace", "")
            if ns in COLLECTIVE_NAMESPACES \
                    and func.overloadpacket.__name__ not in NON_COMMUNICATING:
                sent = next((a for a in args if isinstance(a, torch.Tensor)), None)
                found.append(Collective(f"{ns}.{func.overloadpacket.__name__}",
                                        _group_ranks(args, kwargs or {}),
                                        None if sent is None else tuple(sent.shape)))
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
    model round here, as in the reference). A hybrid model's leaves are
    matched by their ``pos{off}/`` keys and their leaf names."""
    for name, dst in pool.items():
        src = single[name][:, 0]
        if is_positional(name):
            n = src.shape[1]
            dst[:, slot, :n].copy_(src)
            dst[:, slot, n:].zero_()
        else:
            dst[:, slot].copy_(src)


def _write_slot_sharded(pool: Dict[str, Any], single: Dict[str, torch.Tensor],
                        slot: int) -> None:
    """`_write_slot` into a pool laid out across ranks: the rank that holds
    slot ``slot`` writes its part of the other dims (a positional leaf
    zero-padded to ``s_max``, every leaf cast to the pool's dtype); nothing
    moves between ranks."""
    for name, dst in pool.items():
        src = single[name]
        if is_positional(name):
            n = src.shape[2]
            row = torch.zeros((src.shape[0], 1) + tuple(dst.shape[2:]), dtype=src.dtype,
                              device=src.device)
            row[:, :, :n] = src
            src = row
        ctx.write_rows(dst, [slot], src, 1)


def _ranks_of(layout: Optional[Dict[str, Any]]) -> Tuple[int, ...]:
    """The ranks that hold an engine's state under ``layout``: its mesh's,
    or on one device every rank of the world (each runs the one-device
    engine alike)."""
    if layout is None:
        return ctx.world_ranks() if _has_process_group() else (0,)
    return tuple(int(r) for r in layout["mesh"].ranks.reshape(-1))


def _sharding_of(x: Any) -> LeafSharding:
    """DTensor ``x``'s own layout as a `LeafSharding`."""
    return LeafSharding(x.device_mesh, tuple(x.placements), P())


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
