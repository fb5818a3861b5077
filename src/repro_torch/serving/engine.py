"""Continuous-batching serving engine with per-request TTFT/TPOT metrics.

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

Greedy sampling takes the first index on ties (``np.argmax``), as the
reference does. The engine runs on the card unless it is given
``device="cpu"`` (and a model on the CPU). The lifecycle here is pause /
drain / resume; plan swaps, ahead-of-time executables and live migration
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.models.lm import POSITIONAL_LEAVES
from repro_torch.serving import kvpool

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
        t_submit / t_first / t_done: wall-clock stamps set by the engine at
            submission, first token, and completion.
        tokens_out: generated token ids (first entry comes from prefill).
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
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
        model: the `repro_torch.models.Model` to serve (its params).
        n_slots: continuous-batching width (decode batch dim).
        s_max: KV sequence capacity per request.
        paged: the paged pool (True) or the slot-granular one (False);
            None picks paged exactly when the model's cache can be paged
            (`kvpool.supports_paging`).
        page_size: tokens per KV page (clamped to ``s_max``; paged only).
        kv_tokens: token capacity of the pool (admission budget); defaults
            to ``n_slots * ceil(s_max / page_size) * page_size`` (paged
            only).
        watermark: free pages admissions must leave behind, allocated on
            top of ``kv_tokens`` (paged only).
        prefill_buckets: pad each prompt to the smallest power-of-two bucket
            (`bucket_lengths`) and read its logits at ``true_len - 1``,
            instead of a prefill of the exact length. A model that cannot
            be padded (`supports_padded_prefill`) has no buckets.
        device: where the engine runs; must be the model's device.
            ``"cuda"`` unless the caller names the CPU.

    Raises:
        RuntimeError: ``device`` is CUDA and no card is available.
        ValueError: the model lives on another device, or ``paged=True``
            for a model that cannot be paged.
    """

    BUCKET_MIN = 8

    def __init__(self, model: Model, *, n_slots: int = 4, s_max: int = 128,
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
            # device copy of page_tables, uploaded again only after a change
            self._tables_dev: Optional[torch.Tensor] = None
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return sum(r is not None for r in self.slot_req)

    def resume(self) -> None:
        """Leave the paused state and serve again (idempotent)."""
        self.paused = False

    def supports_padded_prefill(self) -> bool:
        """Whether bucket-padded prefill is sound for this model: every
        mixer must be attention (causal attention never reads the padding),
        the condition under which the cache can be paged too. An SSM mixer
        folds the whole padded sequence into its state."""
        return kvpool.supports_paging(self.model)

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

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request (stamps ``t_submit``). Works while paused."""
        req.t_submit = time.time()
        self.queue.append(req)

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
            batch: Dict[str, torch.Tensor] = {"tokens": prompt}
            bucket = next((b for b in self._bucket_lengths if b >= S), None)
            if bucket is not None:
                batch = {"tokens": torch.nn.functional.pad(prompt, (0, bucket - S)),
                         "true_len": S}
            logits, cache1 = self.model.prefill(batch)
            tok = int(np.argmax(logits[0, : self.vocab].float().cpu().numpy()))
            req.tokens_out.append(tok)
            req.t_first = time.time()
            if self.paged:
                # the scratch-padded table tail absorbs bucket slack (never
                # read: decode masks by position)
                row = pages + [kvpool.SCRATCH_PAGE] * (self.pages_per_seq - len(pages))
                kvpool.write_pages(self.cache, cache1, row, self._pax, self._sax)
                self.page_tables[slot] = row
                self.slot_pages[slot] = pages
                self._tables_dev = None
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
            self._tables_dev = None

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
        self._tables_dev = None

    def step(self) -> int:
        """Admit queued requests (prefill), then run one decode step over
        all active lanes. Returns the number of lanes that decoded.

        Raises:
            EngineStateError: if the engine is paused.
        """
        if self.paused:
            raise EngineStateError("engine is paused (resume() to serve)")
        self._admit()
        if self.paged:
            self._compact()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tokens = np.zeros((self.n_slots, 1), dtype=np.int64)
        for i in active:
            tokens[i, 0] = self.slot_req[i].tokens_out[-1]
        # inactive lanes sit at position 0 (of the scratch page, or of a free
        # slot, which its next admission overwrites)
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.paged:
            if self._tables_dev is None:
                self._tables_dev = torch.as_tensor(self.page_tables, device=self.device)
            logits, self.cache = self._decode(tokens, self.cache, pos, self._tables_dev)
        else:
            logits, self.cache = self.model.decode_step(tokens, self.cache, pos)
        logits = logits[:, : self.vocab].float().cpu().numpy()
        now = time.time()
        for i in active:
            req = self.slot_req[i]
            req.tokens_out.append(int(np.argmax(logits[i])))
            self.slot_pos[i] += 1
            if (len(req.tokens_out) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.s_max - 1):
                req.t_done = now
                self.done.append(req)
                self._release_lane(i)
        self.steps += 1
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
