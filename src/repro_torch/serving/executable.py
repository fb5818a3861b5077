"""The compiled serving steps: the port's counterparts of the reference's
ahead-of-time executables (`jax.jit(...).lower(...).compile()`, a
``jax.stages.Compiled``; `repro.serving.engine.ServingEngine.aot_executables`):
one decode step, and one prefill per prompt length and per padded bucket.

XLA's executable is a fixed program over fixed buffers; on the card a CUDA
graph is the same. A `DecodeExecutable` is bound to one engine's live pool
and owns the buffers the step reads and writes:

    tokens    (n_slots, 1) int64   each lane's last token      (input)
    pos       (n_slots,)   int64   each lane's position        (input)
    tables    (n_slots, pages_per_seq) int64, paged pools only (input)
    next_tok  (n_slots,)   int64   the greedy pick             (output)
    logits    (n_slots, V_pad)     the step's logits           (output)

One step is the engine's whole decode: the paged gather, the model's
``decode_step``, the scatter of the new KV entry (or the slot pool's
in-place update), and ``argmax(logits[:, :vocab])`` on the device, which,
like ``np.argmax``, takes the first maximum; the host then reads
``n_slots`` int64s instead of the logits.

A `PrefillExecutable` is one prompt's ``model.prefill`` at one length,
exact or a padded bucket, over buffers of its own:

    tokens    (1, S)   int64   the prompt, right-padded in a bucket (input)
    true_len  ()       int64   the prompt's length, buckets only    (input)
    next_tok  (1,)     int64   the greedy pick at the last position (output)
    logits    (1, V_pad)       the last position's logits           (output)
    cache1    the single-sequence cache, ``S`` positions long       (output)

It never touches the live pool: the engine writes ``cache1`` into the
request's pages (or slot) eagerly after the run, as the reference keeps its
``write_pages`` apart from its prefill executable. Its graph holds the
params' addresses and its own buffers only. The graphs of one PREPARE
share one memory pool: the serving thread replays one at a time and reads
each replay's outputs before the next, so one replay's scratch may reuse
another's.

The device picks the path. On the card `capture` records the step as a
`torch.cuda.CUDAGraph` over these buffers, and `run` replays it; a failed
capture or replay raises, and nothing falls back to the eager step. On the
CPU `capture` records nothing and `run` calls the same step eagerly on the
same buffers. A kernel launch inside a capture is counted with the graph
(`kernels.ops.captured_launches`), and each replay adds those launches to
`kernels.ops.LAUNCHES`, as the eager step's wrappers would.

A decode graph holds the pool tensors' addresses, so it is valid only while
the engine's pool is the one it was captured over (`bound_to`): the pool is
written in place by every step, admission and migration, and replaced only
by a swap that moves it.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serving import kvpool
from repro_torch.serving.kvpool import SCRATCH_PAGE

# one capture at a time in the process: a capture reaches into the caching
# allocator and the cuBLAS handles of its thread, and PREPARE may capture on
# a worker thread while the serving thread captures an engine's first step
_CAPTURE_LOCK = threading.Lock()
# two side streams per device, shared by every capture under the lock: one
# for the warm-up, one for the capture. cuBLAS keeps a workspace (tens of
# MiB, from the caching allocator) for each (handle, stream) it has run on,
# for the life of the process, so new streams per capture would grow device
# memory by a workspace per spawn. Nothing runs on the capture stream, so
# its workspace is first asked for inside a capture and lands in that
# graph's pool; later graphs of the same thread's handle share it,
# and only one thread replays graphs, one at a time. A warm-up on the
# capture stream would run on that shared workspace beside a replay.
_CAPTURE_STREAMS: Dict[torch.device, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


class DecodeExecutable:
    """One engine's decode step over static buffers (see the module doc).

    Args:
        engine: the `ServingEngine` whose pool, model and shapes the step
            uses; the executable is bound to ``engine.cache`` as it is now,
            and keeps no reference to the engine itself.
    """

    def __init__(self, engine):
        dev = engine.device
        n = engine.n_slots
        self.device = dev
        self.vocab = engine.vocab
        self.tokens = torch.zeros((n, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros(n, dtype=torch.long, device=dev)
        self.tables: Optional[torch.Tensor] = (
            torch.full((n, engine.pages_per_seq), SCRATCH_PAGE, dtype=torch.long,
                       device=dev) if engine.paged else None)
        self.next_tok = torch.zeros(n, dtype=torch.long, device=dev)
        self.logits: Optional[torch.Tensor] = None
        self.cache: Dict[str, torch.Tensor] = dict(engine.cache)
        self._ptrs = _pointers(self.cache)
        self._model = engine.model
        self._paged_decode = engine._decode if engine.paged else None
        self.graph = None
        self.launches: Dict[str, int] = {}
        #: bytes of the dense cache each paged step gathers (Σ ``nbytes`` of
        #: `kvpool.gather_pages`' outputs over the static tables: an eager
        #: step and a replay alike). 0 on a slot pool, which gathers nothing
        self.gathered_bytes = (kvpool.gathered_bytes(self.cache, self.tables, engine._pax)
                               if engine.paged else 0)

    def bound_to(self, cache: Dict[str, torch.Tensor]) -> bool:
        """Whether ``cache`` is the pool this executable was built over
        (the same tensors at the same addresses)."""
        return _pointers(cache) == self._ptrs

    def load(self, tokens: np.ndarray, pos: np.ndarray,
             tables: Optional[np.ndarray] = None) -> None:
        """Write one step's inputs into the static buffers: ``tokens (n,
        1)`` and ``pos (n,)``, and the page tables when given (the engine
        passes them only after they changed)."""
        self.tokens.copy_(torch.from_numpy(tokens))
        self.pos.copy_(torch.from_numpy(pos))
        if tables is not None:
            self.tables.copy_(torch.from_numpy(tables))

    def forward(self) -> None:
        """The decode step, run eagerly over the static buffers."""
        if self.tables is None:
            logits, _ = self._model.decode_step(self.tokens, self.cache, self.pos)
        else:
            logits, _ = self._paged_decode(self.tokens, self.cache, self.pos, self.tables)
        self.logits = logits
        self.next_tok.copy_(torch.argmax(logits[:, : self.vocab], dim=-1))

    def capture(self, warm_up: Callable[[], object]) -> bool:
        """Record the step as a CUDA graph (on the card; a no-op returning
        False on the CPU). ``warm_up`` (one decode step at the live batch
        shape on scratch state, never the live pool) runs first on the
        device's warm-up stream; the capture then records, on the device's
        capture stream, against the live pool without running it, so the
        pool is unchanged. ``thread_local`` capture lets another thread
        serve meanwhile.

        Raises:
            RuntimeError: the step cannot be captured (CUDA's error).
        """
        if self.device.type != "cuda":
            return False
        self.graph, self.launches = _capture_graph(self.device, warm_up, self.forward)
        return True

    def run(self) -> None:
        """One decode step over the static buffers: the graph's replay on
        the card, the eager step on the CPU.

        Raises:
            RuntimeError: on the card, the executable holds no graph (never
                captured, or released).
        """
        _replay_or_forward(self, "decode")

    def release(self) -> None:
        """Free the graph and its private memory pool, after the device has
        finished any replay of it. A released executable cannot run on the
        card."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None
        self.logits = None

    def pool_bytes(self) -> int:
        """Device memory the graph's private pool holds (the step's
        intermediates and its logits), 0 without a graph."""
        return graph_pool_bytes(self.graph)


class PrefillExecutable:
    """One prompt length's prefill over static buffers (see the module
    doc): exact (``padded=False``, prompts of exactly ``length`` tokens) or
    a bucket (``padded=True``, prompts of at most ``length`` tokens, right-
    padded with zeros, the logits read at ``true_len - 1``).

    Args:
        model: the `repro_torch.models.Model` whose ``prefill`` runs, over
            its params as they are at each run.
        length: the token buffer's length.
        padded: a bucket executable.
        device: the model's device.
    """

    def __init__(self, model, length: int, *, padded: bool = False,
                 device: torch.device):
        self.device = device
        self.length = length
        self.padded = padded
        self.vocab = model.cfg.vocab_size
        self.tokens = torch.zeros((1, length), dtype=torch.long, device=device)
        self.true_len: Optional[torch.Tensor] = (
            torch.full((), length, dtype=torch.long, device=device) if padded else None)
        self.next_tok = torch.zeros(1, dtype=torch.long, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.cache1: Optional[Dict[str, torch.Tensor]] = None
        self._model = model
        self.graph = None
        self.launches: Dict[str, int] = {}

    def load(self, prompt: np.ndarray) -> None:
        """Write one prompt into the token buffer (zeros after it in a
        bucket) and, in a bucket, its length into ``true_len``.

        Raises:
            ValueError: the prompt does not fit this executable's length.
        """
        S = len(prompt)
        if S > self.length or (S < self.length and not self.padded):
            raise ValueError(f"a prompt of {S} tokens in a prefill executable of "
                             f"{'at most ' if self.padded else ''}{self.length}")
        row = np.zeros((1, self.length), dtype=np.int64)
        row[0, :S] = prompt
        self.tokens.copy_(torch.from_numpy(row))
        if self.padded:
            self.true_len.fill_(S)

    def batch(self) -> Dict[str, Any]:
        """The prefill's batch over the static buffers."""
        if self.padded:
            return {"tokens": self.tokens, "true_len": self.true_len}
        return {"tokens": self.tokens}

    def forward(self) -> None:
        """The prefill, run eagerly over the static buffers."""
        logits, cache = self._model.prefill(self.batch())
        self.logits, self.cache1 = logits, cache
        self.next_tok.copy_(torch.argmax(logits[:, : self.vocab], dim=-1))

    def capture(self, pool: Optional[Tuple[int, int]] = None) -> bool:
        """Record the prefill as a CUDA graph in the memory pool ``pool``
        (`torch.cuda.graph_pool_handle`; a private pool when None): on the
        card, after one eager run on the device's warm-up stream, which
        launches every kernel the prefill takes once, so that no kernel is
        built or loaded inside the capture. A shared pool is freed with the
        last graph in it, so the graphs of one pool are captured while the
        earlier ones live (as `ServingEngine.prepare_executables` keeps
        them). A no-op returning False on the CPU.

        Raises:
            RuntimeError: the prefill cannot be captured (CUDA's error).
        """
        if self.device.type != "cuda":
            return False
        def warm_up():
            self.forward()
            self.logits = self.cache1 = None

        self.graph, self.launches = _capture_graph(self.device, warm_up, self.forward, pool)
        return True

    def run(self) -> None:
        """One prefill over the static buffers: the graph's replay on the
        card, the eager prefill on the CPU.

        Raises:
            RuntimeError: on the card, the executable holds no graph (never
                captured, or released).
        """
        _replay_or_forward(self, "prefill")

    def release(self) -> None:
        """Free the graph and its outputs, after the device has finished
        any replay of it; the shared pool returns to the allocator when
        the last graph that uses it is freed. A released executable cannot
        run on the card."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
            self.graph = None
        self.logits = self.cache1 = None

    def pool_bytes(self) -> int:
        """Device memory the graph's pool holds (shared by the graphs of
        one PREPARE), 0 without a graph."""
        return graph_pool_bytes(self.graph)


def _capture_graph(device: torch.device, warm_up: Callable[[], object],
                   body: Callable[[], object], pool=None):
    """``warm_up`` on the device's warm-up stream, then ``body`` captured
    on its capture stream (in ``pool``), under `_CAPTURE_LOCK` and with
    ``thread_local`` capture. Returns (the graph, the kernel launches it
    recorded)."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        if device not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        warm, side = _CAPTURE_STREAMS[device]
        warm.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(warm):
            warm_up()
        side.wait_stream(warm)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), ops.captured_launches() as launches:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        side.synchronize()
    return graph, launches


def _replay_or_forward(exe, what: str) -> None:
    """Replay ``exe``'s graph and count its launches (the card), or run it
    eagerly (the CPU); raise on the card without a graph."""
    if exe.graph is not None:
        exe.graph.replay()
        ops.add_launches(exe.launches)
    elif exe.device.type == "cuda":
        raise RuntimeError(f"{what} executable holds no CUDA graph "
                           "(not captured, or released)")
    else:
        exe.forward()


def graph_pool_bytes(graph) -> int:
    """Device memory the memory pool of ``graph`` holds (0 for None)."""
    if graph is None:
        return 0
    pool = tuple(graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)


def _pointers(cache: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {k: v.data_ptr() for k, v in cache.items()}
