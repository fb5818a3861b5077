"""The compiled decode step: the port's counterpart of the reference's
ahead-of-time decode executable (`jax.jit(...).lower(...).compile()`, a
``jax.stages.Compiled``; `repro.serving.engine.ServingEngine.aot_executables`).

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

The device picks the path. On the card `capture` records the step as a
`torch.cuda.CUDAGraph` over these buffers and the live pool, and `run`
replays it; a failed capture or replay raises, and nothing falls back to
the eager step. On the CPU `capture` records nothing and `run` calls the
same step eagerly on the same buffers.

The graph holds the pool tensors' addresses, so it is valid only while the
engine's pool is the one it was captured over (`bound_to`): the pool is
written in place by every step, admission and migration, and replaced only
by a swap that moves it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.serving.kvpool import SCRATCH_PAGE

# one capture at a time in the process: a capture reaches into the caching
# allocator and the cuBLAS handles of its thread, and PREPARE may capture on
# a worker thread while the serving thread captures an engine's first step
_CAPTURE_LOCK = threading.Lock()


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
        capture's own side stream; the capture then records against the
        live pool without running it, so the pool is unchanged.
        ``thread_local`` capture lets another thread serve meanwhile.

        Raises:
            RuntimeError: the step cannot be captured (CUDA's error).
        """
        if self.device.type != "cuda":
            return False
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                warm_up()
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.forward()
                finally:
                    graph.capture_end()
            side.synchronize()
        self.graph = graph
        return True

    def run(self) -> None:
        """One decode step over the static buffers: the graph's replay on
        the card, the eager step on the CPU.

        Raises:
            RuntimeError: on the card, the executable holds no graph (never
                captured, or released).
        """
        if self.graph is not None:
            self.graph.replay()
        elif self.device.type == "cuda":
            raise RuntimeError("decode executable holds no CUDA graph "
                               "(not captured, or released)")
        else:
            self.forward()

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
        if self.graph is None:
            return 0
        pool = tuple(self.graph.pool())
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


def _pointers(cache: Dict[str, torch.Tensor]) -> Dict[str, int]:
    return {k: v.data_ptr() for k, v in cache.items()}
