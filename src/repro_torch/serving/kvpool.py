"""Paged KV-cache pool: token-granular KV memory for the serving engine.

The layout is the reference's (`repro.serving.kvpool`):

    store        one cache shaped like ``model.init_cache(n_pages + 1,
                 page_size)``: each batch row is one PAGE holding
                 ``page_size`` tokens of every layer's KV. Page 0 is a
                 reserved scratch page; data pages are 1..n_pages.
    page table   per active request, the ordered list of physical pages
                 backing its sequence: token ``t`` lives at row
                 ``table[t // page_size]``, offset ``t % page_size``.
    alloc/free   `PagedKVPool` reserves ``ceil(need / page_size)`` pages for
                 a request's worst-case extent at admission and frees them
                 when it retires; an admission that does not fit fails
                 CLOSED (`PoolOOM`) and the request stays queued.

A decode step gathers the active rows' pages into a dense ``(B,
pages_per_seq * page_size)`` cache, runs the model's ``decode_step`` on it
and writes the one new KV entry per row back through the page table. Pages
past a request's extent are the scratch page and hold garbage, which decode
never reads: it masks every position past ``pos`` to -1e30 before the fp32
softmax, so their weight is exactly zero.

Unlike the reference's pure functions, `scatter_token` and `write_pages`
update the store in place (and return it): the store is the engine's
largest tensor, and a copy per step would double its memory.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.models.lm import layer_kinds

Store = Dict[str, torch.Tensor]
Axes = Dict[str, int]

SCRATCH_PAGE = 0


class PoolOOM(RuntimeError):
    """A page allocation does not fit (free pages minus the watermark) —
    the caller must fail closed: leave the request queued, change
    nothing."""


def supports_paging(model) -> bool:
    """Whether the model's KV cache can be paged: every layer's cache must
    be positional (GQA attention or the MLA latent). An SSM state has no
    sequence axis to page, so SSM and hybrid models serve on the
    slot-granular pool."""
    return all(mixer in ("attn", "mla") for mixer, _ in layer_kinds(model.cfg))


def page_axes(model) -> Tuple[Axes, Axes]:
    """Per-leaf ``(page_axis, seq_axis)`` of the cache layout: ``(L, B, S,
    Hkv, Dh)`` K/V, ``(L, B, S, R)`` / ``(L, B, S, Dr)`` MLA latent. The
    batch axis holds the pages and the sequence axis follows it, read off
    the layout the port defines (`Model.cache_shapes`).

    Raises:
        ValueError: the model cannot be paged (see `supports_paging`).
    """
    if not supports_paging(model):
        raise ValueError(f"{model.cfg.name}: cache has no pageable "
                         "(batch, seq) axis pair")
    shapes = model.cache_shapes(1, 1)
    return {k: 1 for k in shapes}, {k: 2 for k in shapes}


class PagedKVPool:
    """Token-granular page allocator over one device KV store.

    Args:
        page_size: tokens per page.
        n_pages: DATA pages (the scratch page is allocated on top, so the
            store batch dim is ``n_pages + 1``).
        watermark: free pages an admission must leave behind (headroom for
            migration imports); an `alloc` that would dip below it raises
            `PoolOOM`.
    """

    def __init__(self, page_size: int, n_pages: int, *, watermark: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if watermark < 0 or watermark >= n_pages:
            raise ValueError(
                f"watermark must be in [0, n_pages), got {watermark} "
                f"(n_pages={n_pages})")
        self.page_size = page_size
        self.n_pages = n_pages
        self.watermark = watermark
        # LIFO free list: recently-freed pages are re-used first
        self._free: List[int] = list(range(n_pages, 0, -1))

    # -- store ---------------------------------------------------------
    @property
    def store_batch(self) -> int:
        """Batch dim of the device store (data pages + the scratch page)."""
        return self.n_pages + 1

    def init_store(self, model, dtype: torch.dtype = torch.bfloat16) -> Store:
        """The device store: ``model.init_cache(n_pages + 1, page_size)``,
        bf16 as in the reference."""
        return model.init_cache(self.store_batch, self.page_size, dtype=dtype)

    # -- accounting ----------------------------------------------------
    @property
    def free_pages(self) -> int:
        """Pages currently unallocated (including watermark headroom)."""
        return len(self._free)

    @property
    def admittable_pages(self) -> int:
        """Pages an admission may take without dipping below the watermark."""
        return max(len(self._free) - self.watermark, 0)

    @property
    def allocated_tokens(self) -> int:
        """Token capacity currently reserved by live requests."""
        return (self.n_pages - len(self._free)) * self.page_size

    def pages_for(self, tokens: int) -> int:
        """Pages needed to back ``tokens`` KV entries."""
        return max(math.ceil(tokens / self.page_size), 1)

    # -- alloc / free --------------------------------------------------
    def alloc(self, n: int, *, reserve: bool = False) -> List[int]:
        """Take ``n`` pages off the free list (``reserve`` spends the
        watermark headroom too).

        Raises:
            PoolOOM: the pool cannot supply ``n`` pages — nothing is
                allocated (fail closed).
        """
        budget = self.free_pages if reserve else self.admittable_pages
        if n > budget:
            raise PoolOOM(
                f"need {n} pages but only {budget} admittable "
                f"({self.free_pages} free, watermark={self.watermark}, "
                f"n_pages={self.n_pages}) — failing closed")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list.

        Raises:
            ValueError: a page is out of range, the scratch page, or already
                free (a double free is a bookkeeping bug, never absorbed).
        """
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate pages in free(): {sorted(pages)}")
        live = set(self._free)
        for p in pages:
            if not 1 <= p <= self.n_pages:
                raise ValueError(f"page {p} out of range [1, {self.n_pages}]")
            if p in live:
                raise ValueError(f"double free of page {p}")
        self._free.extend(pages)


# ---------------------------------------------------------------------------
# gather / scatter over the page store
# ---------------------------------------------------------------------------


def gather_pages(store: Store, tables: torch.Tensor, pax: Axes, sax: Axes) -> Store:
    """A new dense ``(B, pages_per_seq * page_size)`` cache: row ``b``'s
    sequence is the concatenation of pages ``tables[b, :]``.

    Args:
        store: the page store (batch dim = pages).
        tables: ``(B, pages_per_seq)`` physical page ids, on the store's
            device.
        pax / sax: per-leaf page / seq axes (see `page_axes`).
    """
    B, npp = tables.shape
    out = {}
    for name, leaf in store.items():
        p, s = pax[name], sax[name]
        g = leaf.index_select(p, tables.reshape(-1))
        # page and seq axes are adjacent, so the merge is a reshape
        out[name] = g.reshape(leaf.shape[:p] + (B, npp * leaf.shape[s])
                              + leaf.shape[s + 1:])
    return out


def scatter_token(store: Store, dense: Store, tables: torch.Tensor,
                  pos: torch.Tensor, pax: Axes, sax: Axes) -> Store:
    """Write each row's newest KV entry (position ``pos[b]`` of the dense
    cache) into its page, in place: physical page ``tables[b, pos[b] //
    page_size]``, offset ``pos[b] % page_size``. Inactive lanes point at
    the scratch page and write garbage there."""
    B = tables.shape[0]
    bidx = torch.arange(B, device=tables.device)
    for name, leaf in store.items():
        p, s = pax[name], sax[name]
        ps = leaf.shape[s]
        phys = tables[bidx, pos // ps]
        lead = (slice(None),) * p
        leaf[lead + (phys, pos % ps)] = dense[name][lead + (bidx, pos)].to(leaf.dtype)
    return store


def write_pages(store: Store, single: Store, pages: Sequence[int],
                pax: Axes, sax: Axes) -> Store:
    """Write a single-sequence cache (batch dim 1, e.g. a prefill result)
    into ``pages`` of the store, in place: its seq dim is padded or cut to
    ``len(pages) * page_size`` and split into page-sized rows. Entries of
    ``pages`` that are `SCRATCH_PAGE` absorb the slack."""
    n = len(pages)
    for name, leaf in store.items():
        p, s = pax[name], sax[name]
        ps = leaf.shape[s]
        c = single[name]
        target = n * ps
        if c.shape[s] > target:
            c = c.narrow(s, 0, target)
        elif c.shape[s] < target:
            pad_shape = list(c.shape)
            pad_shape[s] = target - c.shape[s]
            c = torch.cat([c, c.new_zeros(pad_shape)], dim=s)
        c = c.reshape(c.shape[:p] + (n, ps) + c.shape[s + 1:]).to(leaf.dtype)
        idx = torch.as_tensor(pages, dtype=torch.long, device=leaf.device)
        leaf[(slice(None),) * p + (idx,)] = c
    return store


def position_bytes(store: Store, pax: Axes, sax: Axes) -> int:
    """KV bytes of one token position: Σ over the store's leaves of a
    leaf's bytes over its pages times the page size."""
    return sum(leaf.nbytes // (leaf.shape[pax[name]] * leaf.shape[sax[name]])
               for name, leaf in store.items())


def gathered_bytes(store: Store, tables: torch.Tensor, pax: Axes) -> int:
    """Bytes of the dense cache `gather_pages` writes for ``tables``: Σ
    over the store's leaves of one page's bytes, times the pages the
    tables name."""
    return tables.numel() * sum(leaf.nbytes // leaf.shape[pax[name]]
                                for name, leaf in store.items())


def make_paged_decode(model, pax: Axes, sax: Axes):
    """The paged decode step: gather the active rows' pages into a dense
    cache, run the model's ``decode_step`` on it, write the one new token
    per row back through the page tables. Signature ``(tokens (B, 1),
    store, pos (B,), tables (B, pages_per_seq)) -> (logits, store)``."""

    def paged_decode(tokens, store, pos, tables):
        dense = gather_pages(store, tables, pax, sax)
        logits, dense = model.decode_step(tokens, dense, pos)
        return logits, scatter_token(store, dense, tables, pos, pax, sax)

    return paged_decode


# ---------------------------------------------------------------------------
# the store sharded by pages across ranks
# ---------------------------------------------------------------------------
#
# Under a plan that spans several ranks the store's leaves are DTensors that
# follow the reference's `cache_specs` at ``batch=store_batch``: the pages
# split over the batch axes (DTensor's chunk rule), every other dim whole on
# each rank. The allocator and the page tables stay on the host, equal on
# every rank, so admission decides as on one device; the functions below
# move only the pages the tables name. The K/V heads stay whole over the
# tensor axis, as the reference's specs keep them: a tensor-parallel decode
# step's attention reads its own q heads' K/V heads of the dense rows, and
# writes every head of the new entry (gathered over that axis).


def local_pages(leaf) -> Tuple[int, int]:
    """The ``[lo, hi)`` of pages this rank holds of a sharded store leaf
    (batch axis 1); ``(0, 0)`` on a rank outside its mesh."""
    from repro_torch.sharding import ctx
    from repro_torch.sharding.plan import LeafSharding
    return ctx.local_range(tuple(leaf.shape),
                           LeafSharding(leaf.device_mesh, tuple(leaf.placements), None), dim=1)


def gather_named_pages(store: Store, pages: Sequence[int]) -> Store:
    """Pages ``pages`` of every leaf of a sharded store, whole, on every
    rank of its mesh (`ctx.gather_index`); each rank contributes the named
    pages it holds, and no other page moves."""
    from repro_torch.sharding import ctx
    return {name: ctx.gather_index(leaf, pages, 1) for name, leaf in store.items()}


def dense_rows(named: Store, index: Dict[int, int], tables, pax: Axes, sax: Axes) -> Store:
    """The dense ``(B, pages_per_seq * page_size)`` cache of the rows of
    ``tables`` (a host array) from pages gathered by `gather_named_pages`
    (``index``: page id -> its place among them), as `gather_pages` builds
    it from the whole store."""
    B, npp = tables.shape
    sel = [index[int(p)] for p in tables.reshape(-1)]
    out = {}
    for name, leaf in named.items():
        p, s = pax[name], sax[name]
        g = leaf.index_select(p, torch.as_tensor(sel, dtype=torch.long, device=leaf.device))
        out[name] = g.reshape(leaf.shape[:p] + (B, npp * leaf.shape[s]) + leaf.shape[s + 1:])
    return out


def scatter_token_sharded(store: Store, new: Store, tables, pos) -> Store:
    """Write each lane's newest KV entry into its page, in place, on the
    rank that holds the page: ``new[name]`` is ``(L, B, ...)``, lane ``b``'s
    entry at its position ``pos[b]`` (host arrays ``tables (B,
    pages_per_seq)``, ``pos (B,)``), physical page ``tables[b, pos[b] //
    page_size]``, offset ``pos[b] % page_size``."""
    import numpy as np
    for name, leaf in store.items():
        lo, hi = local_pages(leaf)
        if hi <= lo:
            continue
        ps = leaf.shape[2]
        phys = tables[np.arange(len(pos)), pos // ps]
        mine = np.nonzero((phys >= lo) & (phys < hi))[0]
        if not len(mine):
            continue
        local = leaf.to_local()
        dev = local.device
        local[:, torch.as_tensor(phys[mine] - lo, device=dev),
              torch.as_tensor(pos[mine] % ps, device=dev)] = \
            new[name][:, torch.as_tensor(mine, device=dev)].to(local.dtype)
    return store


def write_pages_sharded(store: Store, single: Store, pages: Sequence[int],
                        pax: Axes, sax: Axes) -> Store:
    """`write_pages` into a sharded store: each rank writes the pages of
    ``pages`` it holds, from the whole single-sequence cache every rank of
    the mesh computed; nothing moves between ranks."""
    import numpy as np
    n = len(pages)
    for name, leaf in store.items():
        lo, hi = local_pages(leaf)
        if hi <= lo:
            continue
        idx = np.asarray(pages, dtype=np.int64)
        mine = np.nonzero((idx >= lo) & (idx < hi))[0]
        if not len(mine):
            continue
        p, s = pax[name], sax[name]
        ps = leaf.shape[s]
        c = single[name]
        target = n * ps
        if c.shape[s] > target:
            c = c.narrow(s, 0, target)
        elif c.shape[s] < target:
            pad_shape = list(c.shape)
            pad_shape[s] = target - c.shape[s]
            c = torch.cat([c, c.new_zeros(pad_shape)], dim=s)
        local = leaf.to_local()
        c = c.reshape(c.shape[:p] + (n, ps) + c.shape[s + 1:]).to(local.dtype)
        dev = local.device
        local[(slice(None),) * p + (torch.as_tensor(idx[mine] - lo, device=dev),)] = \
            c[(slice(None),) * p + (torch.as_tensor(mine, device=dev),)]
    return store
