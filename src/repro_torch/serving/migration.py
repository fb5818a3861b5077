"""Live in-flight request migration: move one request's KV (or SSM) state
between engines instead of draining (the reference's
`repro.serving.migration`, on the port's pools).

    export   `ServingEngine.export_slot(rid)` snapshots everything one
             request owns — its state (gathered from its pages, or sliced
             out of its slot along the batch axis), its decode position,
             generated tokens and metric stamps — and frees its lane.
             Queued requests export as ``phase="queued"`` snapshots (no
             state yet).
    refit    `fit_single` pads or cuts the snapshot to the target pool's
             single-sequence layout (a differing ``s_max``); `place_like`
             moves and casts each leaf to the target pool's device and
             dtype.
    import   `ServingEngine.import_slot(snapshot)` writes the state into a
             free lane and resumes decode at the snapshot position — no
             re-run of prefill.
    resume   the request decodes on the target; its token stream equals
             an unmigrated run's (the state is copied verbatim and decode
             is row-wise).

The port's pools are written IN PLACE (the reference returns new trees),
so a snapshot is always a copy of the pool's rows, never a view of them:
a later admission into the freed slot must not change a snapshot that
may still be restored.

Fail-closed rules (checked at import, before any state is written):

  * the request's remaining budget must fit the target pool's sequence
    capacity — importing into a smaller ``s_max`` raises `MigrationError`;
  * `export_slot` clamps ``max_new_tokens`` to what the SOURCE pool could
    have produced, so a larger target never extends a stream;
  * a failed import restores the snapshot onto the source, which always
    fits its own state.

Route-constraint compliance is the cluster's job (`migrate_requests`);
this module only moves state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.obs import events as obs_events

if TYPE_CHECKING:                      # no runtime import: engine.py imports us
    from repro_torch.serving.engine import Request

State = Dict[str, torch.Tensor]
Layout = Mapping[str, Tuple[int, ...]]


def _record_migration(record: "MigrationRecord") -> None:
    """Flight-recorder hook: one ``migration.pause`` event + a span whose
    duration is EXACTLY ``record.pause_s``."""
    rec = obs_events.RECORDER
    if rec is None:
        return
    end = obs_events.now()
    rec.emit("migration.pause", engine=record.src, rid=record.rid,
             pause_s=record.pause_s, dst=record.dst, phase=record.phase,
             bytes_moved=record.bytes_moved, batch=record.batch,
             reason=record.reason)
    rec.span_at("migration.pause", end - record.pause_s, record.pause_s,
                track=record.src or "migration", cat="migration",
                rid=record.rid, dst=record.dst, reason=record.reason)


class MigrationError(RuntimeError):
    """A snapshot cannot be imported (capacity/slot/layout mismatch) —
    the request stays on (or is restored to) its source engine."""


@dataclasses.dataclass
class SlotSnapshot:
    """Everything one in-flight request owns, detached from its engine.

    Attributes:
        rid: the request id.
        request: the live `Request` — tokens so far and the metric stamps
            travel with it; nothing is re-stamped.
        phase: ``"decoding"`` (``kv`` holds its state) or ``"queued"``
            (not yet prefilled; no state).
        pos: the decode write position for a decoding snapshot; the prompt
            length for a queued one.
        kv: single-sequence state, batch dim 1 (axis 1 of every leaf), a
            copy of the source pool's rows; ``None`` when queued.
        src_s_max: the source pool's sequence capacity.
        src_engine: source engine name (telemetry only).
        t_export: wall-clock stamp when the snapshot was taken.
        ranks: the ranks that hold ``kv`` when it was exported from an
            engine laid out across ranks (its state gathered on the ranks
            of its mesh; elsewhere ``kv`` holds meta tensors of the same
            shapes and dtypes); None when every rank holds it.
    """

    rid: int
    request: "Request"
    phase: str
    pos: int
    kv: Optional[State]
    src_s_max: int
    src_engine: str = ""
    t_export: float = dataclasses.field(default_factory=time.time)
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def nbytes(self) -> int:
        """Bytes of state carried by this snapshot (0 when queued)."""
        return state_bytes(self.kv) if self.kv is not None else 0

    def remaining_tokens(self) -> int:
        """Decode budget left after the tokens already generated."""
        return max(self.request.max_new_tokens - len(self.request.tokens_out), 0)


@dataclasses.dataclass(frozen=True)
class MigrationRecord:
    """Telemetry for one migrated request.

    Attributes:
        rid: the migrated request.
        src / dst: engine names.
        phase: ``"decoding"`` or ``"queued"`` at export time.
        pause_s: the request's blocking window — export + refit + import,
            each ending in a device synchronisation. Under a batched
            transfer (`migrate_many`) each request's pause is its own
            export + import plus a ``1/batch`` share of the one transfer.
        bytes_moved: state bytes transferred (0 for queued requests).
        batch: decoding requests that shared this record's transfer.
        reason: ``""`` for an operator migration/retirement, ``"handoff"``
            for the cluster's first-token prefill→decode handoff.
    """

    rid: int
    src: str
    dst: str
    phase: str
    pause_s: float
    bytes_moved: int
    batch: int = 1
    reason: str = ""


def state_bytes(tree) -> int:
    """Bytes of a (nested) dict of tensors."""
    if isinstance(tree, Mapping):
        return sum(state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU) — the end of
    every window this module times, as `block_until_ready` in the
    reference."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# pool surgery (shape-driven)
# ---------------------------------------------------------------------------


def batch_axis_tree(model, s_max: int) -> Dict[str, int]:
    """Per-leaf batch axis of a model's cache layout, probed from
    `Model.cache_shapes` at two batch sizes (the port's layout puts it on
    axis 1 of every leaf); ``-1`` marks a leaf with no batch axis."""
    one = model.cache_shapes(1, s_max)
    three = model.cache_shapes(3, s_max)

    def find(a, b):
        for ax in range(len(a)):
            if a[ax] == 1 and b[ax] == 3:
                return ax
        return -1

    return {k: find(one[k], three[k]) for k in one}


def slice_slot(pool: State, axes: Mapping[str, int], slot: int) -> State:
    """A COPY of one batch slot of the pool, batch dim kept at 1 (the
    pool is written in place later; a view would change under the
    snapshot)."""
    return {k: (p.narrow(axes[k], slot, 1).clone() if axes[k] >= 0 else p.clone())
            for k, p in pool.items()}


def fit_single(kv: State, dst_single: Layout) -> State:
    """Refit a single-sequence state onto a target single-sequence layout
    (shapes per leaf): longer dims are cut (valid entries live in the
    prefix — decode masks by position), shorter ones zero-padded. Dtypes
    are left to `place_like`.

    Raises:
        MigrationError: the layouts are not congruent (another
            architecture's state).
    """
    if set(kv) != set(dst_single) or any(
            kv[k].dim() != len(dst_single[k]) for k in kv):
        raise MigrationError(
            "snapshot state layout is not congruent with the target "
            f"engine's (another model architecture?): "
            f"{ {k: tuple(v.shape) for k, v in kv.items()} } vs {dict(dst_single)}")
    out = {}
    for name, k in kv.items():
        d = dst_single[name]
        for ax in range(k.dim()):
            if k.shape[ax] > d[ax]:
                k = k.narrow(ax, 0, d[ax])
            elif k.shape[ax] < d[ax]:
                pad = list(k.shape)
                pad[ax] = d[ax] - k.shape[ax]
                k = torch.cat([k, k.new_zeros(pad)], dim=ax)
        out[name] = k
    return out


def place_like(kv: State, pool: State) -> State:
    """Each leaf moved and cast to its pool leaf's device and dtype (one
    card: a cast where the dtypes differ, else the leaf itself)."""
    return {k: v.to(device=pool[k].device, dtype=pool[k].dtype)
            for k, v in kv.items()}


def write_single(pool: State, single: State, axes: Mapping[str, int],
                 slot: int) -> State:
    """Write a single-sequence state into batch slot ``slot`` of the pool,
    IN PLACE (the inverse of `slice_slot`; trailing dims already fit)."""
    for k, p in pool.items():
        if axes[k] >= 0:
            p.narrow(axes[k], slot, 1).copy_(single[k])
    return pool


def needed_capacity(request: "Request", phase: str, pos: int,
                    src_s_max: int) -> int:
    """The least target ``s_max`` that can finish this request's
    generation without hitting the pool's sequence cap — computable
    BEFORE export (it applies the clamp `export_slot` will)."""
    if phase == "queued":
        # prefill emits token 1 at pos=len(prompt); rem-1 decode steps follow
        rem = min(max(request.max_new_tokens - len(request.tokens_out), 0),
                  src_s_max - len(request.prompt))
        return len(request.prompt) + max(rem, 1)
    rem = min(max(request.max_new_tokens - len(request.tokens_out), 0),
              src_s_max - 1 - pos)
    return pos + rem + 1


def required_capacity(snapshot: SlotSnapshot) -> int:
    """`needed_capacity` of an already-exported snapshot."""
    return needed_capacity(snapshot.request, snapshot.phase, snapshot.pos,
                           snapshot.src_s_max)


def migrate_one(src_engine, dst_engine, rid: int, *,
                src: str = "", dst: str = "",
                reason: str = "") -> MigrationRecord:
    """Export ``rid`` from ``src_engine`` and import it into
    ``dst_engine``, restoring it to the source if the import fails closed.

    Raises:
        KeyError: ``rid`` is not on the source engine.
        MigrationError: the destination cannot hold the request (it has
            been restored to the source, unchanged).
    """
    t0 = time.perf_counter()
    snap = src_engine.export_slot(rid)
    if src:
        snap.src_engine = src
    try:
        moved = dst_engine.import_slot(snap)
    except MigrationError:
        src_engine.import_slot(snap)   # the source always fits its own state
        raise
    record = MigrationRecord(rid=rid, src=src, dst=dst, phase=snap.phase,
                             pause_s=time.perf_counter() - t0,
                             bytes_moved=moved, reason=reason)
    _record_migration(record)
    return record


def migrate_many(src_engine, dst_engine, rids: Sequence[int], *,
                 src: str = "", dst: str = "",
                 reason: str = "") -> List[MigrationRecord]:
    """Move a batch of requests between one engine pair with ONE transfer
    for all of their state (`ServingCluster.migrate_requests` calls this).

    Export every snapshot, refit each decoding one to the destination's
    single-sequence layout, concatenate them along the batch axis, move
    the batch to the destination's device and dtypes at once, then import
    each request's row. Each ``pause_s`` is the request's own export +
    import window plus a ``1/batch`` share of the shared transfer.

    Fail-closed: if an import fails, that request AND every not-yet-
    imported one are restored to the source before the error propagates;
    requests imported before the failure stay moved.

    Returns:
        One `MigrationRecord` per request, in ``rids`` order.

    Raises:
        KeyError: a ``rid`` is not on the source engine (earlier exports
            are restored).
        MigrationError: an import failed closed (see above).
    """
    if not rids:
        return []
    snaps: List[SlotSnapshot] = []
    t_export: Dict[int, float] = {}
    for rid in rids:
        t0 = time.perf_counter()
        try:
            snap = src_engine.export_slot(rid)
        except KeyError:
            for s in snaps:            # unwind: nothing moved
                src_engine.import_slot(s)
            raise
        if src:
            snap.src_engine = src
        t_export[rid] = time.perf_counter() - t0
        snaps.append(snap)

    decoding = [s for s in snaps if s.phase == "decoding"]
    fitted: Dict[int, State] = {}
    t_share = 0.0
    # an engine laid out across ranks imports each request on its own: its
    # state has to reach the ranks of the destination's mesh
    if decoding and not any(s.ranks is not None for s in decoding) \
            and getattr(dst_engine, "layout", None) is None:
        t0 = time.perf_counter()
        layout = dst_engine.single_layout()
        axes = dst_engine._migration_axes()
        fits = [fit_single(s.kv, layout) for s in decoding]
        if len(fits) == 1:
            batched = fits[0]
        else:
            batched = {k: (torch.cat([f[k] for f in fits], dim=axes[k])
                           if axes[k] >= 0 else fits[0][k]) for k in fits[0]}
        placed = place_like(batched, dst_engine.cache)    # ONE transfer
        sync(dst_engine.device)
        for i, s in enumerate(decoding):
            fitted[s.rid] = placed if len(decoding) == 1 else {
                k: (v.narrow(axes[k], i, 1) if axes[k] >= 0 else v)
                for k, v in placed.items()}
        t_share = (time.perf_counter() - t0) / len(decoding)

    records: List[MigrationRecord] = []
    for k, snap in enumerate(snaps):
        t0 = time.perf_counter()
        try:
            moved = dst_engine.import_slot(snap, kv_fitted=fitted.get(snap.rid))
        except MigrationError:
            for s in snaps[k:]:        # this one + every not-yet-imported
                src_engine.import_slot(s)
            raise
        decode_share = t_share if snap.phase == "decoding" else 0.0
        record = MigrationRecord(
            rid=snap.rid, src=src, dst=dst, phase=snap.phase,
            pause_s=t_export[snap.rid] + decode_share
            + (time.perf_counter() - t0),
            bytes_moved=moved,
            batch=len(decoding) if snap.phase == "decoding" else 1,
            reason=reason)
        _record_migration(record)
        records.append(record)
    return records
