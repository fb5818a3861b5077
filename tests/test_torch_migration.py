"""Live migration in the port: export/import on both pools, the batched
transfer, fail-closed edges (capacity, labels, route constraints, roles),
migrate-mode retirement, padded buckets installed by PREPARE, and the
collective check at registration.

Mirrors `tests/test_migration.py` (the autoscaler's tests wait for its
port), on reduced fp32 models (`test_torch_cluster.tiny`). The port writes
its pools in place, so the tests also pin what the reference gets for free
from new trees: a snapshot is a copy, and a failed import changes nothing.
"""
import numpy as np
import pytest
import torch
from test_torch_cluster import PINNED, prompts, tiny

from repro_torch.obs import Recorder, recording
from repro_torch.serving import (
    Collective,
    MigrationError,
    Request,
    RoutingError,
    ServingCluster,
    ServingEngine,
)
from repro_torch.serving import migration
from repro_torch.sharding import default_plan


@pytest.fixture(scope="module")
def port():
    cfg, _, _, model = tiny()
    return cfg, model


@pytest.fixture(scope="module")
def ssm():
    cfg, _, _, model = tiny("mamba2_370m")
    return cfg, model


def _mk(model, **kw):
    return ServingEngine(model, **{"n_slots": 2, "s_max": 32, "device": "cpu", **kw})


def _req(rng, cfg, rid, labels=None, n=6, new=5):
    if isinstance(labels, str):
        labels = {"data-type": labels}
    return Request(rid, rng.integers(2, cfg.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=new, labels=labels or {})


def _baseline(model, ps, new, n_slots=4, s_max=32):
    eng = _mk(model, n_slots=n_slots, s_max=s_max)
    reqs = [Request(i, p, max_new_tokens=new) for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return {r.rid: list(r.tokens_out) for r in reqs}


# ---------------------------------------------------------------------------
# state transfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,paged", [("minitron_4b", True), ("minitron_4b", False),
                                        ("mamba2_370m", False)],
                         ids=["paged", "attn_slot", "ssm_slot"])
def test_migrate_mid_decode_streams_bitwise_identical(arch, paged):
    cfg, _, _, model = tiny(arch)
    ps = prompts(cfg.vocab_size, (5, 7, 6, 8), seed=0)
    expect = _baseline(model, ps, new=8)
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model, n_slots=4, paged=paged))
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
    for r in reqs:
        cluster.submit(r)
    for _ in range(3):
        cluster.step()
    cluster.register("dst", _mk(model, n_slots=4, paged=paged))
    records = cluster.migrate_requests("src", "dst")
    assert len(records) == 4
    assert all(m.phase == "decoding" and m.bytes_moved > 0 and m.batch == 4
               for m in records)
    assert cluster.engine("src").load == 0
    cluster.run()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


def test_migrate_across_pool_kinds(port):
    """Paged -> slot-granular -> paged: the snapshot refits to each pool's
    single-sequence layout and the stream stays the unmigrated one."""
    cfg, model = port
    ps = prompts(cfg.vocab_size, (6, 9), seed=4)
    expect = _baseline(model, ps, new=8, n_slots=2)
    cluster = ServingCluster(device="cpu")
    cluster.register("paged", _mk(model))
    cluster.register("slot", _mk(model, paged=False, s_max=48))
    cluster.register("back", _mk(model))
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(ps)]
    for r in reqs:
        cluster.engine("paged").submit(r)
    cluster.step()
    cluster.migrate_requests("paged", "slot")
    cluster.step()
    cluster.migrate_requests("slot", "back")
    cluster.run()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


def test_migrate_mid_prefill_vs_mid_decode(port):
    cfg, model = port
    rng = np.random.default_rng(1)
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model))
    reqs = [_req(rng, cfg, rid) for rid in range(3)]
    for r in reqs:
        cluster.submit(r)
    cluster.step()
    t_submit = reqs[2].t_submit
    cluster.register("dst", _mk(model))
    records = {m.rid: m for m in cluster.migrate_requests("src", "dst")}
    assert records[0].phase == "decoding" and records[0].bytes_moved > 0
    assert records[2].phase == "queued" and records[2].bytes_moved == 0
    assert reqs[2].t_submit == t_submit
    cluster.run()
    assert all(len(r.tokens_out) == r.max_new_tokens for r in reqs)


def test_migrate_into_smaller_pool_fails_closed(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model, s_max=48))
    cluster.register("small", _mk(model, s_max=16))
    rng = np.random.default_rng(2)
    req = _req(rng, cfg, 0, n=8, new=20)
    cluster.engine("src").submit(req)
    cluster.step()
    with pytest.raises(MigrationError):
        cluster.migrate_requests("src", "small", rids=[0])
    assert cluster.engine("src").load == 1
    cluster.run()
    assert len(req.tokens_out) == 20


def test_migrate_larger_pool_never_extends_stream(port):
    cfg, model = port
    rng = np.random.default_rng(3)
    prompt = rng.integers(2, cfg.vocab_size, size=6).astype(np.int32)
    base = _mk(model, s_max=16)
    r0 = Request(0, prompt.copy(), max_new_tokens=30)
    base.submit(r0)
    base.run()
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model, s_max=16))
    cluster.register("big", _mk(model, s_max=64))
    r1 = Request(0, prompt.copy(), max_new_tokens=30)
    cluster.engine("src").submit(r1)
    cluster.step()
    cluster.migrate_requests("src", "big", rids=[0])
    cluster.run()
    assert r1.tokens_out == r0.tokens_out


def test_migrate_unserved_label_fails_closed(port):
    cfg, model = port
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model))
    cluster.register("general-only", _mk(model, labels={"data-type": "general"}))
    rng = np.random.default_rng(4)
    cluster.engine("src").submit(_req(rng, cfg, 0, "phi"))
    cluster.step()
    with pytest.raises(RoutingError):
        cluster.migrate_requests("src", "general-only", rids=[0])
    assert cluster.engine("src").load == 1
    cluster.set_route_constraint("phi", PINNED)
    cluster.register("unpinned", _mk(model), plan=default_plan())
    with pytest.raises(RoutingError):
        cluster.migrate_requests("src", "unpinned", rids=[0])
    cluster.register("pinned", _mk(model), plan=PINNED)
    assert cluster.migrate_requests("src", "pinned", rids=[0])[0].dst == "pinned"


def test_snapshot_is_a_copy_of_the_pool(port, ssm):
    """The pools are written in place: an exported snapshot must not change
    when the freed slot (or page) is written again."""
    for cfg, model, paged in ((port[0], port[1], False), (port[0], port[1], True),
                              (ssm[0], ssm[1], False)):
        rng = np.random.default_rng(5)
        eng = _mk(model, n_slots=1, paged=paged)
        eng.submit(_req(rng, cfg, 0, new=8))
        eng.step()
        snap = eng.export_slot(0)
        kept = {k: v.clone() for k, v in snap.kv.items()}
        eng.submit(_req(rng, cfg, 1, n=9, new=8))
        eng.step()                          # admission reuses the slot / pages
        assert all(torch.equal(kept[k], snap.kv[k]) for k in kept)


def test_failed_batch_import_restores_and_changes_nothing(port):
    """A batch whose second import fails closed restores it (and the rest)
    to the source; the destination keeps exactly the first request, and
    every stream still equals the unmigrated run."""
    cfg, model = port
    ps = prompts(cfg.vocab_size, (5, 7, 6), seed=6)
    expect = _baseline(model, ps, new=6, n_slots=4)
    src = _mk(model, n_slots=4)
    dst = _mk(model, n_slots=1)
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(ps)]
    for r in reqs:
        src.submit(r)
    src.step()
    dst_cache = {k: v.clone() for k, v in dst.cache.items()}
    with pytest.raises(MigrationError, match="no free decode slot"):
        migration.migrate_many(src, dst, [0, 1, 2])
    assert [r.rid for r in dst.slot_req if r is not None] == [0]
    assert sorted(r.rid for r in src.slot_req if r is not None) == [1, 2]
    assert dst.pool.free_pages == dst.pool.n_pages - dst.pool.pages_for(11)
    for k, v in dst.cache.items():          # only request 0's pages changed
        rows = [p for p in range(v.shape[1]) if p not in dst.slot_pages[0] and p != 0]
        assert torch.equal(v[:, rows], dst_cache[k][:, rows])
    while src.load or dst.load:
        src.step()
        dst.step()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


def test_migrate_one_moves_or_restores(port):
    """The unbatched primitive: a request moves with its own pause record;
    an import the destination cannot hold restores it to the source."""
    cfg, model = port
    ps = prompts(cfg.vocab_size, (5, 7), seed=7)
    expect = _baseline(model, ps, new=6, n_slots=2)
    src, dst, tiny_dst = _mk(model), _mk(model), _mk(model, s_max=8)
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(ps)]
    for r in reqs:
        src.submit(r)
    src.step()
    rec = migration.migrate_one(src, dst, 0, src="src", dst="dst")
    assert (rec.rid, rec.phase, rec.batch, rec.src, rec.dst) == (0, "decoding", 1, "src", "dst")
    assert rec.bytes_moved > 0 and rec.pause_s >= 0
    with pytest.raises(MigrationError, match="s_max"):
        migration.migrate_one(src, tiny_dst, 1)
    assert [r.rid for r in src.slot_req if r is not None] == [1]
    while src.load or dst.load:
        src.step()
        dst.step()
    assert {r.rid: list(r.tokens_out) for r in reqs} == expect


def test_fit_single_pads_cuts_and_refuses_other_layouts():
    kv = {"k": torch.arange(24.0).reshape(1, 1, 6, 2, 2)}
    out = migration.fit_single(kv, {"k": (1, 1, 8, 2, 2)})
    assert out["k"].shape == (1, 1, 8, 2, 2)
    assert torch.equal(out["k"][:, :, :6], kv["k"]) and not out["k"][:, :, 6:].any()
    assert torch.equal(migration.fit_single(kv, {"k": (1, 1, 4, 2, 2)})["k"],
                       kv["k"][:, :, :4])
    with pytest.raises(MigrationError, match="congruent"):
        migration.fit_single(kv, {"ssm": (1, 1, 4, 2)})
    pool = {"k": torch.zeros(1, 3, 8, 2, 2, dtype=torch.bfloat16)}
    placed = migration.place_like(out, pool)
    assert placed["k"].dtype == torch.bfloat16
    migration.write_single(pool, placed, {"k": 1}, 2)
    assert torch.equal(migration.slice_slot(pool, {"k": 1}, 2)["k"], placed["k"])
    assert not pool["k"][:, :2].any()


def test_batch_axis_is_axis_one_of_every_leaf(port, ssm):
    for _, model in (port, ssm):
        axes = migration.batch_axis_tree(model, 32)
        assert axes and set(axes.values()) == {1}


@pytest.mark.parametrize("phase", ["decoding", "queued"])
def test_needed_capacity_equals_reference(phase):
    from repro.serving import Request as JRequest
    from repro.serving.migration import needed_capacity as jneeded
    for pos in (6, 10, 30):
        for done in (0, 1, 3, 6):
            for src_s_max in (8, 16, 32):
                reqs = [R(0, np.zeros(6, np.int32), max_new_tokens=6)
                        for R in (Request, JRequest)]
                for r in reqs:
                    r.tokens_out = [1] * done
                assert migration.needed_capacity(reqs[0], phase, pos, src_s_max) \
                    == jneeded(reqs[1], phase, pos, src_s_max)


# ---------------------------------------------------------------------------
# migrate-mode retirement
# ---------------------------------------------------------------------------


def test_retire_migrate_reaps_immediately_with_measured_downtime(port):
    cfg, model = port
    rng = np.random.default_rng(5)
    cluster = ServingCluster(device="cpu")
    cluster.register("a", _mk(model, n_slots=4))
    cluster.register("b", _mk(model, n_slots=4))
    reqs = [_req(rng, cfg, rid) for rid in range(3)]
    for r in reqs:
        cluster.engine("a").submit(r)
    cluster.step()
    report = cluster.retire_engine("a", mode="migrate")
    assert "a" not in cluster.engines()
    assert report.event == "retire" and report.downtime_s > 0.0
    assert len(report.migrations) == 3 and report.migrate_bytes > 0
    assert all(m.pause_s >= 0 for m in report.migrations)
    cluster.run()
    assert all(len(r.tokens_out) == r.max_new_tokens for r in reqs)
    assert cluster.metrics()["completed"] == 3


def test_retire_migrate_falls_back_to_drain_without_peer(port):
    cfg, model = port
    rng = np.random.default_rng(6)
    cluster = ServingCluster(device="cpu")
    cluster.register("phi-0", _mk(model, labels={"data-type": "phi"}))
    cluster.register("general-0", _mk(model, labels={"data-type": "general"}))
    req = _req(rng, cfg, 0, "phi")
    cluster.engine("phi-0").submit(req)
    cluster.step()
    report = cluster.retire_engine("phi-0", mode="migrate")
    assert report.migrations == ()
    assert cluster.draining() == ["phi-0"]
    cluster.run()
    assert "phi-0" not in cluster.engines()
    assert len(req.tokens_out) == req.max_new_tokens


def test_retire_migrate_zero_peers_falls_back_to_drain(port):
    from repro_torch.serving import simulated_time
    cfg, model = port
    rng = np.random.default_rng(20)
    with simulated_time() as clock:
        cluster = ServingCluster(device="cpu")
        cluster.register("only", _mk(model))
        req = _req(rng, cfg, 0)
        cluster.engine("only").submit(req)
        cluster.step()
        report = cluster.retire_engine("only", mode="migrate")
        assert report.migrations == () and report.downtime_s == 0.0
        assert report.migrate_bytes == 0 and cluster.draining() == ["only"]
        cluster.run()
    assert "only" not in cluster.engines()
    assert len(req.tokens_out) == req.max_new_tokens
    assert req.t_done > req.t_first > req.t_submit
    ticks = (req.t_done - req.t_submit) / clock.tick
    assert abs(ticks - round(ticks)) < 1e-6


def test_drain_mode_retirement_unchanged(port):
    cfg, model = port
    rng = np.random.default_rng(7)
    cluster = ServingCluster(device="cpu")
    cluster.register("a", _mk(model))
    cluster.register("b", _mk(model))
    cluster.engine("a").submit(_req(rng, cfg, 0))
    report = cluster.retire_engine("a")
    assert report.downtime_s == 0.0 and report.migrations == ()
    assert cluster.draining() == ["a"]
    cluster.run()
    assert "a" not in cluster.engines()
    with pytest.raises(ValueError):
        cluster.retire_engine("b", mode="teleport")


# ---------------------------------------------------------------------------
# padded buckets installed by PREPARE
# ---------------------------------------------------------------------------


def test_prepared_buckets_serve_unseen_lengths_exactly(port):
    """A reconfigure with buckets installs the warmed ladder: unseen
    lengths pad to a bucket and give the exact-length path's tokens."""
    cfg, model = port
    ps = prompts(cfg.vocab_size, (11, 5), seed=10)
    expect = _baseline(model, ps, new=5, n_slots=2)
    eng = _mk(model)
    assert eng.supports_padded_prefill() and eng.bucket_lengths() == [8, 16, 32]
    cluster = ServingCluster(device="cpu")
    cluster.register("e0", eng)
    report = cluster.reconfigure("e0", default_plan(), prefill_lengths=(6,),
                                 prefill_buckets=True)
    assert report.compiled_in_prepare == 5
    assert eng._bucket_lengths == [8, 16, 32]
    seen = []
    real = model.prefill
    model.prefill = lambda batch: (seen.append(batch["tokens"].shape[1]), real(batch))[1]
    try:
        reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        del model.prefill
    assert seen == [16, 8]
    assert {r.rid: r.tokens_out for r in reqs} == expect


def test_bucket_prefill_excluded_for_ssm_models(ssm):
    _, model = ssm
    eng = _mk(model)
    assert not eng.supports_padded_prefill() and eng.bucket_lengths() == []


def test_migrated_queued_request_reuses_target_buckets(port):
    cfg, model = port
    rng = np.random.default_rng(11)
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model))
    reqs = [_req(rng, cfg, rid, n=9) for rid in range(3)]
    for r in reqs:
        cluster.submit(r)
    cluster.step()
    dst = _mk(model)
    cluster.register("dst", dst)
    cluster.reconfigure("dst", default_plan(), prefill_lengths=(), prefill_buckets=True)
    records = cluster.migrate_requests("src", "dst", rids=[2])
    assert records[0].phase == "queued"
    assert dst._bucket_lengths == [8, 16, 32]
    cluster.run()
    assert len(reqs[2].tokens_out) == reqs[2].max_new_tokens


# ---------------------------------------------------------------------------
# the collective check (the reference's compiled-HLO check)
# ---------------------------------------------------------------------------

#: an all-reduce over ranks {0, 4}: on a (2, 2, 2) mesh it crosses "pod"
BAD = [Collective("c10d.allreduce_", (0, 4))]
MESH = dict(mesh_shape=(2, 2, 2), axis_names=("pod", "data", "model"))


def test_verify_engine_collectives_fail_closed_on_forbidden_axis(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", PINNED)
    cluster.register("e0", _mk(model), plan=PINNED)
    with pytest.raises(ValueError, match="fail-closed"):
        cluster.verify_engine_collectives("e0", collectives=BAD, **MESH)
    # the engine's real decode step (one device, no process group) passes
    assert cluster.engine("e0").decode_collectives() == []
    assert "0 collectives checked" in cluster.verify_engine_collectives("e0")


def test_register_checks_traced_collectives_not_just_plan(port, monkeypatch):
    _, model = port
    import repro_torch.core.validator as validator
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", PINNED)
    monkeypatch.setattr(ServingEngine, "decode_collectives", lambda self: BAD)
    real = validator.check_collective_axes
    monkeypatch.setattr(validator, "check_collective_axes",
                        lambda c, axes, shape, names: real(c, axes, *MESH.values()))
    with pytest.raises(ValueError, match="collective validation"):
        cluster.register("bad", _mk(model), plan=PINNED)
    assert "bad" not in cluster.engines()
    cluster.register("ok", _mk(model), plan=PINNED, verify_collectives=False)
    assert "ok" in cluster.engines()


def test_untraceable_decode_fails_closed(port, monkeypatch):
    """If the decode step cannot be traced, registration under a
    constraint fails closed."""
    _, model = port

    def broken(self):
        raise RuntimeError("decode step could not be traced")

    monkeypatch.setattr(ServingEngine, "decode_collectives", broken)
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", PINNED)
    with pytest.raises(ValueError, match="fail-closed"):
        cluster.register("e0", _mk(model), plan=PINNED)
    assert cluster.engines() == []


def test_constraint_installed_after_register_quarantines_bad_engine(port, monkeypatch):
    cfg, model = port
    import repro_torch.core.validator as validator
    rng = np.random.default_rng(12)
    cluster = ServingCluster(device="cpu")
    cluster.register("bad", _mk(model), plan=PINNED)
    cluster.register("open", _mk(model), plan=default_plan())
    monkeypatch.setattr(ServingEngine, "decode_collectives", lambda self: BAD)
    real = validator.check_collective_axes
    monkeypatch.setattr(validator, "check_collective_axes",
                        lambda c, axes, shape, names: real(c, axes, *MESH.values()))
    with pytest.raises(ValueError, match="fail-closed"):
        cluster.set_route_constraint("phi", PINNED)
    assert "phi" in cluster.route_constraints() and "bad" in cluster.engines()
    with pytest.raises(RoutingError):
        cluster.submit(_req(rng, cfg, 0, "phi"))
    assert cluster.submit(_req(rng, cfg, 1)) == "open"


def test_spawn_engine_verifies_traced_collectives(port):
    _, model = port
    cluster = ServingCluster(device="cpu")
    cluster.set_route_constraint("phi", PINNED)
    report = cluster.spawn_engine("phi-0", _mk(model), plan=PINNED,
                                  labels={"data-type": "phi"})
    assert report.event == "spawn"
    assert "phi-0" in cluster.engines_for_label("phi")


# ---------------------------------------------------------------------------
# empty cohorts, role preflight, cross-s_max handoff
# ---------------------------------------------------------------------------


def test_empty_cohort_is_a_true_noop(port):
    cfg, model = port
    rng = np.random.default_rng(30)
    with recording(Recorder()) as rec:
        cluster = ServingCluster(device="cpu")
        cluster.register("a", _mk(model))
        cluster.register("b", _mk(model))
        assert cluster.migrate_requests("a", "b") == []
        assert cluster.migrate_requests("a", "b", rids=[]) == []
        req = _req(rng, cfg, 0)
        cluster.engine("a").submit(req)
        cluster.step()
        assert cluster.migrate_requests("a", "b", rids=[]) == []
        report = cluster.retire_engine("b", mode="migrate")
        assert report.downtime_s == 0.0 and report.migrations == ()
        cluster.run()
        assert len(req.tokens_out) == req.max_new_tokens
    assert rec.events("migration.pause") == []
    assert [s for s in rec.trace.spans() if s.name == "migration.pause"] == []


def test_queued_request_to_decode_engine_fails_closed(port):
    cfg, model = port
    rng = np.random.default_rng(31)
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model, n_slots=1))
    cluster.register("dc", _mk(model), role="decode")
    reqs = [_req(rng, cfg, rid) for rid in range(2)]
    for r in reqs:
        cluster.engine("src").submit(r)
    cluster.engine("src").step()
    with pytest.raises(RoutingError, match="decode"):
        cluster.migrate_requests("src", "dc", rids=[1])
    assert len(cluster.engine("src").queue) == 1
    cluster.run()
    assert all(len(r.tokens_out) == r.max_new_tokens for r in reqs)


def test_decoding_request_to_prefill_engine_fails_closed(port):
    cfg, model = port
    rng = np.random.default_rng(32)
    cluster = ServingCluster(device="cpu")
    cluster.register("src", _mk(model))
    cluster.register("pf", _mk(model), role="prefill")
    req = _req(rng, cfg, 0)
    cluster.engine("src").submit(req)
    cluster.engine("src").step()
    with pytest.raises(RoutingError, match="prefill"):
        cluster.migrate_requests("src", "pf", rids=[0])
    assert cluster.engine("src").load == 1
    cluster.run()
    assert len(req.tokens_out) == req.max_new_tokens


def test_cross_smax_handoff_never_truncates(port):
    cfg, model = port
    rng = np.random.default_rng(33)
    prompt = rng.integers(2, cfg.vocab_size, size=8).astype(np.int32)
    big = Request(0, prompt.copy(), max_new_tokens=20)
    small = Request(1, prompt.copy(), max_new_tokens=4)
    cluster = ServingCluster(device="cpu")
    cluster.register("pf", _mk(model, n_slots=4, s_max=48), role="prefill")
    cluster.register("dc", _mk(model, n_slots=4, s_max=16), role="decode")
    assert cluster.submit(big) == "pf" and cluster.submit(small) == "pf"
    cluster.step()
    assert cluster.engine("dc").load == 1 and cluster.engine("pf").load == 1
    with pytest.raises(MigrationError):
        cluster.migrate_requests("pf", "dc", rids=[0])
    assert cluster.engine("pf").load == 1
    cluster.run()
    assert len(big.tokens_out) == 20 and len(small.tokens_out) == 4
