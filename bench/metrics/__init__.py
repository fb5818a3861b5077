"""Per-layer metric readers, one file a metric (``<name>.py`` with
``read(run) -> float | None``), loaded by path (`bench.spec.load_reader`);
shared arithmetic in `bench.metrics.common`."""
