"""Share of the KV bytes the decode step moved that attention needed: the
delta of ``decode_stats["kv_live_bytes"]`` (each decoded lane's positions
up to its own, times a position's KV bytes) over the delta of
``kv_gathered_bytes`` (the dense copy the paged step gathers), both
counted by the engine while the recorder is installed. Like every delta
of ``decode_stats``, it covers the window and the drain. None where
nothing was gathered: a slot pool, a layout across ranks, a run without
the recorder, or a program that does not count these bytes."""


def read(run):
    d = run.decode_delta
    gathered = d.get("kv_gathered_bytes", 0)
    return 100.0 * d.get("kv_live_bytes", 0) / gathered if gathered else None
