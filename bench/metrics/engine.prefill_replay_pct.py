"""Share of the window's admissions whose prefill replayed a graph: the
window's delta of ``prefill_stats["replays"]`` over its delta of
``exact + bucket + eager``."""


def read(run):
    d = run.prefill_delta
    total = d["exact"] + d["bucket"] + d["eager"]
    return 100.0 * d["replays"] / total if total else None
