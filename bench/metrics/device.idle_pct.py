"""Share of the profiled stretch, while the engine had a lane active or a
request queued (the harness's idle waits left out), in which no kernel,
copy or set ran on the card."""


def read(run):
    t = run.trace
    if t is None or t.active_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_active_s / t.active_s)
