"""Prefill's share of the bf16 peak: the FLOPs of each prefill of the
window at its true prompt length, over the sum of its host-timed
``prefill_s`` (the recorder's ``request.admit`` events, stamps around a
prefill that ends in a host read of its token) at 989 TFLOP/s."""
from bench import yardstick


def read(run):
    by_rid = {r.arrival.rid: r for r in run.requests if r.req is not None}
    ops = secs = 0.0
    for ev in run.admit_events:
        r = by_rid.get(ev.rid)
        if r is None or not (run.t0 <= r.req.t_first <= run.t_close):
            continue
        ops += yardstick.prefill_ops(run.model, len(r.prompt))
        secs += float(ev.data["prefill_s"])
    if secs <= 0:
        return None
    return 100.0 * ops / (secs * yardstick.PEAK_OPS_PER_S["bfloat16"])
