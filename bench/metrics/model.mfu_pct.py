"""The model steps' share of the bf16 peak while the card works: the FLOPs
of the tokens the profiled steps made (a prompt at its true length where
its prefill ran in them, each decoded token at its context) over the
device's busy time in the profiled stretch at 989 TFLOP/s. A faster step
does the same work in less busy time."""
from bench import yardstick


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    inside = set(run.trace.steps)
    ends = {run.steps[k][1] for k in inside}
    ops = 0.0
    for r in run.requests:
        S = len(r.prompt)
        if r.admit_step in inside:
            ops += yardstick.prefill_ops(run.model, S)
        ops += sum(yardstick.decode_ops(run.model, S + j)
                   for j, t in enumerate(r.stamps) if j and t in ends)
    if ops <= 0:
        return None
    return 100.0 * ops / (run.trace.busy_s * yardstick.PEAK_OPS_PER_S["bfloat16"])
