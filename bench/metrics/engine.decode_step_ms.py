"""The decode step's own time: the delta of ``decode_stats["decode_s"]``
over the delta of ``decode_spans``, in ms. Each is the engine's
``engine.decode`` span, timed on the host from the first load of the
step's inputs to its picks read on the host (which waits for the device),
while the recorder is installed; the prefills admitted between steps are
outside it. Like every delta of ``decode_stats``, it covers the window and
the drain. None where no step was timed: a run without the recorder, or a
program without the span."""


def read(run):
    d = run.decode_delta
    spans = d.get("decode_spans", 0)
    return 1e3 * d.get("decode_s", 0.0) / spans if spans else None
