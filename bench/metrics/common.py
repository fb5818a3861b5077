"""What several readers share: the prefills a traced stretch profiled, and
a kernel's roofline share over them."""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from bench import devtrace, spec, yardstick


def profiled_prefills(run) -> List[int]:
    """Launched lengths of the prefills admitted in the profiled steps."""
    if run.trace is None:
        return []
    inside = set(run.trace.steps)
    return [r.launched for r in run.requests if r.admit_step in inside]


def roofline_pct(run, kernel: str, call: Callable[[dict, int], Tuple[int, int]],
                 dtype: str, tokens: Callable[[int], int] = lambda L: L,
                 per_prefill: Optional[int] = None) -> Optional[float]:
    """Σ over the profiled prefills of ``per_prefill`` calls' least time
    (``call(model, tokens(L))``'s operations at ``dtype``'s peak or bytes
    at HBM's), over the device time of the kernels named for ``kernel``;
    None where the stretch has no such launch, or where their count is not
    the prefills' (a launch from outside the profiled steps)."""
    if run.trace is None:
        return None
    lens = profiled_prefills(run)
    seconds, launches = devtrace.kernel_time(run.trace, spec.kernel_names(kernel))
    per = per_prefill if per_prefill is not None else run.model["num_layers"]
    if not lens or launches == 0 or launches != per * len(lens):
        return None
    least = sum(per * yardstick.bound_s(*call(run.model, tokens(L)), dtype)[0] for L in lens)
    return 100.0 * least / seconds
