"""The MoE gate top-k's share of its roofline over the profiled prefills:
one call a layer over the launched tokens padded to whole dispatch groups
(``ceil(L / g) g``, ``g = min(1024, L)``), its fp32 softmax and picks at
the fp32 peak or its logits, weights and ids at HBM's rate, over the
device time of the kernels named in ``kernel_names/moe_topk/``."""
from bench import yardstick
from bench.metrics.common import roofline_pct


def _tokens(L):
    g = min(1024, L)
    return -(-L // g) * g


def read(run):
    if not run.model.get("moe"):
        return None
    return roofline_pct(run, "moe_topk", yardstick.moe_topk_call, "float32", _tokens)
