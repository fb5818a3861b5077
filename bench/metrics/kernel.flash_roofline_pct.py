"""Flash attention's share of its roofline over the profiled prefills:
each call's least time at its launched shape (batch 1, the bucket's
length for a bucket replay), the larger of its products at the bf16 peak
and its q, k, v and output bytes at HBM's rate, over the device time of
the kernels named in ``kernel_names/flash_attention/``."""
from bench import yardstick
from bench.metrics.common import roofline_pct


def read(run):
    return roofline_pct(run, "flash_attention", yardstick.flash_call, "bfloat16")
