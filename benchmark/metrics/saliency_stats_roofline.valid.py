"""The fused saliency statistics kernel in the traced validation pass: its
summed byte bound over its summed device time, %."""

from harness.kernels import STATS_KERNEL
from harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, STATS_KERNEL)
