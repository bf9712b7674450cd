"""The −NSS head-gradient kernel in the traced train steps: its summed byte
bound (live items' GT maps) over its summed device time, %; none where it
never launches (--nss_w 0)."""

from harness.kernels import HEAD_GRAD_KERNEL
from harness.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, HEAD_GRAD_KERNEL)
