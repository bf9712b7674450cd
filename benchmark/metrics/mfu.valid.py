"""Validation model FLOPs (frozen eval_rollout_flops: the nav pass re-encoding
the trunk, the fused HA pass one trunk pass) over the measured window, as a
share of the dense float32 peak, %."""

from harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
