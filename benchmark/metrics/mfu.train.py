"""Train-step model FLOPs (frozen train_step_flops) over the measured window,
as a share of the dense float32 peak (67 TFLOP/s, TF32 off), %."""

from harness.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
