"""The reference's float32 numerics (after ``avdn_tpu_torch/device.py``,
commit d6443de). :data:`ALLOW_TF32` is False for the reference; the
benchmark's control sets it True, the nearest precision below float32."""

import torch

ALLOW_TF32 = False


def use_fp32_numerics() -> None:
    """Full-fp32 matmuls and convolutions on the card, unless the control
    asked for TF32."""
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
