"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point (``serve.Navigator``, ``data.maps.DeviceMapBank``) takes a
``device`` argument and resolves it here. ``None`` means the current CUDA
device; without a card that raises instead of continuing on the CPU. The
tests pass ``device="cpu"``, which runs every kernel's plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: avdn_tpu_torch runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def use_fp32_numerics() -> None:
    """Full-fp32 matmuls and convolutions on the card. This torch build runs
    fp32 convolutions in TF32 by default, which keeps ~3 decimal digits and
    breaks parity with the reference numerics (a 1e-5 reassociation already
    flips a borderline fixture episode, PERF.md)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
