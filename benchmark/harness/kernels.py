"""The port's hand kernels as the benchmark counts them: the least bytes and
operations each launch needs (its roofline bound), and a recorder of the
shapes the timed path launches them with.

Byte and operation counts frozen from ``chip_smoke.py`` (commit d6443de):
``phase_kernels`` for the fused saliency statistics and ``phase_grad_kernel``
for the −NSS head gradient, where only the items whose upstream gradient is
not 0 and whose GT map is valid have their GT map read. Peaks: NVIDIA H100
SXM data sheet, dense, at 700 W.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # dense float32 outside the tensor cores (TF32 off)

#: the kernels' symbol names as the profiler records them
STATS_KERNEL = "saliency_fused_kernel"
HEAD_GRAD_KERNEL = "head_grad_kernel"


def stats_bound_s(n: int, hw: int) -> float:
    """Least time of one fused statistics launch over ``n`` (hw, hw) float32
    prediction and GT maps: both read once, 45 bytes an item written."""
    pixels = n * hw * hw
    bytes_moved = 2 * pixels * 4 + n * 45
    return max(bytes_moved / HBM_BYTES_PER_S, 8 * pixels / FP32_FLOPS)


def head_grad_bound_s(n: int, live: int, hw: int, elt: int) -> float:
    """Least time of one head-gradient launch over ``n`` items of which
    ``live`` have their (hw, hw) float32 GT map read; the head in ``elt``
    bytes an element."""
    map_bytes = hw * hw * 4
    bytes_moved = live * map_bytes + n * (2 * 64 * elt + 8 * 4 + 4) + 8 * hw * 4
    return max(bytes_moved / HBM_BYTES_PER_S, 14 * live * hw * hw / FP32_FLOPS)


@dataclasses.dataclass
class Launch:
    kernel: str
    n: int
    hw: int
    elt: int = 4
    gt: object = None        # the GT maps and upstream gradient of a head
    upstream: object = None  # gradient launch, read after the window

    def bound_s(self) -> float:
        if self.kernel == STATS_KERNEL:
            return stats_bound_s(self.n, self.hw)
        valid = self.gt.flatten(1).sum(1) > 0
        live = int(((self.upstream != 0) & valid).sum())
        return head_grad_bound_s(self.n, live, self.hw, self.elt)


@contextlib.contextmanager
def recording(saliency_module, out: List[Launch]):
    """Record every launch of the two kernels in ``out`` (in launch order)
    while the block runs, by wrapping the port's launch functions in
    ``saliency_module`` (``avdn_tpu_torch.ops.saliency``)."""
    fused, head = saliency_module.saliency_fused, saliency_module._head_grad_launch

    def fused_rec(pred, gt, nss_r=0):
        out.append(Launch(STATS_KERNEL, pred.shape[0], pred.shape[-1]))
        return fused(pred, gt, nss_r)

    def head_rec(x8, gt, stats, upstream, nss_r, blocks):
        out.append(Launch(HEAD_GRAD_KERNEL, x8.shape[0], gt.shape[-1], x8.element_size(),
                          gt, upstream))
        return head(x8, gt, stats, upstream, nss_r, blocks)

    saliency_module.saliency_fused = fused_rec
    saliency_module._head_grad_launch = head_rec
    try:
        yield out
    finally:
        saliency_module.saliency_fused = fused
        saliency_module._head_grad_launch = head


def counts(launches: List[Launch]) -> dict:
    """Launches of each hand kernel in ``launches``."""
    out = {}
    for ln in launches:
        out[ln.kernel] = out.get(ln.kernel, 0) + 1
    return out


def roofline(launches: List[Launch], kernel_times: dict, kernel: str) -> Optional[float]:
    """Σ bound over Σ device time of ``kernel``'s launches in a traced
    window, or None where it launched none (or the trace holds another
    number of its records than were launched)."""
    mine = [ln for ln in launches if ln.kernel == kernel]
    times = [t for name, ts in kernel_times.items() if kernel in name for t in ts]
    if not mine or len(times) != len(mine):
        return None
    return sum(ln.bound_s() for ln in mine) / sum(times)
