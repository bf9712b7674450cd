"""Fused per-item saliency statistics and their NSS / HA reductions (torch
counterpart of ``avdn_tpu/ops/saliency_pallas.py``).

One pass over the (224, 224) predicted + GT saliency maps produces every
reduction the rollout needs — NSS moments (Σp, Σp²), the NSS numerator
(Σ z·fix via Σ p·fix), the fixation mass (Σ fix), and the human-attention
eval sums (Σ clip(p)·fix, Σ clip(p)) (reference formulas
src/xview_et/agent.py:256-270 and :683-691) — and from them −NSS, its
validity flag and the HA precision and recall.

For tensors on the card, ``saliency_reductions`` and ``saliency_stats``
launch one hand-written CUDA kernel (``csrc/saliency_stats.cu``) that does
both the pass and the tail; ``saliency_stats.launches`` counts its launches.
Tensors on the CPU take the plain versions, ``saliency_reductions_plain``
and ``saliency_stats_plain``.

Training differentiates −NSS in ``pred`` (``gt`` is a constant: it comes
from the render, outside autograd). On the card ``saliency_reductions`` is
then a ``torch.autograd.Function`` whose backward launches a second
hand-written kernel, ``csrc/saliency_nss_grad.cu`` (counted in
``saliency_nss_grad.launches``); on the CPU autograd runs through the plain
version. ``valid``, ``precision`` and ``recall`` carry no gradient. Where
``std == 0`` the gradient is 0: XLA's autodiff of the JAX formula gives NaN
there (0·∞ through the square root's derivative) although the item is
invalid and masked out of the loss; the port's ``std`` avoids that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from avdn_tpu_torch.ops import build

#: Largest cluster the kernel is launched with: the portable maximum. A
#: cluster of 16 (non-portable opt-in) measured slower at B = 8 on the H100
#: (PERF.md).
MAX_CLUSTER = 8
#: Blocks of the kernel an SM holds at once: 2048 threads over 512 per
#: block (ptxas reports 32 registers per thread, so threads are the limit).
RESIDENT_BLOCKS_PER_SM = 4


def saliency_stats_plain(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred, gt: (B, H, W) float32 → (B, 8) stats
    [Σp, Σp², Σp·g, Σg, Σclip(p)·g, Σclip(p), 0, 0] (counterpart of
    ``saliency_stats_xla``)."""
    B = pred.shape[0]
    p = pred.reshape(B, -1)
    g = gt.reshape(B, -1)
    pc = torch.clamp(p, 0.0, 1.0)
    zeros = p.new_zeros((B,))
    return torch.stack(
        [p.sum(1), (p * p).sum(1), (p * g).sum(1), g.sum(1),
         (pc * g).sum(1), pc.sum(1), zeros, zeros],
        dim=1,
    )


def reductions_from_stats(s: torch.Tensor, n: int, nss_r: int = 0):
    """The tail of :func:`saliency_reductions`: (B, 8) stats of maps of
    ``n`` pixels → (neg_nss, valid, precision, recall). The kernel's
    epilogue evaluates the same formulas in the same order."""
    sum_p, sum_p2, sum_pg, sum_g, sum_pcg, sum_pc = s[:, :6].unbind(dim=1)
    mean = sum_p / n
    var = (sum_p2 - n * mean * mean) / (n - 1)
    # sqrt(max(var, 0)), with a zero gradient (not 0·∞) where var <= 0
    pos = var > 0
    std = torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)
    # Σ z·g = (Σ p·g − mean·Σ g) / std
    z_dot = (sum_pg - mean * sum_g) / torch.where(std > 0, std, 1.0)
    if nss_r == 1:
        z_dot = z_dot / 2 + sum_g
    elif nss_r == -1:
        z_dot = z_dot / 2 - sum_g
    nss = z_dot / (sum_g + 0.001)
    valid = (sum_g > 0) & torch.isfinite(nss) & (std > 0)
    sum_pcg, sum_pc, sum_g = sum_pcg.detach(), sum_pc.detach(), sum_g.detach()
    precision = torch.where(sum_pc > 0, sum_pcg / torch.clamp(sum_pc, min=1e-20), 0.0)
    recall = sum_pcg / torch.clamp(sum_g, min=1e-20)
    return -nss, valid, precision, recall


def saliency_reductions_plain(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """Plain version of :func:`saliency_reductions`: the plain stats and
    :func:`reductions_from_stats` (differentiable in ``pred`` under
    autograd; ``gt`` is taken as a constant)."""
    stats = saliency_stats_plain(pred.float(), gt.float().detach())
    return reductions_from_stats(stats, pred.shape[1] * pred.shape[2], nss_r)


def saliency_nss_grad_plain(pred: torch.Tensor, gt: torch.Tensor,
                            upstream: torch.Tensor, nss_r: int = 0) -> torch.Tensor:
    """Plain version of :func:`saliency_nss_grad`: dL/dpred for
    ``upstream`` = dL/d(−NSS), by autograd through
    :func:`saliency_reductions_plain`."""
    with torch.enable_grad():
        p = pred.detach().float().requires_grad_(True)
        neg_nss = saliency_reductions_plain(p, gt, nss_r)[0]
        (grad,) = torch.autograd.grad(neg_nss, p, upstream)
    return grad


# ------------------------------------------------------------- the kernel --


def cluster_size(batch: int, n_sms: int) -> int:
    """Blocks per item (a power of two). Clusters of MAX_CLUSTER while that
    grid covers at most half the SMs: only there does the extra parallelism
    pay for the costlier barrier of a larger cluster. Otherwise the largest
    C <= MAX_CLUSTER / 2 whose grid batch·C fits one wave of resident blocks
    (RESIDENT_BLOCKS_PER_SM·n_sms), and 1 once the batch alone needs more.
    On the H100 this gives the fastest C measured at B = 8, 16, 80 and 240:
    8, 4, 4 and 2 (PERF.md)."""
    if batch * MAX_CLUSTER <= n_sms // 2:
        return MAX_CLUSTER
    c = MAX_CLUSTER // 2
    while c > 1 and batch * c > RESIDENT_BLOCKS_PER_SM * n_sms:
        c //= 2
    return c


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("saliency_stats")
    fn = lib.saliency_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grad_kernel():
    lib = build.load("saliency_nss_grad")
    fn = lib.saliency_nss_grad_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stream(dev: torch.device) -> int:
    if dev.index == torch.cuda.current_device():
        return torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _check_kernel_inputs(pred: torch.Tensor, gt: torch.Tensor) -> None:
    for name, t in (("pred", pred), ("gt", gt)):
        if t.device.type != "cuda":
            raise ValueError(f"saliency kernel: {name} on {t.device}, "
                             "expected both maps on the same CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"saliency kernel: {name} is {t.dtype}, expected float32")
        if t.dim() != 3:
            raise ValueError(f"saliency kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected (B, H, W)")
        if not t.is_contiguous():
            raise ValueError(f"saliency kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"saliency kernel: {name} is not 16-byte aligned")
    if pred.shape != gt.shape or pred.device != gt.device:
        raise ValueError("saliency kernel: pred and gt differ in shape or "
                         f"device ({tuple(pred.shape)} on {pred.device} vs "
                         f"{tuple(gt.shape)} on {gt.device})")
    if (pred.shape[1] * pred.shape[2]) % 4:
        raise ValueError("saliency kernel: H*W must be a multiple of 4 "
                         "(float4 loads)")


def saliency_fused(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """Launch the fused kernel on (B, H, W) float32 maps on the card, with
    :func:`cluster_size` blocks per item: returns (stats (B, 8), neg_nss
    (B,), valid (B,) bool, precision (B,), recall (B,)), all views of one
    allocation. Raises on any launch error."""
    _check_kernel_inputs(pred, gt)
    B, H, W = pred.shape
    dev = pred.device
    cluster = cluster_size(B, _n_sms(dev.index))
    # one allocation: stats (B, 8), then -NSS, precision, recall (B each),
    # then B floats whose first B bytes hold the valid flags
    out = torch.empty(12 * B, dtype=torch.float32, device=dev)
    stats, neg_nss, precision, recall, flags = out.split((8 * B, B, B, B, B))
    valid = flags.view(torch.bool)[:B]
    err = _kernel()(
        pred.data_ptr(), gt.data_ptr(), stats.data_ptr(), neg_nss.data_ptr(),
        valid.data_ptr(), B, H * W, nss_r, cluster, _stream(dev))
    if err != 0:
        raise RuntimeError(f"saliency kernel launch failed (B={B}, cluster "
                           f"{cluster}): CUDA error {err}")
    saliency_stats.launches += 1
    return stats.view(B, 8), neg_nss, valid, precision, recall


def saliency_stats(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred, gt: (B, H, W) float32 → (B, 8) stats. On the card this launches
    the fused kernel (counted in ``saliency_stats.launches``); CPU tensors
    take :func:`saliency_stats_plain`."""
    if pred.device.type == "cpu" and gt.device.type == "cpu":
        return saliency_stats_plain(pred, gt)
    return saliency_fused(pred, gt)[0]


saliency_stats.launches = 0


def saliency_nss_grad(pred: torch.Tensor, gt: torch.Tensor, stats: torch.Tensor,
                      upstream: torch.Tensor, nss_r: int = 0) -> torch.Tensor:
    """Launch the backward kernel on the card: dL/dpred (B, H, W) of the
    −NSS output, from the maps, the forward's (B, 8) ``stats`` and
    ``upstream`` = dL/d(−NSS) (B,). Counted in
    ``saliency_nss_grad.launches``; raises on any input the kernel does not
    take and on a launch error."""
    _check_kernel_inputs(pred, gt)
    B, H, W = pred.shape
    for name, t, shape in (("stats", stats, (B, 8)), ("upstream", upstream, (B,))):
        if (t.device != pred.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"saliency grad kernel: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous float32 "
                             f"{shape} on {pred.device}")
    grad = torch.empty_like(pred)
    err = _grad_kernel()(
        pred.data_ptr(), gt.data_ptr(), stats.data_ptr(), upstream.data_ptr(),
        grad.data_ptr(), B, H * W, nss_r, _stream(pred.device))
    if err != 0:
        raise RuntimeError(f"saliency grad kernel launch failed (B={B}): "
                           f"CUDA error {err}")
    saliency_nss_grad.launches += 1
    return grad


saliency_nss_grad.launches = 0


class _FusedReductions(torch.autograd.Function):
    """The fused kernel as the forward, :func:`saliency_nss_grad` as the
    backward of −NSS."""

    @staticmethod
    def forward(ctx, pred, gt, nss_r):
        stats, neg_nss, valid, precision, recall = saliency_fused(pred, gt, nss_r)
        ctx.save_for_backward(pred, gt, stats)
        ctx.nss_r = nss_r
        ctx.mark_non_differentiable(valid, precision, recall)
        return neg_nss, valid, precision, recall

    @staticmethod
    def backward(ctx, d_neg_nss, *_):
        pred, gt, stats = ctx.saved_tensors
        return saliency_nss_grad(pred, gt, stats, d_neg_nss.contiguous(),
                                 ctx.nss_r), None, None


def saliency_reductions(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """NSS (negated, reference convention) + HA precision/recall from the
    fused stats. Returns (neg_nss (B,), valid (B,), precision (B,),
    recall (B,)). Matches ``ops.losses.nss_loss`` and the HA formulas. On the
    card one kernel launch computes all four, and when ``pred`` requires a
    gradient the backward kernel gives −NSS's; CPU tensors take
    :func:`saliency_reductions_plain`."""
    if pred.device.type == "cpu" and gt.device.type == "cpu":
        return saliency_reductions_plain(pred, gt, nss_r)
    pred, gt = pred.contiguous(), gt.detach().contiguous()
    if torch.is_grad_enabled() and pred.requires_grad:
        return _FusedReductions.apply(pred, gt, nss_r)
    return saliency_fused(pred, gt, nss_r)[1:]
