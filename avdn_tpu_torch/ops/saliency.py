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

Training differentiates −NSS in the (N, 8, 8) saliency head ``x8`` that
the model feeds to :func:`saliency_upsample` (``gt`` is a constant: it
comes from the render, outside autograd). :func:`saliency_head_reductions`
spans the upsample and the reductions: on the card its forward is the
upsample and the fused kernel, and its backward one launch of a second
hand-written kernel, ``csrc/saliency_head_grad.cu``, which gives dL/dx8
straight from the GT map, the head and the forward's stats row (counted in
``saliency_head_grad.launches``); on the CPU autograd runs through the
upsample and the plain reductions. ``valid``, ``precision``, ``recall`` and
the full-resolution ``pred`` carry no gradient. Where ``std == 0`` the
gradient is 0: XLA's autodiff of the JAX formula gives NaN there (0·∞
through the square root's derivative) although the item is invalid and
masked out of the loss; the port's ``std`` avoids that.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from avdn_tpu_torch.ops import build

#: Largest cluster the kernel is launched with: the portable maximum. A
#: cluster of 16 (non-portable opt-in) measured slower at B = 8 on the H100
#: (PERF.md).
MAX_CLUSTER = 8
#: Blocks of the kernel an SM holds at once: 2048 threads over 512 per
#: block (ptxas reports 32 registers per thread, so threads are the limit).
RESIDENT_BLOCKS_PER_SM = 4


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s (n_in, n_out) bilinear upscale weights
    (half-pixel centres, edge weights renormalised)."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * inv - 0.5
    w = (1.0 - (sample[None, :] - torch.arange(n_in, dtype=torch.float64,
                                                device=device)[:, None]).abs()).clamp(min=0)
    return (w / w.sum(dim=0, keepdim=True)).float()


def saliency_upsample(x8: torch.Tensor, out_hw: int = 224) -> torch.Tensor:
    """(B, 8, 8) → (B, out, out) bilinear upsample with half-pixel centers
    (``interpolate(..., align_corners=False)``, src/models/ET_haa.py:166-167).
    A bfloat16 input is resized as ``jax.image.resize`` resizes it: the
    weights rounded to bfloat16, rows contracted first, each contraction
    rounded."""
    if x8.dtype == torch.float32:
        return F.interpolate(x8[:, None], size=(out_hw, out_hw), mode="bilinear",
                             align_corners=False)[:, 0]
    w = resize_weights(x8.shape[1], out_hw, x8.device).to(x8.dtype)
    rows = torch.einsum("bij,ip->bpj", x8, w)
    return torch.einsum("bpj,jq->bpq", rows, w)


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
    """dL/dpred for ``upstream`` = dL/d(−NSS), by autograd through
    :func:`saliency_reductions_plain`: the per-pixel part of
    :func:`saliency_head_grad_plain`."""
    with torch.enable_grad():
        p = pred.detach().float().requires_grad_(True)
        neg_nss = saliency_reductions_plain(p, gt, nss_r)[0]
        (grad,) = torch.autograd.grad(neg_nss, p, upstream)
    return grad


def saliency_head_grad_plain(x8: torch.Tensor, gt: torch.Tensor,
                             upstream: torch.Tensor, nss_r: int = 0) -> torch.Tensor:
    """Plain version of :func:`saliency_head_grad`: dL/dx8 of the (N, 8, 8)
    head ``x8`` (float32 or bfloat16) for ``upstream`` = dL/d(−NSS) (N,) of
    the maps ``saliency_upsample(x8).float()`` against ``gt`` (N, H, W), in
    three steps: p, the upsampled prediction; dL/dp
    (:func:`saliency_nss_grad_plain`, rounded to the head's dtype as the
    backward of ``.float()`` rounds it); then the transpose of the
    upsample's contractions in the head's dtype, d_rows = dL/dp·wᵀ over
    the columns and dx8 = w·d_rows over the rows, with the resize weights
    w (rounded to bfloat16 for a bfloat16 head)."""
    hw = gt.shape[-1]
    w = resize_weights(x8.shape[1], hw, x8.device).to(x8.dtype)
    p = saliency_upsample(x8.detach(), hw).float()
    dp = saliency_nss_grad_plain(p, gt, upstream, nss_r).to(x8.dtype)
    d_rows = torch.einsum("bpq,jq->bpj", dp, w)
    return torch.einsum("bpj,ip->bij", d_rows, w)


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


def head_grad_blocks(n_items: int, n_sms: int) -> int:
    """Bands of rows an item is split into by the head-gradient kernel: the
    most of 32, 16 and 8 (7, 14 and 28 rows at 224 px) whose grid fits two
    blocks an SM, else 8. On the H100 that is 32 at N = 8, 16 at N = 16 and
    8 at N = 80 and 240, the fastest of the three at each (PERF.md)."""
    for blocks in (32, 16):
        if n_items * blocks <= 2 * n_sms:
            return blocks
    return 8


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
def _head_grad_kernel():
    lib = build.load("saliency_head_grad")
    fn = lib.saliency_head_grad_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _head_weights(dtype: torch.dtype, hw: int, device: torch.device) -> torch.Tensor:
    """The kernel's (8, hw) float32 weight table: :func:`resize_weights`,
    rounded to ``dtype``."""
    return resize_weights(8, hw, device).to(dtype).float().contiguous()


#: per (device, stream): the ticket counters of the head-gradient kernel,
#: zero between launches (each launch's last block resets its item's)
_tickets = {}


def _ticket_buffer(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _tickets.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _tickets[(dev, stream)] = buf
    return buf


def _stream(dev: torch.device) -> int:
    if dev.index == torch.cuda.current_device():
        return torch.cuda.current_stream().cuda_stream
    with torch.cuda.device(dev):
        return torch.cuda.current_stream().cuda_stream


def _check_map(name: str, t: torch.Tensor) -> None:
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


def _check_kernel_inputs(pred: torch.Tensor, gt: torch.Tensor) -> None:
    _check_map("pred", pred)
    _check_map("gt", gt)
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


def saliency_head_grad(x8: torch.Tensor, gt: torch.Tensor, stats: torch.Tensor,
                       upstream: torch.Tensor, nss_r: int = 0) -> torch.Tensor:
    """Launch the head-gradient kernel on the card: dL/dx8 (N, 8, 8), in
    ``x8``'s dtype (float32 or bfloat16), of the −NSS of the maps
    ``saliency_upsample(x8).float()`` against ``gt`` (N, H, W) float32, from
    the forward's (N, 8) ``stats`` and ``upstream`` = dL/d(−NSS) (N,), with
    :func:`head_grad_blocks` bands of rows an item. Counted in
    ``saliency_head_grad.launches``; raises on any input the kernel does not
    take and on a launch error."""
    return _head_grad_launch(x8, gt, stats, upstream, nss_r, None)


def _head_grad_launch(x8, gt, stats, upstream, nss_r, blocks):
    """:func:`saliency_head_grad` with ``blocks`` (8 to 32) bands an item,
    or :func:`head_grad_blocks`' with None (``tools/bench_saliency_grad.py``
    times each split)."""
    if x8.device.type != "cuda":
        raise ValueError(f"saliency head grad kernel: x8 on {x8.device}, expected CUDA")
    if x8.dtype not in (torch.float32, torch.bfloat16) or x8.dim() != 3 \
            or tuple(x8.shape[1:]) != (8, 8) or not x8.is_contiguous():
        raise ValueError(f"saliency head grad kernel: x8 is {tuple(x8.shape)} {x8.dtype} "
                         f"(contiguous: {x8.is_contiguous()}), expected contiguous "
                         "float32 or bfloat16 (N, 8, 8)")
    N = x8.shape[0]
    _check_map("gt", gt)
    hw = gt.shape[-1]
    if gt.shape != (N, hw, hw) or gt.device != x8.device or hw % 32 or hw > 256:
        raise ValueError(f"saliency head grad kernel: gt is {tuple(gt.shape)} on "
                         f"{gt.device}, expected ({N}, H, H) on {x8.device} with H a "
                         "multiple of 32 up to 256")
    for name, t, shape in (("stats", stats, (N, 8)), ("upstream", upstream, (N,))):
        if (t.device != x8.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"saliency head grad kernel: {name} is {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} (contiguous: "
                             f"{t.is_contiguous()}), expected contiguous float32 "
                             f"{shape} on {x8.device}")
    dev = x8.device
    if blocks is None:
        blocks = head_grad_blocks(N, _n_sms(dev.index))
    if not 8 <= blocks <= 32:
        raise ValueError(f"saliency head grad kernel: {blocks} blocks an item, expected 8-32")
    stream = _stream(dev)
    out = torch.empty_like(x8)
    partial = torch.empty((N, blocks, 64), dtype=torch.float32, device=dev)
    tickets = _ticket_buffer(dev, stream, N)
    err = _head_grad_kernel()(
        x8.data_ptr(), gt.data_ptr(), stats.data_ptr(), upstream.data_ptr(),
        _head_weights(x8.dtype, hw, dev).data_ptr(), out.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), N, hw, nss_r, int(x8.dtype == torch.bfloat16), blocks, stream)
    if err != 0:
        raise RuntimeError(f"saliency head grad kernel launch failed (N={N}, "
                           f"blocks {blocks}): CUDA error {err}")
    saliency_head_grad.launches += 1
    return out


saliency_head_grad.launches = 0


class _HeadReductions(torch.autograd.Function):
    """The upsample and the fused kernel as the forward,
    :func:`saliency_head_grad` as the backward of −NSS. Saves the head, the
    GT map and the stats row, not the full-resolution prediction."""

    @staticmethod
    def forward(ctx, x8, gt, nss_r):
        pred = saliency_upsample(x8, gt.shape[-1]).float()
        stats, neg_nss, valid, precision, recall = saliency_fused(pred, gt, nss_r)
        ctx.save_for_backward(x8, gt, stats)
        ctx.nss_r = nss_r
        ctx.mark_non_differentiable(pred, valid, precision, recall)
        # no zero gradient for pred: it would be an (N, H, W) buffer
        ctx.set_materialize_grads(False)
        return pred, neg_nss, valid, precision, recall

    @staticmethod
    def backward(ctx, _d_pred, d_neg_nss, *_):
        if d_neg_nss is None:
            return None, None, None
        x8, gt, stats = ctx.saved_tensors
        return saliency_head_grad(x8, gt, stats, d_neg_nss.contiguous(),
                                  ctx.nss_r), None, None


def saliency_reductions(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """NSS (negated, reference convention) + HA precision/recall from the
    fused stats. Returns (neg_nss (B,), valid (B,), precision (B,),
    recall (B,)). Matches ``ops.losses.nss_loss`` and the HA formulas. On the
    card one kernel launch computes all four; it has no backward there (the
    gradient of −NSS is :func:`saliency_head_reductions`'), so a ``pred``
    that requires a gradient raises. CPU tensors take
    :func:`saliency_reductions_plain`."""
    if pred.device.type == "cpu" and gt.device.type == "cpu":
        return saliency_reductions_plain(pred, gt, nss_r)
    if torch.is_grad_enabled() and pred.requires_grad:
        raise ValueError("saliency_reductions: pred requires a gradient; on the card "
                         "differentiate −NSS in the head with saliency_head_reductions")
    return saliency_fused(pred.contiguous(), gt.contiguous(), nss_r)[1:]


def saliency_head_reductions(x8: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """The saliency head's maps and their reductions: ``x8`` (N, 8, 8)
    float32 or bfloat16 is upsampled to ``gt``'s (N, H, W)
    (:func:`saliency_upsample`) and cast to float32, then reduced as
    :func:`saliency_reductions` reduces it. Returns (pred (N, H, W) float32,
    neg_nss, valid, precision, recall); only ``neg_nss`` carries a gradient,
    to ``x8``. On the card the forward launches the fused kernel once, and
    when ``x8`` requires a gradient the backward launches
    :func:`saliency_head_grad` once; CPU tensors take autograd through the
    upsample and :func:`saliency_reductions_plain`."""
    hw = gt.shape[-1]
    if x8.device.type == "cpu" and gt.device.type == "cpu":
        pred = saliency_upsample(x8, hw).float()
        return (pred.detach(), *saliency_reductions_plain(pred, gt, nss_r))
    x8, gt = x8.contiguous(), gt.detach().contiguous()
    if torch.is_grad_enabled() and x8.requires_grad:
        return _HeadReductions.apply(x8, gt, nss_r)
    pred = saliency_upsample(x8, hw).float()
    return (pred, *saliency_fused(pred, gt, nss_r)[1:])
