"""Frozen copy of the plain half of ``avdn_tpu_torch/ops/saliency.py``
(commit d6443de): the saliency head's upsample, the per-item statistics and
their −NSS / HA reductions, written as plain torch ops on every device. No
CUDA kernel: autograd differentiates −NSS through the upsample and the
plain reductions, on the card as on the CPU."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def saliency_stats(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return saliency_stats_plain(pred, gt)


def saliency_reductions(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    return saliency_reductions_plain(pred, gt, nss_r)


def saliency_head_reductions(x8: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """The head's maps and their reductions: (pred (N, H, W) float32,
    neg_nss, valid, precision, recall); only ``neg_nss`` carries a
    gradient, to ``x8``."""
    pred = saliency_upsample(x8, gt.shape[-1]).float()
    return (pred.detach(), *saliency_reductions_plain(pred, gt, nss_r))
