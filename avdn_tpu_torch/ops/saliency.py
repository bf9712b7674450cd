"""Fused per-item saliency statistics (torch counterpart of
``avdn_tpu/ops/saliency_pallas.py``).

One pass over the (224, 224) predicted + GT saliency maps produces every
reduction the rollout needs — NSS moments (Σp, Σp²), the NSS numerator
(Σ z·fix via Σ p·fix), the fixation mass (Σ fix), and the human-attention
eval sums (Σ clip(p)·fix, Σ clip(p)) (reference formulas
src/xview_et/agent.py:256-270 and :683-691).

``saliency_stats`` launches the hand-written CUDA kernel
(``csrc/saliency_stats.cu``) for tensors on the card and takes the plain
version, ``saliency_stats_plain``, only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from avdn_tpu_torch.ops import build


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


def _check_kernel_inputs(pred: torch.Tensor, gt: torch.Tensor) -> None:
    for name, t in (("pred", pred), ("gt", gt)):
        if t.device.type != "cuda":
            raise ValueError(f"saliency_stats: {name} on {t.device}, "
                             "expected both maps on the same CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"saliency_stats: {name} is {t.dtype}, expected float32")
        if t.dim() != 3:
            raise ValueError(f"saliency_stats: {name} has shape "
                             f"{tuple(t.shape)}, expected (B, H, W)")
        if not t.is_contiguous():
            raise ValueError(f"saliency_stats: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"saliency_stats: {name} is not 16-byte aligned")
    if pred.shape != gt.shape or pred.device != gt.device:
        raise ValueError("saliency_stats: pred and gt differ in shape or "
                         f"device ({tuple(pred.shape)} on {pred.device} vs "
                         f"{tuple(gt.shape)} on {gt.device})")
    if (pred.shape[1] * pred.shape[2]) % 4:
        raise ValueError("saliency_stats: H*W must be a multiple of 4 "
                         "(float4 loads)")


def saliency_stats(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred, gt: (B, H, W) float32 → (B, 8) stats. On the card this launches
    the CUDA kernel (and counts the launch in ``saliency_stats.launches``);
    CPU tensors take :func:`saliency_stats_plain`."""
    if pred.device.type == "cpu" and gt.device.type == "cpu":
        return saliency_stats_plain(pred, gt)
    _check_kernel_inputs(pred, gt)
    lib = build.load("saliency_stats")
    fn = lib.saliency_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, W = pred.shape
    out = torch.empty((B, 8), dtype=torch.float32, device=pred.device)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream(pred.device).cuda_stream
        err = fn(pred.data_ptr(), gt.data_ptr(), out.data_ptr(), B, H * W,
                 stream)
    if err != 0:
        raise RuntimeError(f"saliency_stats kernel launch failed: CUDA error {err}")
    saliency_stats.launches += 1
    return out


saliency_stats.launches = 0


def saliency_reductions(pred: torch.Tensor, gt: torch.Tensor, nss_r: int = 0):
    """NSS (negated, reference convention) + HA precision/recall from the
    fused stats. Returns (neg_nss (B,), valid (B,), precision (B,),
    recall (B,)). Matches ``ops.losses.nss_loss`` and the HA formulas."""
    stats = saliency_stats(pred.float().contiguous(), gt.float().contiguous())
    return reductions_from_stats(stats, pred.shape[1] * pred.shape[2], nss_r)


def reductions_from_stats(s: torch.Tensor, n: int, nss_r: int = 0):
    """The tail of :func:`saliency_reductions`: (B, 8) stats of maps of
    ``n`` pixels → (neg_nss, valid, precision, recall)."""
    sum_p, sum_p2, sum_pg, sum_g, sum_pcg, sum_pc = s[:, :6].unbind(dim=1)
    mean = sum_p / n
    var = (sum_p2 - n * mean * mean) / (n - 1)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    # Σ z·g = (Σ p·g − mean·Σ g) / std
    z_dot = (sum_pg - mean * sum_g) / torch.where(std > 0, std, 1.0)
    if nss_r == 1:
        z_dot = z_dot / 2 + sum_g
    elif nss_r == -1:
        z_dot = z_dot / 2 - sum_g
    nss = z_dot / (sum_g + 0.001)
    valid = (sum_g > 0) & torch.isfinite(nss) & (std > 0)
    precision = torch.where(sum_pc > 0, sum_pcg / torch.clamp(sum_pc, min=1e-20), 0.0)
    recall = sum_pcg / torch.clamp(sum_g, min=1e-20)
    return -nss, valid, precision, recall
