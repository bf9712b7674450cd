# Frozen copy of avdn_tpu_torch/ops/losses.py at commit d6443de, its imports pointed
# at the reference package.
"""Loss ops for the HAA rollout (torch counterpart of ``avdn_tpu/ops/losses.py``).

All formulas preserve the reference's conventions exactly
(src/xview_et/agent.py:256-270 NSS; :663-669 the four summed MSE terms) —
constants like π≈3.14159 and the ``+0.001`` fixation-sum guard matter for
checkpoint parity.
"""

from __future__ import annotations

import torch

_PI_REF = 3.14159


def nss_loss(pred_sal: torch.Tensor, gt_sal: torch.Tensor, nss_r: int = 0):
    """Per-item negative Normalized Scanpath Saliency.

    pred_sal, gt_sal: (B, H, W). Returns (B,) ``-NSS`` per item plus a
    validity mask (items with an empty fixation map or NaN are excluded the
    way the reference skips them, agent.py:676-681). ``z()`` uses the
    *unbiased* std (torch.std default); ``nss_r`` selects the reference's
    normalisation variants (agent.py:259-264).
    """
    B = pred_sal.shape[0]
    flat = pred_sal.reshape(B, -1)
    fix = gt_sal.reshape(B, -1)
    m = flat.mean(dim=1, keepdim=True)
    var = ((flat - m) ** 2).sum(dim=1, keepdim=True) / (flat.shape[1] - 1)
    z = (flat - m) / torch.sqrt(var)
    if nss_r == 1:
        z = z / 2 + 1
    elif nss_r == -1:
        z = z / 2 - 1
    nss = (z * fix).sum(dim=1) / (fix.sum(dim=1) + 0.001)
    valid = (fix.sum(dim=1) > 0) & torch.isfinite(nss)
    return -nss, valid


def heading_of(wp: torch.Tensor, eps=0.0) -> torch.Tensor:
    """Waypoint → normalised heading in [0, 1):
    ``(atan2(x, y + eps) / 3.14159 + 2) / 2 % 1`` (agent.py:666-667, :745)."""
    return torch.remainder(
        (torch.atan2(wp[..., 0], wp[..., 1] + eps) / _PI_REF + 2.0) / 2.0, 1.0)


def step_losses(pred_wp, pred_alt, pred_prog, gt_wp, gt_alt, gt_prog,
                heading_eps):
    """The four summed-MSE supervision terms of one rollout step
    (agent.py:663-669). Sum-reduction over the whole batch — the reference
    accumulates over *all* items each step, including already-ended ones.
    ``heading_eps`` (B,) is the reference's 1e-5·rand jitter on atan2's y.
    Returns a scalar tensor."""
    l_wp = torch.sum((pred_wp - gt_wp) ** 2)
    l_head = torch.sum((heading_of(pred_wp, heading_eps) - heading_of(gt_wp)) ** 2)
    l_alt = torch.sum((pred_alt - gt_alt) ** 2)
    l_prog = torch.sum((pred_prog - gt_prog) ** 2)
    return l_wp + l_head + l_alt + l_prog
