# Frozen copy of avdn_tpu_torch/sim/warp2pass.py at commit d6443de, its imports pointed
# at the reference package.
"""Two-pass perspective warp — the full-resolution fast render mode (torch
counterpart of ``avdn_tpu/sim/warp2pass.py``, the eval and serving default).

For a homography H mapping the unit output square onto the source quad, the
iso-rows of the output (fixed v) map to *straight lines* in the source:
``sy = a(v)·sx + b(v)`` (``_iso_row_coeffs``). Hence two 1-D resampling
passes, each a contraction against tent (linear-interpolation) weights:

* **pass A** (vertical): every source column x of the crop is resampled at
  ``Y(v, x) = a(v)·x + b(v)`` → intermediate I[x, v];
* **pass B** (horizontal): every output row v resamples I[:, v] at
  ``X(u, v)``, the x-component of the inverse map → out[v, u].

A tent tap outside the crop contributes zero, which is cv2's constant-0
border. When the output u axis maps closer to source y (headings near
90°/270°) the source axes are swapped (a transposed crop), which keeps
|a(v)| ≤ ~1. Not bit-equal to the single-pass bilinear gather (the blend
runs along the slightly rotated iso-row axis); the saliency is the exact
analytic one on the unswapped grid.

The source window is a fixed ``crop_hw`` square sliced around the quad:
views larger than the crop render black beyond it, so ``crop_hw`` comes
from the dataset's finest ``lat_ratio`` (``auto_render_crop``).

Numerics. The tent weights are built from the same float32 positions as the
JAX package's (its contracted multiply-adds rounded once, through
``geometry.transforms.fma``), and each output of a pass has at most two
nonzero taps, ⌊pos⌋ and ⌊pos⌋ + 1: the port gathers those two and adds
their products (``_taps``) instead of contracting the dense weights as the
JAX einsums do. In bf16 mode the weights (and pass A's result) are rounded
to bfloat16 and the products of two bfloat16 values (or of one and a uint8
pixel) are exact in float32, so the sum of the two is rounded once, as in
the JAX package's bf16 × bf16 → float32 einsums, in any order. In float32
(the CPU, where the bf16 mode runs float32 as in the JAX package) each
product rounds and the sum may differ from a contraction's by an ulp.
A hand kernel for the two taps is queued (ROADMAP.md queue 2).
"""

from __future__ import annotations

import math

import torch

from reference.geometry.transforms import fma
from reference.sim.render import (
    VIEW_HW,
    saliency_at,
    square_to_quad_homography,
    unit_positions,
    view_to_map_coords,
)

_MAX_VIEW_EDGE_M = 400.0  # altitude cap (reference agent.py:285-384 zoom clamp)
_DEG_TO_M = 11.13e4       # reference env.py metre conversion


def auto_render_crop(min_lat_ratio: float) -> int:
    """Crop window (px) that contains ANY view the dynamics can produce on a
    map with ``lat_ratio >= min_lat_ratio``: the largest view edge is 400 m
    (the altitude cap) and its rotated bounding box spans edge·√2; plus a
    small bilinear-tap margin, rounded up to a multiple of 64."""
    edge_px = _MAX_VIEW_EDGE_M / (min_lat_ratio * _DEG_TO_M)
    need = edge_px * math.sqrt(2.0) + 4
    return max(256, -(-int(math.ceil(need)) // 64) * 64)


def _iso_row_coeffs(H: torch.Tensor, out_hw: int):
    """Per-output-row source-line coefficients (a(v), b(v)): sy = a·sx + b,
    for each item's (3, 3) ``H``; both (N, out).

    For fixed unit-square y: sx = (q·u + p)/(s·u + r), sy = (q'·u + p')/
    (s·u + r) share the denominator; eliminating u:
    sy = [(p'·s − q'·r)·sx + (q'·p − p'·q)] / (s·p − q·r)."""
    col = [[H[:, i, j, None] for j in range(3)] for i in range(3)]
    if H.shape[0] == 1:
        # a lone item's entries are scalars to XLA, which folds the
        # positions' 1/(out − 1) into them: h·yu is computed i·(h/(out − 1))
        # (jax/jaxlib 0.9.0's CPU backend; kept on every device only for
        # bit-parity with that reference, like render._XLA_UNFUSED)
        step = torch.tensor(1.0 / (out_hw - 1.0), dtype=torch.float32, device=H.device)
        idx = torch.arange(out_hw, dtype=torch.float32, device=H.device)[None]

        def line(h, c0):
            return fma(idx, h * step, c0)
    else:
        yu = unit_positions(out_hw, H.device)[None]

        def line(h, c0):
            return fma(h, yu, c0)
    p = line(col[0][1], col[0][2])
    q = col[0][0]
    r = line(col[2][1], torch.ones_like(p))
    s = col[2][0]
    pp = line(col[1][1], col[1][2])
    qp = col[1][0]
    den = fma(s, p, -(q * r))
    den = torch.where(den.abs() > 1e-12, den,
                      torch.where(den >= 0, 1e-12, -1e-12))
    a = fma(pp, s, -(qp * r)) / den
    b = fma(qp, p, -(pp * q)) / den
    return a, b


def _taps(lines: torch.Tensor, positions: torch.Tensor, dtype) -> torch.Tensor:
    """Linear interpolation of each line at its positions: ``out[..., m, c]
    = Σ_l W[..., m, l] · lines[..., l, c]`` for the tent weights ``W[..., m,
    l] = max(0, 1 − |l − pos[..., m]|)``, l in [0, L) (a position fully
    outside [−1, L] gives 0: the constant-0 border), evaluated on the only
    two taps a position has, ⌊pos⌋ and ⌊pos⌋ + 1, with each weight computed
    as the dense float32 tent computes it (rounded through ``dtype``).
    ``lines`` (..., L, C), ``positions`` (..., M) → (..., M, C) float32."""
    L = lines.shape[-2]
    lo = torch.floor(positions)
    out = None
    for tap in (lo, lo + 1.0):
        w = (1.0 - (positions - tap).abs()).clamp(min=0.0)
        if dtype != torch.float32:
            w = w.to(dtype).float()
        inside = (tap >= 0) & (tap < L)
        idx = torch.where(inside, tap, 0.0).long()[..., None]
        v = torch.gather(lines, -2, idx.expand(*idx.shape[:-1], lines.shape[-1]))
        v = v.float() * torch.where(inside, w, 0.0)[..., None]
        out = v if out is None else out + v
    return out


def _crops(map_bank, map_idx, y0, x0, swap, crop_hw: int):
    """Each item's ``crop_hw`` square window (N, crop, crop, 3) uint8: rows
    from ``y0``, columns from ``x0`` — of the transposed map where ``swap``.
    The map-row and map-column starts are clamped into the map, as
    ``lax.dynamic_slice`` clamps them; one gather, whose index order is
    swapped per item."""
    Hm, Wm = map_bank.shape[1], map_bank.shape[2]
    ar = torch.arange(crop_hw, device=map_bank.device)
    sw = swap[:, None, None]
    r0 = torch.where(swap, x0, y0).clamp(0, Hm - crop_hw)[:, None, None]
    c0 = torch.where(swap, y0, x0).clamp(0, Wm - crop_hw)[:, None, None]
    i, j = ar[None, :, None], ar[None, None, :]
    return map_bank[map_idx.long()[:, None, None],
                    r0 + torch.where(sw, j, i), c0 + torch.where(sw, i, j)]


def _warp_group(map_bank, map_idx, quads, crop_hw: int, out_hw: int,
                dtype) -> torch.Tensor:
    """Two-pass warp of a batch of items (quads rounded, (N, 4, 2) map
    x, y). Returns views (N, out, out, 3) float32."""
    Hm, Wm = map_bank.shape[1], map_bank.shape[2]

    # ---- rotation-degeneracy swap: keep the u axis closer to source x ----
    edge = quads[:, 1] - quads[:, 0]
    swap = edge[:, 0].abs() < edge[:, 1].abs()
    quad_sw = torch.where(swap[:, None, None], quads.flip(-1), quads)
    H3 = square_to_quad_homography(quad_sw)

    # ---- fixed-size crop around the quad (swapped source = transposed) ----
    src_h = torch.where(swap, Wm, Hm)
    src_w = torch.where(swap, Hm, Wm)
    mins = quad_sw.min(dim=1).values
    zero = torch.zeros_like(src_h)
    y0 = torch.clamp(torch.floor(mins[:, 1]).long() - 1, min=zero,
                     max=torch.clamp(src_h - crop_hw, min=0))
    x0 = torch.clamp(torch.floor(mins[:, 0]).long() - 1, min=zero,
                     max=torch.clamp(src_w - crop_hw, min=0))
    crop = _crops(map_bank, map_idx, y0, x0, swap, crop_hw)

    # ---- per-line sample positions, crop-relative ----
    a, b = _iso_row_coeffs(H3, out_hw)                               # (N, out)
    x_abs = x0[:, None].float() + torch.arange(crop_hw, dtype=torch.float32,
                                               device=quads.device)
    posA = fma(x_abs[:, :, None], a[:, None, :], b[:, None, :]) \
        - y0.float()[:, None, None]                                  # (N, x, v)
    posB = view_to_map_coords(quad_sw, out_hw)[..., 0] \
        - x0.float()[:, None, None]                                  # (N, v, u)

    # ---- pass A: I[x, v, c] = Σ_h WA[x, v, h] · crop[h, x, c] ----
    I = _taps(crop.permute(0, 2, 1, 3), posA, dtype)                # (N, x, v, c)
    if dtype != torch.float32:
        I = I.to(dtype).float()
    # ---- pass B: out[v, u, c] = Σ_x WB[v, u, x] · I[x, v, c] ----
    return _taps(I.permute(0, 2, 1, 3), posB, dtype)                 # (N, v, u, c)


def render_batch_twopass(map_bank: torch.Tensor, map_idx: torch.Tensor,
                         src_quads_xy: torch.Tensor, circles: torch.Tensor,
                         n_circles: torch.Tensor, out_hw: int = VIEW_HW,
                         crop_hw: int = 512, chunk: int = 64, bf16: bool = True,
                         band: bool = False):
    """Drop-in fast replacement for ``render.render_batch``: the
    full-resolution two-pass warp plus the exact analytic saliency.

    map_bank: (M, H, W, 3) uint8; map_idx: (B,); src_quads_xy: (B, 4, 2)
    map-image (x, y); circles: (B, C, 3); n_circles: (B,). ``crop_hw`` is
    rounded up to a multiple of ``chunk`` and clamped to the bank's map
    size. ``bf16`` rounds the tent weights and the intermediate to bfloat16
    on the card (float32 on the CPU). Returns (views (B, out, out, 3)
    float32 on the 0–255 scale, saliency (B, out, out) float32)."""
    if band:
        raise NotImplementedError(
            "band=True has no counterpart in the port: the JAX package's banded "
            "warp tiles its dense tent contraction, and the port's two-pass warp "
            "gathers two taps per sample (_taps), which leaves no contraction "
            "to band")
    quads = torch.round(src_quads_xy.float())
    if bf16 and map_bank.device.type == "cpu":
        bf16 = False  # the JAX package's CPU rule (warp2pass.py:315-316)
    dtype = torch.bfloat16 if bf16 else torch.float32
    crop_hw = -(-crop_hw // chunk) * chunk
    max_crop = min(map_bank.shape[1], map_bank.shape[2])
    if crop_hw > max_crop:
        crop_hw = max(chunk, (max_crop // chunk) * chunk)
    views = _warp_group(map_bank, map_idx, quads, crop_hw, out_hw, dtype)
    sal = saliency_at(view_to_map_coords(quads, out_hw), circles, n_circles)
    return views, sal
