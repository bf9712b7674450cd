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
``geometry.transforms.fma``), and each output column of a pass has at most
two nonzero taps, so the float32 contraction is exact in any summation
order. In bf16 mode the weights (and pass A's result) are rounded to
bfloat16 and contracted in float32 — the products of two bfloat16 values
are exact in float32 — which is what the JAX package's bf16 × bf16 →
float32 einsums compute. On the CPU the bf16 mode runs in float32, as in
the JAX package.

The weights are materialised one chunk of lines at a time (64 source
columns in pass A, 56 output rows in pass B) for a group of items at most
``_WEIGHT_BUDGET`` elements large: a hand kernel that computes the two taps
in place is queued (ROADMAP.md queue 2).
"""

from __future__ import annotations

import math

import torch

from avdn_tpu_torch.geometry.transforms import fma
from avdn_tpu_torch.sim.render import (
    VIEW_HW,
    saliency_at,
    square_to_quad_homography,
    unit_positions,
    view_to_map_coords,
)

_MAX_VIEW_EDGE_M = 400.0  # altitude cap (reference agent.py:285-384 zoom clamp)
_DEG_TO_M = 11.13e4       # reference env.py metre conversion
#: Largest tent-weight tensor one contraction materialises (elements).
_WEIGHT_BUDGET = 2 ** 28


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
    yu = unit_positions(out_hw, H.device)[None]
    col = [[H[:, i, j, None] for j in range(3)] for i in range(3)]
    p = fma(col[0][1], yu, col[0][2])
    q = col[0][0]
    r = fma(col[2][1], yu, torch.ones_like(yu))
    s = col[2][0]
    pp = fma(col[1][1], yu, col[1][2])
    qp = col[1][0]
    den = fma(s, p, -(q * r))
    den = torch.where(den.abs() > 1e-12, den,
                      torch.where(den >= 0, 1e-12, -1e-12))
    a = fma(pp, s, -(qp * r)) / den
    b = fma(qp, p, -(pp * q)) / den
    return a, b


def _tent(positions: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """Linear-interpolation weights ``W[..., m, l] = max(0, 1 − |l −
    pos[..., m]|)`` for l in [0, length), in float32 (rounded through
    ``dtype``). A position fully outside [−1, length] gives an all-zero row:
    the constant-0 border. Built in place: one tensor of the weights'
    size."""
    l_idx = torch.arange(length, dtype=torch.float32, device=positions.device)
    w = positions[..., None] - l_idx
    w.abs_().neg_().add_(1.0).clamp_(min=0.0)
    if dtype != torch.float32:
        w = w.to(dtype).float()
    return w


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
                chunk_a: int, chunk_b: int, dtype) -> torch.Tensor:
    """Two-pass warp of a group of items (quads rounded, (N, 4, 2) map
    x, y). Returns views (N, out, out, 3) float32."""
    N = quads.shape[0]
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
    I = torch.empty((N, crop_hw, out_hw, 3), dtype=torch.float32,
                    device=quads.device)
    for lo in range(0, crop_hw, chunk_a):
        cols = crop[:, :, lo:lo + chunk_a].permute(0, 2, 1, 3).float()  # (N, x, h, c)
        I[:, lo:lo + chunk_a] = torch.matmul(
            _tent(posA[:, lo:lo + chunk_a], crop_hw, dtype), cols)
    if dtype != torch.float32:
        I = I.to(dtype).float()

    # ---- pass B: out[v, u, c] = Σ_x WB[v, u, x] · I[x, v, c] ----
    out = torch.empty((N, out_hw, out_hw, 3), dtype=torch.float32,
                      device=quads.device)
    for lo in range(0, out_hw, chunk_b):
        rows = I[:, :, lo:lo + chunk_b].permute(0, 2, 1, 3)             # (N, v, x, c)
        out[:, lo:lo + chunk_b] = torch.matmul(
            _tent(posB[:, lo:lo + chunk_b], crop_hw, dtype), rows)
    return out


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
            "band=True is the JAX package's benchmark-only banded warp, reached "
            "only from its tools (ROADMAP.md queue 1 item 15)")
    quads = torch.round(src_quads_xy.float())
    if bf16 and map_bank.device.type == "cpu":
        bf16 = False  # the JAX package's CPU rule (warp2pass.py:315-316)
    dtype = torch.bfloat16 if bf16 else torch.float32
    crop_hw = -(-crop_hw // chunk) * chunk
    max_crop = min(map_bank.shape[1], map_bank.shape[2])
    if crop_hw > max_crop:
        crop_hw = max(chunk, (max_crop // chunk) * chunk)
    # pass-B chunk: the largest divisor of out_hw ≤ chunk (224 → 56)
    chunk_b = max(d for d in range(1, chunk + 1) if out_hw % d == 0)

    per_item = max(chunk, chunk_b) * crop_hw * out_hw
    group = max(1, _WEIGHT_BUDGET // per_item)
    views = torch.cat([
        _warp_group(map_bank, map_idx[lo:lo + group], quads[lo:lo + group],
                    crop_hw, out_hw, chunk, chunk_b, dtype)
        for lo in range(0, quads.shape[0], group)])
    sal = saliency_at(view_to_map_coords(quads, out_hw), circles, n_circles)
    return views, sal
