"""On-device view renderer — the "drone camera" (torch counterpart of
``avdn_tpu/sim/render.py``, exact mode).

Replaces the reference's per-sample host-side OpenCV pipeline
(``cv2.getPerspectiveTransform`` + ``cv2.warpPerspective`` per item per step,
src/env.py:254-332) with a batched formulation:

* a closed-form square→quad homography per item,
* an inverse-mapped 4-tap bilinear gather straight from the uint8 map bank
  slot ``map_idx`` (no per-item float copy of the map), constant-0 border,
* an *analytic* human-attention saliency: each output pixel's source
  coordinate is tested against the item's circle set directly (no raster,
  no second warp; per-item circles, PARITY.md #2).

Written in torch ops; a hand kernel for the render is queued (ROADMAP.md
queue 2 item 2).

Rounding: the JAX package runs this arithmetic through XLA, which contracts
``a * b + c`` into one fused multiply-add and turns ``i / 223`` into
``i * (1/223)``. The source coordinates are what the bilinear gather
amplifies (one float32 ulp of a coordinate moves a view pixel by up to
255·ulp), so they are evaluated here in the same order with the same
roundings (``geometry.transforms.fma``, exact through float64): the
coordinates of both packages agree bit for bit and the views to within
float32 rounding of the blend.
"""

from __future__ import annotations

import torch

from avdn_tpu_torch.geometry.transforms import fma

VIEW_HW = 224


def square_to_quad_homography(quad: torch.Tensor) -> torch.Tensor:
    """Closed-form homography mapping the UNIT square (corners (0,0), (1,0),
    (1,1), (0,1)) onto each ``quad`` (B, 4, 2). Returns (B, 3, 3).

    Equivalent to the 8x8 DLT solve (``cv2.getPerspectiveTransform``) but
    pure arithmetic — the classic projective-texture-mapping identity
    (Heckbert '89)."""
    p0, p1, p2, p3 = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    d1 = p1 - p2
    d2 = p3 - p2
    s = p0 - p1 + p2 - p3

    def cross(a, b):
        return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

    denom = cross(d1, d2)
    denom = torch.where(denom.abs() > 1e-20, denom, 1e-20)
    g = cross(s, d2) / denom
    h = cross(d1, s) / denom
    a_vec = fma(g[:, None], p1, p1 - p0)
    b_vec = fma(h[:, None], p3, p3 - p0)
    one = torch.ones_like(g)
    return torch.stack(
        [
            torch.stack([a_vec[:, 0], b_vec[:, 0], p0[:, 0]], dim=-1),
            torch.stack([a_vec[:, 1], b_vec[:, 1], p0[:, 1]], dim=-1),
            torch.stack([g, h, one], dim=-1),
        ],
        dim=1,
    )


def view_to_map_coords(src_quads: torch.Tensor, out_hw: int = VIEW_HW) -> torch.Tensor:
    """Continuous map-space (x, y) coordinates of every output pixel:
    (B, 4, 2) view-area corners in map image coords → (B, out, out, 2), the
    inverse perspective map that warpPerspective applies per pixel."""
    H = square_to_quad_homography(src_quads.float())  # (B, 3, 3)
    # i/(out-1) as XLA evaluates it: times the float32 reciprocal
    step = torch.tensor(1.0 / (out_hw - 1.0), dtype=torch.float32,
                        device=src_quads.device)
    positions = torch.arange(out_hw, dtype=torch.float32,
                             device=src_quads.device) * step
    ys, xs = torch.meshgrid(positions, positions, indexing="ij")
    xs = xs[None, :, :, None]
    ys = ys[None, :, :, None]
    Hb = H[:, None, None, :, :]  # (B, 1, 1, 3, 3): row k maps to output k
    # pts @ H.T with pts = (x, y, 1), accumulated term by term
    mapped = fma(ys, Hb[..., 1], xs * Hb[..., 0]) + Hb[..., 2]
    denom = mapped[..., 2:3]
    return mapped[..., :2] / torch.where(denom.abs() > 1e-12, denom, 1.0)


def saliency_at(coords: torch.Tensor, circles: torch.Tensor,
                n_circles: torch.Tensor) -> torch.Tensor:
    """Analytic GT-attention saliency.

    coords: (B, H, W, 2) map-space (x, y); circles: (B, C, 3) of
    (cx, cy, radius) in map pixels, padded with radius <= 0; n_circles (B,).
    Returns float32 (B, H, W) in {0, 1}: 1 where the source point falls
    inside any valid attention circle — the analytic equivalent of
    rasterise-then-warp (src/env.py:224-231, 292-293)."""
    idx = torch.arange(circles.shape[1], device=circles.device)
    valid = (idx[None, :] < n_circles[:, None]) & (circles[..., 2] > 0)
    hit = torch.zeros(coords.shape[:3], dtype=torch.bool, device=coords.device)
    x = coords[..., 0]
    y = coords[..., 1]
    for c in range(circles.shape[1]):  # C is small; avoids a (B,H,W,C) temp
        cx = circles[:, c, 0, None, None]
        cy = circles[:, c, 1, None, None]
        r = circles[:, c, 2, None, None]
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        hit |= (d2 <= r ** 2) & valid[:, c, None, None]
    return hit.float()


def render_batch(map_bank: torch.Tensor, map_idx: torch.Tensor,
                 src_quads_xy: torch.Tensor, circles: torch.Tensor,
                 n_circles: torch.Tensor, out_hw: int = VIEW_HW):
    """Batched exact renderer over a device-resident uint8 map bank.

    map_bank: (N, H, W, 3) uint8; map_idx: (B,); src_quads_xy: (B, 4, 2)
    map-image (x, y); circles: (B, C, 3); n_circles: (B,).
    Returns (views (B, out, out, 3) float32 on the 0–255 scale,
    saliency (B, out, out) float32).

    Corners are int-rounded first, like the reference (src/env.py:189-196,
    283-284); ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    coords = view_to_map_coords(torch.round(src_quads_xy), out_hw)
    Hm, Wm = map_bank.shape[1], map_bank.shape[2]
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    bidx = map_idx.long()[:, None, None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < Wm) & (yi >= 0) & (yi < Hm)
        val = map_bank[bidx, yi.clamp(0, Hm - 1), xi.clamp(0, Wm - 1)].float()
        return torch.where(inb[..., None], val, 0.0)

    views = (
        tap(x0i, y0i) * (1 - wx) * (1 - wy)
        + tap(x0i + 1, y0i) * wx * (1 - wy)
        + tap(x0i, y0i + 1) * (1 - wx) * wy
        + tap(x0i + 1, y0i + 1) * wx * wy
    )
    sal = saliency_at(coords, circles, n_circles)
    return views, sal
