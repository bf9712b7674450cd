# Frozen copy of avdn_tpu_torch/sim/render.py at commit d6443de, its imports pointed
# at the reference package.
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
float32 rounding of the blend. That includes projective quads (the
homography's last row not (0, 0, 1)), where XLA computes ``pts @ H.T`` as a
dot over the batch and, at a batch of one or two quads, its small-matrix
kernel leaves some columns without an FMA (``_XLA_UNFUSED``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.geometry.transforms import fma

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


def unit_positions(out_hw: int, device, subsample: int = 1) -> torch.Tensor:
    """The unit-square sample positions of an ``out_hw`` pixel grid,
    ``i/(out-1)``, evaluated as XLA evaluates them (times the float32
    reciprocal). With ``subsample`` > 1, the out_hw/subsample coarse grid
    placed where a half-pixel-centred bilinear upscale reconstructs it:
    coarse pixel g sits at fine coordinate (g + 0.5)·s − 0.5."""
    step = torch.tensor(1.0 / (out_hw - 1.0), dtype=torch.float32, device=device)
    g = torch.arange(out_hw // subsample, dtype=torch.float32, device=device)
    if subsample > 1:
        g = (g + 0.5) * subsample - 0.5
    return g * step


#: the output columns of XLA's CPU dot ``(n², 3) @ (3, 3B)`` that its
#: small-matrix kernel computes without a fused multiply-add (products
#: rounded, then summed in order), for the only widths 3B ≤ 8 it has: B = 1
#: and 2. Every other column, and every column from B = 3 on, is
#: ``fma(y, h1, x·h0) + h2``. Read from jax/jaxlib 0.9.0's CPU backend on
#: x86-64 (the optimised HLO, and ``jnp.dot`` probed at widths 1–9): it is
#: a quirk of that code generator, kept on every device, the card included,
#: only so that the port's coordinates equal the JAX package's CPU
#: reference bit for bit. The key is the number of quads in one call, which
#: stands for the batch that JAX's dot spans; under the JAX package's
#: data-parallel layouts that is each device's share, which the port cannot
#: see. ``tests/test_torch_sim.py::test_render_projective_quads`` fails when
#: the reference's code generator changes.
_XLA_UNFUSED = {1: [[True, True, False]],
                2: [[True, True, True], [True, False, False]]}


def _xla_unfused_columns(n_quads: int, device):
    """(n_quads, 3) bool mask of the homography rows whose ``pts @ H.T``
    XLA's CPU backend accumulates without an FMA, or None (all fused)."""
    rows = _XLA_UNFUSED.get(n_quads)
    return None if rows is None else torch.tensor(rows, device=device)


def view_to_map_coords(src_quads: torch.Tensor, out_hw: int = VIEW_HW,
                       positions: torch.Tensor | None = None) -> torch.Tensor:
    """Continuous map-space (x, y) coordinates of every output pixel:
    (B, 4, 2) view-area corners in map image coords → (B, n, n, 2), the
    inverse perspective map that warpPerspective applies per pixel.
    ``positions`` (n,) overrides the unit-square sample positions (default
    the ``out_hw`` pixel grid). B is the batch the JAX package's dot spans:
    pass a whole batch's quads."""
    H = square_to_quad_homography(src_quads.float())  # (B, 3, 3)
    if positions is None:
        positions = unit_positions(out_hw, src_quads.device)
    ys, xs = torch.meshgrid(positions, positions, indexing="ij")
    xs = xs[None, :, :, None]
    ys = ys[None, :, :, None]
    Hb = H[:, None, None, :, :]  # (B, 1, 1, 3, 3): row k maps to output k
    # pts @ H.T with pts = (x, y, 1), accumulated term by term
    mapped = fma(ys, Hb[..., 1], xs * Hb[..., 0]) + Hb[..., 2]
    unfused = _xla_unfused_columns(H.shape[0], H.device)
    if unfused is not None:
        plain = (xs * Hb[..., 0] + ys * Hb[..., 1]) + Hb[..., 2]
        mapped = torch.where(unfused[:, None, None, :], plain, mapped)
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
                 n_circles: torch.Tensor, out_hw: int = VIEW_HW,
                 subsample: int = 1):
    """Batched exact renderer over a device-resident uint8 map bank.

    map_bank: (N, H, W, 3) uint8; map_idx: (B,); src_quads_xy: (B, 4, 2)
    map-image (x, y); circles: (B, C, 3); n_circles: (B,).
    Returns (views (B, out, out, 3) float32 on the 0–255 scale,
    saliency (B, out, out) float32).

    Corners are int-rounded first, like the reference (src/env.py:189-196,
    283-284); ``torch.round`` rounds half to even, as ``jnp.round`` does.

    ``subsample`` > 1 is the opt-in fast mode: the gather runs on an
    out_hw/subsample grid and views and saliency are upscaled bilinearly
    with half-pixel centres (``jax.image.resize``'s "bilinear" upscale, which
    ``F.interpolate(align_corners=False)`` computes). Not cv2-exact.
    """
    positions = (None if subsample == 1 else
                 unit_positions(out_hw, src_quads_xy.device, subsample))
    coords = view_to_map_coords(torch.round(src_quads_xy), out_hw, positions)
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
    if subsample > 1:
        views = F.interpolate(views.permute(0, 3, 1, 2), size=(out_hw, out_hw),
                              mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        sal = F.interpolate(sal[:, None], size=(out_hw, out_hw), mode="bilinear",
                            align_corners=False)[:, 0]
    return views, sal
