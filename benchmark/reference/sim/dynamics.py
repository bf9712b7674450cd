# Frozen copy of avdn_tpu_torch/sim/dynamics.py at commit d6443de, its imports pointed
# at the reference package.
"""View-area dynamics — the drone "simulator step" (torch counterpart of
``avdn_tpu/sim/dynamics.py``).

The reference duplicates this logic verbatim inside both agents as
``move_view_corners`` (src/xview_et/agent.py:285-384 ≡
src/xview_lstm/agent.py:274-373). Here it is one batched, branch-free
function over (B, 4, 2) corners.

Semantics (kept bit-faithful where supervision depends on them):
  1. **Zoom** — expand/shrink corners toward a target edge length
     (``altitude`` is encoded as the view edge length in meters, ∈ [40, 400]).
  2. **Rotate** — rotate corners by ``-angle`` about the centroid using the
     reference's π ≈ 3.14159 constant.
  3. **Move** — translate along the front-edge direction by ``distance``.
  Each stage aborts (keeping the previous stage's corners) if any corner
  would leave the map bounds; a zoom abort skips rotate+move entirely
  (reference src/xview_et/agent.py:332-341).

Coordinates are float32 GPS *offsets* from the map's bottom-left corner
(PARITY.md #7), so bounds checks are against ``(0, 0)``..``extent``.
"""

from __future__ import annotations

import torch

from reference.geometry.transforms import DEG_TO_M, get_direction

_PI_REF = 3.14159  # the reference's π (src/xview_et/agent.py:298)


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)) + 1e-20


def _change_corner(cs, change):
    """Zoom: push each corner away from both adjacent edges by ``change``
    (B, 1) (reference src/xview_et/agent.py:301-315)."""
    c0, c1, c2, c3 = cs[:, 0], cs[:, 1], cs[:, 2], cs[:, 3]
    n01 = (c0 - c1) / _norm(c1 - c0)
    n03 = (c0 - c3) / _norm(c3 - c0)
    n10 = (c1 - c0) / _norm(c1 - c0)
    n12 = (c1 - c2) / _norm(c2 - c1)
    n23 = (c2 - c3) / _norm(c2 - c3)
    n21 = (c2 - c1) / _norm(c2 - c1)
    n32 = (c3 - c2) / _norm(c2 - c3)
    n30 = (c3 - c0) / _norm(c3 - c0)
    return torch.stack(
        [
            c0 + (n01 + n03) * change,
            c1 + (n10 + n12) * change,
            c2 + (n23 + n21) * change,
            c3 + (n32 + n30) * change,
        ],
        dim=1,
    )


def _move_forward(cs, change):
    """Translate the view along its front edge normal (reference
    src/xview_et/agent.py:286-296). Corners 2/3 move along the *front*
    corners' vectors — preserving the reference exactly."""
    c0, c1, c2, c3 = cs[:, 0], cs[:, 1], cs[:, 2], cs[:, 3]
    f03 = (c0 - c3) / _norm(c3 - c0)
    f12 = (c1 - c2) / _norm(c2 - c1)
    return torch.stack(
        [c0 + f03 * change, c1 + f12 * change, c2 + f12 * change,
         c3 + f03 * change],
        dim=1,
    )


def _rotate_about(center, pts, angle_deg):
    """rotation_anticlock with the reference's constant
    (src/xview_et/agent.py:297-300), applied as ``-angle``."""
    theta = (-angle_deg / 180.0 * _PI_REF)[:, None]
    c = torch.cos(theta)
    s = torch.sin(theta)
    rel = pts - center[:, None, :]
    rot = torch.stack(
        [c * rel[..., 0] + s * rel[..., 1], -s * rel[..., 0] + c * rel[..., 1]],
        dim=-1,
    )
    return center[:, None, :] + rot


def _in_bounds(pts, extent):
    """Strict interior test against (0,0)..extent for all 4 corners."""
    ok = (pts > 0.0) & (pts < extent[:, None, :])
    return ok.flatten(1).all(dim=1)


def move_view_corners_batch(corners, angle, distance, altitude, extent,
                            input_current_direction):
    """Batched dynamics step.

    Args:
      corners: (B, 4, 2) GPS-offset corners (lat, lng) from map bottom-left.
      angle: (B,) rotation in degrees (caller pre-rounds as the reference).
      distance: (B,) forward move in GPS degrees.
      altitude: (B,) target edge length in meters (∈ [40, 400]).
      extent: (B, 2) map extent (top_right − botm_left) in degrees.
      input_current_direction: (B,) tracked heading in degrees.

    Returns: (new_corners (B, 4, 2), new_direction_deg (B,)).
    """
    corners = corners.float()
    current_direction = torch.remainder(
        torch.round(get_direction(corners.mean(dim=1),
                                  (corners[:, 0] + corners[:, 1]) / 2.0)),
        360.0,
    )
    # heading drift correction (reference src/xview_et/agent.py:318-320)
    drift = torch.abs(input_current_direction - current_direction) > 2.0
    angle = angle + torch.where(drift, input_current_direction, 0.0)

    def keep(ok, new, old):
        return torch.where(ok[:, None, None], new, old)

    # -------- Zoom --------
    edge_len_m = torch.linalg.vector_norm(corners[:, 1] - corners[:, 0],
                                          dim=-1) * DEG_TO_M
    zoom_change = (0.5 * (altitude - edge_len_m) / DEG_TO_M)[:, None]
    zoomed = _change_corner(corners, zoom_change)
    zoom_ok = _in_bounds(zoomed, extent)
    after_zoom = keep(zoom_ok, zoomed, corners)

    # -------- Rotate --------
    rotated = _rotate_about(after_zoom.mean(dim=1), after_zoom, angle)
    rot_ok = _in_bounds(rotated, extent)
    after_rot = keep(rot_ok, rotated, after_zoom)

    # -------- Move --------
    moved = _move_forward(after_rot, distance[:, None])
    move_ok = _in_bounds(moved, extent)
    after_move = keep(move_ok, moved, after_rot)

    # A zoom abort returns the ORIGINAL corners and unmodified heading
    # (reference src/xview_et/agent.py:339-340); a rotate abort keeps the
    # zoomed corners and unmodified heading (:362-363); a move abort keeps
    # the rotated corners but commits the heading (:381-384).
    new_corners = keep(zoom_ok, keep(rot_ok, after_move, after_zoom), corners)
    new_dir = torch.where(zoom_ok & rot_ok,
                          torch.remainder(current_direction + angle, 360.0),
                          current_direction)
    return new_corners, new_dir
