"""Coordinate transforms and direction math (torch counterpart of
``avdn_tpu/geometry/transforms.py``).

Ports the task-defining scalar conventions of the reference exactly —
including its idiosyncratic degree conversion constant ``/1.57*90`` — because
downstream supervision targets depend on them (reference src/env.py:48-84,
src/env.py:189-196).
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted multiply-add
    rounds it: the float64 product of two float32 values is exact, so only
    the sum rounds (to float64, then to float32 — the same result as a
    hardware FMA except on exact ties)."""
    return (a.double() * b.double() + c.double()).float()


#: GPS degrees → meters scale used throughout the reference (src/env.py:339).
DEG_TO_M = 11.13e4


def get_direction(start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Compass angle (N=0°, E=90°) of the GPS vector start→end, on
    (..., 2) tensors. Exact port of the reference formula (src/env.py:48-66),
    including the approximate radian→degree factor ``arctan(x)/1.57*90`` and
    the tie handling for vec[1] == 0."""
    vec = end - start
    v0, v1 = vec[..., 0], vec[..., 1]
    base = torch.atan(v0 / torch.where(v1 == 0, torch.ones_like(v1), v1)) / 1.57 * 90.0
    side = torch.where(torch.sign(v0) == 1, 90.0, 270.0).to(base.dtype)
    angle = torch.where(v1 > 0, base, torch.where(v1 < 0, base + 180.0, side))
    return torch.remainder(360.0 - angle + 90.0, 360.0)


def name_the_direction(angle: float) -> str:
    """Compass name for an angle in degrees (reference src/env.py:68-84)."""
    angle = float(angle)
    if angle > 337.5 or angle < 22.5:
        return "north"
    if abs(angle - 45) <= 22.5:
        return "northeast"
    if abs(angle - 135) <= 22.5:
        return "southeast"
    if abs(angle - 90) <= 22.5:
        return "east"
    if abs(angle - 180) <= 22.5:
        return "south"
    if abs(angle - 315) <= 22.5:
        return "northwest"
    if abs(angle - 225) <= 22.5:
        return "southwest"
    if abs(angle - 270) <= 22.5:
        return "west"
    return "unknown"


def gps_to_img_coords_np(gps, gps_botm_left, gps_top_right, lat_ratio):
    """Host-side (float64) GPS (lat, lng) → the reference's ``(x, y)`` int
    pixel tuple (src/env.py:189-196)."""
    return (
        int(round((gps[1] - gps_botm_left[1]) / lat_ratio)),
        int(round((gps_top_right[0] - gps[0]) / lat_ratio)),
    )
