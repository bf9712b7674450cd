"""Frozen copy of ``attention_circles`` from ``avdn_tpu_torch/data/maps.py``
(commit d6443de)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from reference.geometry.transforms import gps_to_img_coords_np


def attention_circles(item: dict, max_circles: int) -> Tuple[np.ndarray, int]:
    """Per-item GT attention circles in image coords ((cx, cy, radius),
    padded)."""
    circles = np.zeros((max_circles, 3), np.float32)
    att = item.get("attention_list", [])
    n = min(len(att), max_circles)
    for j in range(n):
        center_gps, radius = att[j][0], att[j][1]
        x, y = gps_to_img_coords_np(center_gps, item["gps_botm_left"],
                                    item["gps_top_right"], item["lat_ratio"])
        circles[j] = [x, y, float(radius)]
    return circles, n
