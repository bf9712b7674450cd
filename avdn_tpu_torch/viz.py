"""Visualisation — trajectory overlays + saliency heatmaps (host, OpenCV;
the port's copy of ``avdn_tpu/viz.py``).

Covers the reference's inference-time debug imagery
(src/xview_et/agent.py:694-706 saliency jpgs, :776-879 trajectory overlays).
OpenCV is imported where an image is drawn or written.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _to_px(pt, lat_ratio, extent_lat):
    """GPS offset (lat, lng) → (x, y) int pixel coords."""
    return (
        int(round(pt[1] / lat_ratio)),
        int(round((extent_lat - pt[0]) / lat_ratio)),
    )


def draw_trajectory_overlay(
    map_rgb: np.ndarray,
    record: Dict,
    lat_ratio: float,
    extent_lat: float,
    instructions: str = "",
) -> np.ndarray:
    """Draw the predicted path (view boxes + center track), the GT path, and
    per-step action/progress text onto a copy of the map (RGB uint8)."""
    import cv2

    img = np.ascontiguousarray(map_rgb.copy())

    # GT path in green
    gt = [np.asarray(c, np.float64) for c in record["gt_path_corners"]]
    for a, b in zip(gt[:-1], gt[1:]):
        cv2.line(img, _to_px(a.mean(0), lat_ratio, extent_lat),
                 _to_px(b.mean(0), lat_ratio, extent_lat), (0, 255, 0), 2)
    cv2.drawContours(
        img,
        [np.array([_to_px(p, lat_ratio, extent_lat) for p in gt[-1]])],
        0, (0, 255, 0), 2,
    )

    # predicted path: white view boxes + magenta center track
    path = [np.asarray(c[0], np.float64) for c in record["path_corners"]]
    centers = [c.mean(0) for c in path]
    for j, quad in enumerate(path):
        cv2.drawContours(
            img,
            [np.array([_to_px(p, lat_ratio, extent_lat) for p in quad])],
            0, (255, 255, 255), 1,
        )
        if j + 1 < len(centers):
            cv2.line(img, _to_px(centers[j], lat_ratio, extent_lat),
                     _to_px(centers[j + 1], lat_ratio, extent_lat),
                     (255, 0, 255), 3)
    for j, (act, prog) in enumerate(zip(record.get("actions", []),
                                        record.get("progress", []))):
        pos = _to_px(path[min(j, len(path) - 1)][0], lat_ratio, extent_lat)
        wp = np.asarray(act[0])
        txt = f"{j}: [{wp[0]:.2f},{wp[1]:.2f}] p={prog:.2f}"
        if j < len(record.get("gt_progress", [])):
            txt += f" gt={record['gt_progress'][j]:.2f}"
        cv2.putText(img, txt, pos, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
    if instructions:
        cv2.putText(img, instructions[:120], (20, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1,
                    cv2.LINE_AA)
    return img


def save_saliency_heatmaps(out_dir: str, tag: str, pred_sal: np.ndarray,
                           gt_sal: np.ndarray, view: Optional[np.ndarray] = None,
                           step: Optional[int] = None):
    """JET-colormap saliency dumps; with ``step``, filenames match the
    reference's ``..._pred_att_{t}.jpg`` scheme (agent.py:700-706)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    sfx = "" if step is None else f"_{step}"
    ps = np.clip(pred_sal, 0, 1)
    denom = ps.max() if ps.max() > 0 else 1.0
    cv2.imwrite(
        os.path.join(out_dir, f"{tag}_pred_att{sfx}.jpg"),
        cv2.applyColorMap(np.uint8(255 * ps / denom), cv2.COLORMAP_JET),
    )
    cv2.imwrite(
        os.path.join(out_dir, f"{tag}_gt_att{sfx}.jpg"),
        cv2.applyColorMap(np.uint8(255 * np.clip(gt_sal, 0, 1)), cv2.COLORMAP_JET),
    )
    if view is not None:
        cv2.imwrite(os.path.join(out_dir, f"{tag}_input{sfx}.jpg"),
                    np.uint8(np.clip(view, 0, 255))[:, :, ::-1])


def save_debug_overlays(pred_dir: str, env_name: str, preds: Dict[str, dict],
                        host_maps: Dict[str, np.ndarray],
                        items_by_id: Dict[str, dict]):
    """Write trajectory overlays for every prediction (inference mode,
    agent.py:873-875)."""
    import cv2

    out_dir = os.path.join(pred_dir, "debug_images")
    os.makedirs(out_dir, exist_ok=True)
    for instr_id, rec in preds.items():
        item = items_by_id.get(instr_id)
        if item is None:
            continue
        map_img = host_maps.get(item["map_name"])
        if map_img is None:
            continue
        extent_lat = item["gps_top_right"][0] - item["gps_botm_left"][0]
        img = draw_trajectory_overlay(
            map_img, rec, item["lat_ratio"], extent_lat,
            item.get("instructions", ""),
        )
        cv2.imwrite(
            os.path.join(out_dir, f"{env_name}val{instr_id}.jpg"),
            img[:, :, ::-1],
        )
