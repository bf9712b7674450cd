"""The benchmark's inputs, made from ``--seed``: seeded aerial maps and
ANDH-format items.

Frozen from ``chip_smoke.py`` ``make_maps`` / ``make_items`` (commit
d6443de), generalised to a traffic file's map and item counts; the maps are
drawn on the device in a few large calls. Both the port and the reference
take the same items and maps; the port reads the items as annotation JSON
(its own loader normalises them), the reference through its own copy of
that loader.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

LAT_RATIO = 5e-6  # degrees per pixel (xView-like ground sampling)
DEG_TO_M = 11.13e4


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (weights, maps, items, arrivals, ...)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, purpose]).generate_state(
        1, np.uint64)[0]) >> 1


def make_maps(seed: int, n_maps: int, map_px: int, device) -> dict:
    """``n_maps`` RGB uint8 (map_px, map_px, 3) maps on the host, drawn on
    ``device``: a smooth random field (upsampled from a 32 × 32 grid) plus
    fine texture, like aerial imagery at ~0.5 m/px. Keyed by map name."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    coarse = torch.rand((n_maps, 3, 32, 32), generator=g, device=device) * 200 + 20
    fine = torch.rand((n_maps, 3, map_px, map_px), generator=g, device=device) * 40 - 20
    field = F.interpolate(coarse, size=(map_px, map_px), mode="bilinear",
                          align_corners=False)
    maps = (field + fine).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return {map_name(k): np.ascontiguousarray(maps[k]) for k in range(n_maps)}


def map_name(k: int) -> str:
    return f"bench_map_{k}"


def make_items(seed: int, n_items: int, n_maps: int, map_px: int, prefix: str = "") -> list:
    """``n_items`` ANDH-format items over ``n_maps`` maps: view edges of
    40–400 m, 2–5 step GT paths, 1–3 attention circles, one or two dialog
    rounds (``pre_dialogs`` a list, as the release stores it)."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    extent = map_px * LAT_RATIO
    items = []
    for i in range(n_items):
        k = i % n_maps
        botm_left = [30.0 + 0.1 * k, -115.0 + 0.1 * k]
        top_right = [botm_left[0] + extent, botm_left[1] + extent]
        edge = rng.uniform(40.0, 400.0) / DEG_TO_M
        margin = 0.8 * edge  # the view (half-diagonal 0.71 edge) stays inside
        c = np.array(botm_left) + rng.uniform(margin, extent - margin, 2)
        heading = float(rng.integers(0, 360))
        step = rng.uniform(-1, 1, 2)
        step /= np.linalg.norm(step)
        path = []
        for _ in range(int(rng.integers(2, 6))):
            h = edge * rng.uniform(0.9, 1.1) / 2
            base = np.array([[h, -h], [h, h], [-h, h], [-h, -h]])
            th = -heading / 180 * np.pi
            rot = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
            path.append((base @ rot.T + c).tolist())
            c = np.clip(c + step * edge * 0.6, np.array(botm_left) + margin,
                        np.array(top_right) - margin)
        att = [[[float(c[0] + rng.uniform(-1, 1) * edge / 4),
                 float(c[1] + rng.uniform(-1, 1) * edge / 4)],
                int(rng.integers(10, 60))] for _ in range(int(rng.integers(1, 4)))]
        pre = ["[QUE] where should i go next? [INS] head north over the road."]
        if i % 3 == 0:
            pre.append("[QUE] am i close yet? [INS] keep going past the lot.")
        items.append({
            "map_name": map_name(k),
            "route_index": f"{prefix}{i}_1",
            "angle": heading + rng.uniform(-0.4, 0.4),
            "gt_path_corners": path,
            "instructions": f"Fly toward the gray building number {i} [SEP]",
            "pre_dialogs": pre,
            "attention_list": att,
            "lat_ratio": LAT_RATIO,
            "lng_ratio": LAT_RATIO,
            "gps_botm_left": botm_left,
            "gps_top_right": top_right,
            "destination": path[-1],
        })
    return items


def write_annotations(root: str, splits: dict) -> str:
    """``{split: items}`` as ``<root>/AVDN/annotations/<split>_data.json``
    (the layout the port's ``--root_dir`` names); returns ``root``."""
    anno = os.path.join(root, "AVDN", "annotations")
    os.makedirs(anno, exist_ok=True)
    os.makedirs(os.path.join(root, "AVDN", "train_images"), exist_ok=True)
    for split, items in splits.items():
        with open(os.path.join(anno, f"{split}_data.json"), "w") as f:
            json.dump(items, f)
    return root
