"""Synthetic ANDH-style world generator for tests and benchmarks: the port's
copy of ``avdn_tpu/data/synthetic.py`` (for the same seed the same arrays),
its batch the port's ``EpisodeBatch`` on ``device``.

Builds a map bank plus episode batches with realistic geometry (GPS-offset
view quads, GT paths made of successive zoom/rotate/move steps, attention
circles) without needing the xView GeoTIFF assets. Scale constants mirror
the real dataset: view edges 40–400 m, maps a few km across, lat_ratio
≈ 5e-6 deg/px.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from avdn_tpu_torch.device import resolve_device
from avdn_tpu_torch.rollout.engine import EpisodeBatch

DEG_TO_M = 11.13e4


@dataclasses.dataclass
class SyntheticWorld:
    map_bank: np.ndarray          # (N, H, W, 3) uint8
    batch: "EpisodeBatch"
    episodes_meta: List[dict]


def _make_view(center, edge_deg, heading_deg):
    h = edge_deg / 2
    base = np.array([[h, -h], [h, h], [-h, h], [-h, -h]], np.float64)
    th = -heading_deg / 180 * np.pi
    M = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    return base @ M.T + np.asarray(center, np.float64)


def synthetic_world(
    batch_size: int = 4,
    n_maps: int = 2,
    map_px: int = 512,
    gt_steps: int = 5,
    max_gt_len: int = 8,
    max_circles: int = 6,
    lang_len: int = 16,
    lang_dim: int = 768,
    seed: int = 0,
    device=None,
) -> SyntheticWorld:
    """A map bank and a batch of ``batch_size`` episodes from ``seed``; the
    batch lies on ``device`` (the card unless the caller asks for the CPU),
    the bank stays a host array (``DeviceMapBank``'s loader takes maps from
    the host)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    # ≈2.2 m/px so even small test maps span several view widths
    # (real xView is ≈0.5 m/px over 2-4k px tiles)
    lat_ratio = 2e-5
    extent_deg = map_px * lat_ratio

    map_bank = rng.integers(0, 256, (n_maps, map_px, map_px, 3), np.uint8)

    start_corners = np.zeros((batch_size, 4, 2), np.float32)
    start_dir = np.zeros((batch_size,), np.float32)
    gt_corners = np.zeros((batch_size, max_gt_len, 4, 2), np.float32)
    gt_len = np.zeros((batch_size,), np.int32)
    circles = np.zeros((batch_size, max_circles, 3), np.float32)
    n_circles = np.zeros((batch_size,), np.int32)
    map_idx = rng.integers(0, n_maps, batch_size).astype(np.int32)
    meta = []

    for i in range(batch_size):
        edge_m = rng.uniform(60, 150)
        edge = edge_m / DEG_TO_M
        margin = 1.2 * edge
        center = rng.uniform(margin, extent_deg - margin, 2)
        heading = float(rng.integers(0, 360))
        v = _make_view(center, edge, heading)
        start_corners[i] = v
        start_dir[i] = heading

        # GT path: a few successive small moves in roughly one direction
        path = [v]
        c = center.copy()
        step_vec = rng.uniform(-1, 1, 2)
        step_vec /= np.linalg.norm(step_vec)
        n = int(rng.integers(3, gt_steps + 1))
        for _ in range(n - 1):
            c = np.clip(c + step_vec * edge * rng.uniform(0.5, 1.2),
                        margin, extent_deg - margin)
            path.append(_make_view(c, edge * rng.uniform(0.8, 1.2),
                                   heading + rng.uniform(-30, 30)))
        gt_len[i] = len(path)
        for j, p in enumerate(path):
            gt_corners[i, j] = p

        nc = int(rng.integers(1, max_circles))
        n_circles[i] = nc
        for j in range(nc):
            gcx = rng.uniform(0.2, 0.8) * map_px
            gcy = rng.uniform(0.2, 0.8) * map_px
            circles[i, j] = [gcx, gcy, rng.integers(10, 60)]

        meta.append(
            {
                "instr_id": f"synthetic_map{map_idx[i]}__{i}_1",
                "num_dia": int(rng.integers(1, 4)),
                "start_corners": start_corners[i].copy(),
                "start_dir": float(start_dir[i]),
                "gt_path_corners": [gt_corners[i, j].copy() for j in range(gt_len[i])],
                "valid": True,
            }
        )

    lang_feat = rng.normal(0, 0.5, (batch_size, lang_len, lang_dim)).astype(np.float32)
    lang_cls = rng.normal(0, 0.5, (batch_size, 49)).astype(np.float32)
    lang_mask = np.ones((batch_size, lang_len), bool)

    def dev(a):
        return torch.as_tensor(a).to(device)

    batch = EpisodeBatch(
        map_idx=dev(map_idx),
        start_corners=dev(start_corners),
        start_dir=dev(start_dir),
        extent=torch.full((batch_size, 2), extent_deg, dtype=torch.float32,
                          device=device),
        lat_ratio=torch.full((batch_size,), lat_ratio, dtype=torch.float32,
                             device=device),
        gt_corners=dev(gt_corners),
        gt_len=dev(gt_len),
        circles=dev(circles),
        n_circles=dev(n_circles),
        lang_feat=dev(lang_feat),
        lang_cls=dev(lang_cls),
        lang_mask=dev(lang_mask),
    )
    return SyntheticWorld(map_bank=map_bank, batch=batch, episodes_meta=meta)
