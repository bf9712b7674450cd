"""Generate an on-disk ANDH-format demo dataset (annotations + tif maps):
the port's copy of ``avdn_tpu/data/demo.py`` (for the same arguments it
writes the same JSON and the same ``.tif`` pixels).

The real xView GeoTIFF release ships separately from the reference repo;
this generator produces a tiny, structurally faithful stand-in — the same
``{split}_data.json`` schema the loader consumes (env.py:85-180 field
semantics: gt_path_corners, attention_list, gps bounds, lat/lng ratios) and
square-resizable ``.tif`` tiles — used by the test fixtures, the serving
benchmark, and as a no-assets smoke dataset for new users:

    python -m avdn_tpu_torch.data.demo --out ./demo_data
    python -m avdn_tpu_torch.cli.train_et --root_dir ./demo_data --iters 2 ...
"""

from __future__ import annotations

import json
import os

import numpy as np
import cv2

DEG_TO_M = 11.13e4


def make_view(center, edge_deg, heading_deg=0.0):
    h = edge_deg / 2
    base = np.array([[h, -h], [h, h], [-h, h], [-h, -h]], np.float64)
    th = -heading_deg / 180 * np.pi
    M = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    return base @ M.T + np.asarray(center, np.float64)


def write_demo_dataset(root, n_train=8, n_val=16, map_px=256, seed=0):
    """Create root/AVDN/{annotations,train_images} with synthetic data.
    Returns the root.

    The episode mix is designed so thresholded navigation metrics are
    EXERCISABLE, not vacuously zero: half of each split's episodes are
    "near-goal" (short 1-step paths whose destination view heavily overlaps
    the start view — a lightly-trained policy genuinely converts some into
    SR successes, the way the reference's released checkpoint succeeds on
    15-19% of real episodes, datasets/XVIEW/et_haa_test/logs/valid.txt:4,11)
    and half are "far" multi-step navigation episodes. Headings, view edges
    (zoom), per-step zoom drift, path lengths, and dialog-round counts all
    vary, so the round/length metric slices are populated."""
    rng = np.random.default_rng(seed)
    anno_dir = os.path.join(root, "AVDN", "annotations")
    img_dir = os.path.join(root, "AVDN", "train_images")
    os.makedirs(anno_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    lat_ratio = 2e-5
    lng_ratio = 2.4e-5
    for name in ("fixmapA", "fixmapB"):
        # original width such that square-pixel resize lands on map_px
        orig_w = int(round(map_px * lat_ratio / lng_ratio))
        img = rng.integers(0, 256, (map_px, orig_w, 3), np.uint8)
        cv2.imwrite(os.path.join(img_dir, name + ".tif"), img)

    botm_left = [32.0, -114.0]
    extent = map_px * lat_ratio
    top_right = [botm_left[0] + extent, botm_left[1] + extent]

    def make_items(n, start_ridx=0):
        items = []
        for i in range(n):
            near = i % 2 == 0  # half near-goal, half multi-step far episodes
            if near:
                edge = rng.uniform(50, 80) / DEG_TO_M
                n_steps = 2
                step_frac = rng.uniform(0.05, 0.2)
            else:
                edge = rng.uniform(60, 120) / DEG_TO_M
                n_steps = int(rng.integers(2, 5))
                step_frac = 0.8
            margin = 1.6 * edge
            c = np.array(botm_left) + rng.uniform(margin, extent - margin, 2)
            heading = float(rng.integers(0, 360))
            path = []
            step = rng.uniform(-1, 1, 2)
            step /= np.linalg.norm(step)
            for _k in range(n_steps):
                ek = edge * rng.uniform(0.9, 1.1)  # per-step zoom drift
                path.append(make_view(c, ek, heading).tolist())
                c = np.clip(c + step * edge * step_frac,
                            np.array(botm_left) + margin,
                            np.array(top_right) - margin)
            att = [[[float(c[0]), float(c[1])], int(rng.integers(10, 40))]]
            pre = ["[QUE] where should i go next? [INS] head north over the road."]
            if i % 3 == 0:  # vary dialog-round count (sr_1/sr_2 slices)
                pre.append("[QUE] am i close yet? [INS] keep going forward.")
            items.append(
                {
                    "map_name": "fixmapA" if i % 2 == 0 else "fixmapB",
                    "route_index": f"{start_ridx + i}_1",
                    "angle": heading + rng.uniform(-0.4, 0.4),
                    "gt_path_corners": path,
                    "instructions": f"Fly TOWARD the gray building number {i} [SEP]",
                    "pre_dialogs": pre,
                    "attention_list": att,
                    "lat_ratio": lat_ratio,
                    "lng_ratio": lng_ratio,
                    "gps_botm_left": botm_left,
                    "gps_top_right": top_right,
                    "destination": path[-1],
                }
            )
        return items

    for split, n in (("train", n_train), ("val_seen", n_val),
                     ("val_unseen", n_val), ("test_unseen", n_val)):
        with open(os.path.join(anno_dir, f"{split}_data.json"), "w") as f:
            json.dump(make_items(n), f)
    return root


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="dataset root to create")
    ap.add_argument("--n_train", type=int, default=8)
    ap.add_argument("--n_val", type=int, default=16)
    ap.add_argument("--map_px", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)
    write_demo_dataset(ns.out, ns.n_train, ns.n_val, ns.map_px, ns.seed)
    print(f"demo dataset written under {ns.out}/AVDN")


if __name__ == "__main__":  # pragma: no cover
    main()
