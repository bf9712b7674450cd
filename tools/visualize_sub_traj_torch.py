#!/usr/bin/env python
"""Offline ANDH dataset viewer (reference: datasets/visualize_sub_traj.py),
on the PyTorch port's data and geometry modules (the counterpart of
``tools/visualize_sub_traj.py``: it draws the same images).

Renders each sub-trajectory's GT path, view areas, attention circles, and a
compass rose onto its map tile. Writes JPGs by default; ``--interactive``
opens a cv2 window and pages with any key / ESC.

Usage:
  python tools/visualize_sub_traj_torch.py --anno_dir .../annotations \
      --dataset_dir .../train_images --split val_seen --out_dir ./viz
"""

import argparse
import os
import sys

import numpy as np
import cv2
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from avdn_tpu_torch.data.annotations import load_annotations  # noqa: E402
from avdn_tpu_torch.data.maps import load_map_image  # noqa: E402
from avdn_tpu_torch.geometry.transforms import gps_to_img_coords_np, get_direction  # noqa: E402
from avdn_tpu_torch.geometry.transforms import name_the_direction  # noqa: E402


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def draw_item(item, map_img):
    img = np.ascontiguousarray(map_img[:, :, ::-1].copy())  # RGB→BGR for cv2

    def px(gps):
        return gps_to_img_coords_np(
            gps, item["gps_botm_left"], item["gps_top_right"], item["lat_ratio"]
        )

    # attention circles
    for att in item.get("attention_list", []):
        cv2.circle(img, px(att[0]), int(att[1]), (0, 255, 255), 2)

    path = item["gt_path_corners"]
    centers = [np.asarray(c).mean(0) for c in path]
    for j, quad in enumerate(path):
        color = (0, 0, 255) if j == len(path) - 1 else (255, 255, 255)
        cv2.drawContours(img, [np.array([px(p) for p in np.asarray(quad)])],
                         0, color, 2)
        if j + 1 < len(centers):
            cv2.line(img, px(centers[j]), px(centers[j + 1]), (255, 0, 255), 3)
            ang = float(get_direction(_f32(centers[j]), _f32(centers[j + 1])))
            cv2.putText(img, f"{j}:{name_the_direction(ang)}", px(centers[j]),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 0), 1,
                        cv2.LINE_AA)

    # compass rose
    h = img.shape[0]
    cv2.arrowedLine(img, (60, h - 60), (60, h - 110), (255, 255, 255), 2)
    cv2.putText(img, "N", (52, h - 118), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (255, 255, 255), 2)
    cv2.putText(img, item["instructions"][:110], (20, 30),
                cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1, cv2.LINE_AA)
    return img


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--anno_dir", required=True)
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--split", default="val_seen")
    ap.add_argument("--out_dir", default="./viz_out")
    ap.add_argument("--limit", type=int, default=20)
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args(argv)

    data = load_annotations(args.anno_dir, [args.split])
    os.makedirs(args.out_dir, exist_ok=True)
    cache = {}
    for item in data[: args.limit]:
        name = item["map_name"]
        if name not in cache:
            cache[name] = load_map_image(
                os.path.join(args.dataset_dir, name + ".tif"),
                item["lng_ratio"], item["lat_ratio"],
            )
        img = draw_item(item, cache[name])
        if args.interactive:
            cv2.imshow("sub_traj", img)
            if cv2.waitKey(0) & 0xFF == 27:
                break
        else:
            out = os.path.join(args.out_dir,
                               f"{name}_{item['route_index']}.jpg")
            cv2.imwrite(out, img)
            print("wrote", out)


if __name__ == "__main__":
    main()
