"""Frozen copy of ``Navigator._normalize_item`` from ``avdn_tpu_torch/serve.py``
(commit d6443de): a served item as the serving entry normalises it."""

from __future__ import annotations

import numpy as np


def normalize_item(item: dict) -> dict:
    """Accept raw ANDH items; fill the GT-only fields serving doesn't
    need (losses are off) so the batcher's static shapes hold."""
    it = dict(item)
    it.setdefault("route_index", "0_1")
    it["angle"] = round(float(it["angle"])) % 360
    it["instructions"] = str(it["instructions"]).lower()
    pd = it.get("pre_dialogs", "")
    it["pre_dialogs"] = (" ".join(pd) if isinstance(pd, list) else str(pd)).lower()
    start = np.asarray(it["gt_path_corners"][0] if it.get("gt_path_corners")
                       else it["start_corners"], np.float64)
    it["gt_path_corners"] = [np.asarray(c, np.float64)
                             for c in (it.get("gt_path_corners") or [start])]
    it.setdefault("attention_list", [])
    return it
