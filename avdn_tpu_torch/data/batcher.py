"""Host→device batch assembly: annotation items → TrainBatch + metadata
(torch counterpart of ``avdn_tpu/data/batcher.py``).

GPS coordinates become float32-safe offsets from each map's bottom-left
corner, GT paths and attention circles are padded to static shapes, and
language is tokenised in the reference's two views (instructions-only for
token features; dialog + instructions for the CLS heads —
src/xview_et/agent.py:521-538).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from avdn_tpu_torch.data.maps import attention_circles
from avdn_tpu_torch.metrics.nav import count_dialog_rounds
from avdn_tpu_torch.rollout.engine import EpisodeBatch
from avdn_tpu_torch.train.step import TrainBatch


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_gt_len: int = 12
    max_circles: int = 16
    instr_pad: int = 128    # pass-1 token length (instructions only)
    dialog_pad: int = 320   # pass-2 token length (dialog + instructions)
    lang_dim: int = 768
    vision_only: bool = False
    single_bert_pass: bool = False  # --train_val_on_full


def make_train_batch(items: List[dict], tokenizer, slot_of: Optional[dict],
                     cfg: BatcherConfig = BatcherConfig(),
                     device=torch.device("cpu")) -> Tuple[TrainBatch, List[dict]]:
    """Build a TrainBatch on ``device`` (the map bank's) + per-item metadata
    for metric assembly. ``slot_of`` maps map_name → bank slot (from
    DeviceMapBank.prepare); None puts every item on slot 0."""
    B = len(items)
    start_corners = np.zeros((B, 4, 2), np.float32)
    start_dir = np.zeros((B,), np.float32)
    extent = np.zeros((B, 2), np.float32)
    lat_ratio = np.zeros((B,), np.float32)
    gt_corners = np.zeros((B, cfg.max_gt_len, 4, 2), np.float32)
    gt_len = np.zeros((B,), np.int64)
    circles = np.zeros((B, cfg.max_circles, 3), np.float32)
    n_circles = np.zeros((B,), np.int64)
    map_idx = np.zeros((B,), np.int64)
    meta = []

    instr_texts = []
    dialog_texts = []
    for i, item in enumerate(items):
        origin = np.asarray(item["gps_botm_left"], np.float64)
        extent[i] = np.asarray(item["gps_top_right"], np.float64) - origin
        lat_ratio[i] = item["lat_ratio"]
        path = item["gt_path_corners"]
        n = min(len(path), cfg.max_gt_len)
        gt_len[i] = n
        for j in range(n):
            gt_corners[i, j] = np.asarray(path[j], np.float64) - origin
        start_corners[i] = gt_corners[i, 0]
        start_dir[i] = item["angle"]
        circles[i], n_circles[i] = attention_circles(item, cfg.max_circles)
        map_idx[i] = 0 if slot_of is None else slot_of[item["map_name"]]

        instr = "" if cfg.vision_only else item["instructions"]
        dialog = item["pre_dialogs"] + item["instructions"]
        instr_texts.append(instr)
        dialog_texts.append(dialog)
        meta.append({
            "instr_id": item["map_name"] + "__" + item["route_index"],
            "num_dia": count_dialog_rounds(instr if cfg.single_bert_pass else dialog),
            "start_corners": start_corners[i].copy(),
            "start_dir": float(start_dir[i]),
            "gt_path_corners": [gt_corners[i, j].copy() for j in range(n)],
            "valid": not item.get("_pad", False),
        })

    ids1, mask1 = tokenizer(instr_texts, max_length=cfg.instr_pad, pad_to=cfg.instr_pad)
    ids2, mask2 = tokenizer(dialog_texts, max_length=cfg.dialog_pad, pad_to=cfg.dialog_pad)

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    episode = EpisodeBatch(
        map_idx=dev(map_idx),
        start_corners=dev(start_corners),
        start_dir=dev(start_dir),
        extent=dev(extent),
        lat_ratio=dev(lat_ratio),
        gt_corners=dev(gt_corners),
        gt_len=dev(gt_len),
        circles=dev(circles),
        n_circles=dev(n_circles),
        lang_feat=torch.zeros((B, cfg.instr_pad, cfg.lang_dim), device=device),
        lang_cls=torch.zeros((B, 49), device=device),
        lang_mask=dev(mask1.astype(bool)),
    )
    batch = TrainBatch(
        episode=episode,
        ids_instr=dev(ids1.astype(np.int64)),
        mask_instr=dev(mask1),
        ids_dialog=dev(ids2.astype(np.int64)),
        mask_dialog=dev(mask2),
    )
    return batch, meta


def batch_to(batch: TrainBatch, device) -> TrainBatch:
    """``batch`` with every tensor on ``device`` (itself when it is there)."""
    def move(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
            if f.name != "episode"})

    return dataclasses.replace(move(batch), episode=move(batch.episode))
