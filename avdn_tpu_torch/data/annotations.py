"""ANDH annotation loading + normalisation (the port's copy of
``avdn_tpu/data/annotations.py``: the same seeded shuffle, wrap-around
refill and per-process shards, so both packages batch the same items in the
same order).

Replicates the dataset semantics of ``ANDHNavBatch.__init__``
(src/env.py:85-180): per item the heading angle is int-rounded mod 360, GT
path corners become float arrays, instructions are lowercased, and the
dialog history list is joined into one lowercase string. Shuffling is
seeded; batches are fixed-size with wrap-around refill (src/env.py:199-249).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np


def load_annotations(anno_dir: str, splits: List[str],
                     full_traj: bool = False) -> List[dict]:
    data = []
    for split in splits:
        path = os.path.join(anno_dir, f"{split}_data.json")
        with open(path) as f:
            new_data = json.load(f)
        if full_traj:
            items = _concat_full_trajectories(new_data)
        else:
            items = []
            for item in new_data:
                item = dict(item)
                item["angle"] = round(item["angle"]) % 360
                item["gt_path_corners"] = [
                    np.asarray(c, np.float64) for c in item["gt_path_corners"]
                ]
                item["instructions"] = item["instructions"].lower()
                item["pre_dialogs"] = " ".join(item["pre_dialogs"]).lower()
                items.append(item)
        for item in items:
            item["split"] = split
            data.append(item)
        print(f"ANDH annotations: loaded {len(new_data)} items from split {split}"
              + (f" -> {len(items)} full trajectories" if full_traj else ""))
    return data


def _concat_full_trajectories(new_data: List[dict]) -> List[dict]:
    """``--train_val_on_full`` mode: stitch each trajectory's dialog rounds
    into ONE episode (the reference designed but left this commented out,
    src/env.py:107-168 — rebuilt here as a supported feature).

    Per (map, trajectory) group: start from round 1; for each later round k
    append ``' [SEP] facing ' + <compass> + instructions`` — the compass
    word is glued to the next round's text with NO separating space,
    faithfully matching the reference's concatenation (env.py:147-149) —
    take the LAST round's attention_list (it accumulates all earlier
    rounds' circles upstream, env.py:150 comment), and concatenate
    gt_path_corners.
    Tiny (<10 cm) noise is added to every corner (env.py:155) and a final
    square goal view area built from the destination corners is appended
    (env.py:157-168).
    """
    from avdn_tpu_torch.geometry.transforms import name_the_direction

    rng = random.Random(0)
    by_map: Dict[str, List[dict]] = {}
    for it in new_data:
        by_map.setdefault(it["map_name"], []).append(it)

    out: List[dict] = []
    for map_name in sorted(by_map):
        subs = by_map[map_name]
        traj_ids = sorted({it["route_index"].split("_")[0] for it in subs})
        for traj_idx in traj_ids:
            rounds = {
                it["route_index"].split("_")[1]: it
                for it in subs
                if it["route_index"].split("_")[0] == traj_idx
            }
            if "1" not in rounds:
                continue
            base = dict(rounds["1"])
            base["angle"] = round(base["angle"]) % 360
            instructions = base["instructions"]
            corners = [np.asarray(c, np.float64)
                       for c in base["gt_path_corners"]]
            attention = base.get("attention_list", [])
            k = 1
            while True:
                k += 1
                if base.get("last_round_idx", 1) < k:
                    break
                nxt = rounds.get(str(k))
                if nxt is None:
                    break
                assert base["lng_ratio"] == nxt["lng_ratio"]
                instructions += (
                    " [SEP] facing "
                    + name_the_direction(round(nxt["angle"]) % 360)
                    + nxt["instructions"]
                )
                attention = nxt.get("attention_list", attention)
                corners += [np.asarray(c, np.float64)
                            for c in nxt["gt_path_corners"]]
            # <10 cm jitter so duplicated waypoints never coincide exactly
            corners = [
                c + np.array([rng.random() * 1e-7, rng.random() * 1e-7])
                for c in corners
            ]
            des = np.asarray(base["destination"], np.float64)
            mean_des = des.mean(axis=0)
            best_width = max(
                np.linalg.norm(des[0] - des[1]),
                np.linalg.norm(des[2] - des[1]),
                40 / 11.13 / 1e4,
            )
            h = best_width / 2
            goal = np.array([
                [mean_des[0] - h, mean_des[1] - h],
                [mean_des[0] - h, mean_des[1] + h],
                [mean_des[0] + h, mean_des[1] + h],
                [mean_des[0] + h, mean_des[1] - h],
            ])
            corners.append(goal)
            base["instructions"] = instructions.lower()
            base["pre_dialogs"] = " ".join(base.get("pre_dialogs", [])).lower()
            base["attention_list"] = attention
            base["gt_path_corners"] = corners
            out.append(base)
    return out


class ANDHDataset:
    """Seeded-shuffle dataset with fixed-size wrap-around batches.

    Iterating yields lists of annotation items of exactly ``batch_size``
    (the final short batch is refilled from a reshuffle, matching
    src/env.py:203-208 — items may repeat within an epoch boundary).
    """

    def __init__(self, anno_dir: str, splits: List[str], batch_size: int,
                 seed: int = 0, full_traj: bool = False,
                 shard: Optional[tuple] = None):
        self.data = load_annotations(anno_dir, splits, full_traj)
        self.total_size = len(self.data)
        #: the instr_ids this process owns (all of them unsharded, None)
        self.owned_instr_ids = None
        if shard is not None and shard[1] > 1:
            # shard (index, count) of a multi-process run: every count-th
            # item from index, padded by wrap-around to ceil(total / count)
            # so every process runs the same number of batches (a short one
            # would leave the others waiting in the step's collectives). The
            # pad items belong to another shard, so per-process file writers
            # skip them (owned_instr_ids).
            idx, count = shard
            target = -(-self.total_size // count)
            part = self.data[idx::count]
            self.owned_instr_ids = {
                it["map_name"] + "__" + str(it["route_index"]) for it in part}
            part += [self.data[k % self.total_size]
                     for k in range(target - len(part))]
            self.data = part
        self.batch_size = batch_size
        self._rng = random.Random(seed)
        self._rng.shuffle(self.data)

    def size(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[List[dict]]:
        bs = self.batch_size
        for ix in range(0, len(self.data), bs):
            batch = self.data[ix : ix + bs]
            if len(batch) < bs:
                self._rng.shuffle(self.data)
                # loops when the split itself is smaller than the refill
                # (the reference takes one slice, env.py:203-208 — identical
                # whenever len(data) >= batch_size)
                while len(batch) < bs:
                    batch = batch + self.data[: bs - len(batch)]
            yield batch
