# Frozen copy of avdn_tpu_torch/metrics/nav.py at commit d6443de, its imports pointed
# at the reference package.
"""Navigation + human-attention metrics (host-side, float64 numpy).

Port of the reference evaluation semantics (src/env.py:335-475): SR, oracle
SR, SPL, GP, oracle GP, final IoU, trajectory lengths, with slices by dialog
rounds (1/2/else) and by trajectory length (long/short). Aggregation runs on
host after the compiled rollout returns its fixed-shape trajectory records.

Shapely is replaced by numpy: the strict-containment test is a half-plane
check (Polygon.contains semantics — boundary excluded, env.py:354-364).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

DEG_TO_M = 11.13e4


def _contains_strict(quad: np.ndarray, point: np.ndarray) -> bool:
    """Strict interior test for a convex quad (any winding)."""
    q = np.asarray(quad, np.float64)
    x, y = q[:, 0], q[:, 1]
    if 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0:
        q = q[::-1]
    a = q
    b = np.roll(q, -1, axis=0)
    cr = (b[:, 0] - a[:, 0]) * (point[1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        point[0] - a[:, 0]
    )
    return bool(np.all(cr > 0))


def count_dialog_rounds(dialog_text: str) -> int:
    """Dialog-round count from the tokenised dialog string: '[QUE]' splits
    minus rounds opening with 'Yes' (src/xview_et/agent.py:557-562)."""
    rounds = dialog_text.split("[QUE]")
    removed = sum(1 for r in rounds if "Yes" in r[0:5])
    return len(rounds) - removed


def eval_item(
    gt_path: List[np.ndarray],
    gt_corners: List[np.ndarray],
    path: List[np.ndarray],
    corners: List[np.ndarray],
    progress: List[float],
) -> Dict[str, float]:
    """Single-trajectory scores (src/env.py:335-373). ``path``/``gt_path``
    are view-center sequences; ``progress`` is the logged GT progress
    (final entry == final-view IoU)."""
    scores: Dict[str, float] = {}
    path = [np.asarray(p, np.float64) for p in path]
    gt_path = [np.asarray(p, np.float64) for p in gt_path]

    traj_len = float(
        sum(np.linalg.norm(a - b) for a, b in zip(path[:-1], path[1:])) * DEG_TO_M
    )
    gt_whole = float(
        sum(np.linalg.norm(a - b) for a, b in zip(gt_path[:-1], gt_path[1:])) * DEG_TO_M
    )
    gt_net = float(np.linalg.norm(gt_path[0] - gt_path[-1]) * DEG_TO_M)

    scores["trajectory_lengths"] = traj_len
    scores["iou"] = float(progress[-1])
    scores["gp"] = gt_net - float(np.linalg.norm(path[-1] - gt_path[-1]) * DEG_TO_M)
    scores["oracle_gp"] = gt_net - float(
        min(np.linalg.norm(p - gt_path[-1]) for p in path) * DEG_TO_M
    )

    success = float(progress[-1] >= 0.4)
    # mutual center containment (env.py:354-364)
    if not _contains_strict(corners[-1], np.mean(gt_corners[-1], axis=0)):
        success = 0.0
    if not _contains_strict(gt_corners[-1], np.mean(corners[-1], axis=0)):
        success = 0.0
    scores["success"] = success
    scores["oracle_success"] = float(any(np.asarray(progress) > 0.4))
    scores["gt_length"] = gt_whole
    scores["spl"] = success * gt_net / max(traj_len, gt_net, 0.01)
    return scores


def eval_metrics(preds: Dict[str, dict], human_att_eval: bool = False):
    """Aggregate over predictions keyed by instr_id (src/env.py:375-475).

    Each pred dict: ``path_corners`` (list of (corners, direction)),
    ``gt_path_corners``, ``gt_progress``, optional ``num_dia``, and for HA
    eval ``human_att_performance`` + ``nss``.
    """
    metrics = defaultdict(list)

    if human_att_eval:
        for k in preds:
            if "human_att_performance" in preds[k]:
                metrics["human_att_performance"] += list(preds[k]["human_att_performance"])
                nss = float(np.mean(preds[k]["nss"])) if len(preds[k]["nss"]) else np.nan
                if nss == nss:
                    metrics["nss"].append(nss)
        if metrics["human_att_performance"]:
            perf = np.mean(np.asarray(metrics["human_att_performance"]), axis=0)
            nss_avg = float(np.mean(metrics["nss"])) if metrics["nss"] else np.nan
        else:
            perf, nss_avg = np.array([np.nan, np.nan]), np.nan
        if nss_avg == nss_avg:
            # (the reference returns perf[0] for both precision and recall,
            # src/env.py:391-393 — we report the actual recall)
            avg = {
                "HA_precision": float(perf[0]),
                "HA_recall": float(perf[1]),
                "nss": nss_avg,
            }
        else:
            avg = {"HA_precision": 0, "HA_recall": 0, "nss": 0}
        return avg, metrics

    for k, item in preds.items():
        dia_number = item.get("num_dia", 0)
        corners = [np.asarray(c[0], np.float64) for c in item["path_corners"]]
        traj = [c.mean(axis=0) for c in corners]
        gt_corners = [np.asarray(c, np.float64) for c in item["gt_path_corners"]]
        gt_traj = [c.mean(axis=0) for c in gt_corners]
        progress = list(item["gt_progress"])

        s = eval_item(gt_traj, gt_corners, traj, corners, progress)
        for name, v in s.items():
            metrics[name].append(v)

        bucket = {1: "_1", 2: "_2"}.get(dia_number, "_else")
        metrics["success" + bucket].append(s["success"])
        metrics["spl" + bucket].append(s["spl"])
        metrics["gp" + bucket].append(s["gp"])

        lb = "_long" if s["trajectory_lengths"] > 150 else "_short"
        metrics["success" + lb].append(s["success"])
        metrics["spl" + lb].append(s["spl"])
        metrics["gp" + lb].append(s["gp"])
        metrics["instr_id"].append(item.get("instr_id", k))

    avg = {
        "lengths": float(np.mean(metrics["trajectory_lengths"])),
        "sr": float(np.mean(metrics["success"])) * 100,
        "oracle_sr": float(np.mean(metrics["oracle_success"])) * 100,
        "spl": float(np.mean(metrics["spl"])) * 100,
        "gp": float(np.mean(metrics["gp"])),
        "oracle_gp": float(np.mean(metrics["oracle_gp"])),
        "gt_length": float(np.mean(metrics["gt_length"])),
        "iou": float(np.mean(metrics["iou"])),
    }
    for suffix in ("_1", "_2", "_else"):
        if metrics["success" + suffix]:
            avg["num" + suffix] = len(metrics["success" + suffix])
            avg["spl" + suffix] = float(np.mean(metrics["spl" + suffix])) * 100
            avg["sr" + suffix] = float(np.mean(metrics["success" + suffix])) * 100
            avg["gp" + suffix] = float(np.mean(metrics["gp" + suffix]))
    return avg, metrics


def assemble_trajectories(outputs, episodes_meta: List[dict]) -> Dict[str, dict]:
    """Convert fixed-shape ``RolloutOutputs`` into the per-item prediction
    dicts ``eval_metrics`` consumes (the reference builds these incrementally
    in python during the rollout, agent.py:550-571, 716-722, 760-764).

    ``episodes_meta[i]`` needs: ``instr_id``, ``num_dia``, ``start_corners``,
    ``start_dir``, ``gt_path_corners`` (list of (4, 2) arrays, same offset
    frame as the rollout), and optional ``valid`` (False for wrap-around
    padding items).
    """
    import dataclasses as _dc

    out = {
        f.name: np.asarray(getattr(outputs, f.name))
        for f in _dc.fields(outputs)
        if f.name != "views" and getattr(outputs, f.name) is not None
    }
    T = out["alive_pre"].shape[0]
    preds: Dict[str, dict] = {}
    for i, meta in enumerate(episodes_meta):
        if not meta.get("valid", True):
            continue
        rec: dict = {
            "instr_id": meta["instr_id"],
            "num_dia": meta.get("num_dia", 0),
            "gt_path_corners": meta["gt_path_corners"],
            "path_corners": [(np.asarray(meta["start_corners"]), meta["start_dir"])],
            "actions": [],
            "gt_actions": [],
            "gt_progress": [],
            "progress": [],
            "human_att_performance": [],
            "nss": [],
        }
        for t in range(T):
            if out["alive_pre"][t, i]:
                rec["actions"].append(
                    [out["actions_wp"][t, i], float(out["actions_alt"][t, i])]
                )
                rec["gt_actions"].append(
                    [out["gt_wp"][t, i], float(out["gt_alt"][t, i])]
                )
                rec["gt_progress"].append(float(out["gt_progress"][t, i]))
                rec["progress"].append(float(out["pred_progress"][t, i]))
            if out["alive_post"][t, i]:
                rec["path_corners"].append(
                    (out["corners"][t, i], float(out["directions"][t, i]))
                )
            if out["ha_valid"][t, i]:
                rec["human_att_performance"].append(
                    [float(out["ha_precision"][t, i]), float(out["ha_recall"][t, i])]
                )
                rec["nss"].append(float(out["ha_nss"][t, i]))
        preds[rec["instr_id"]] = rec
    return preds
