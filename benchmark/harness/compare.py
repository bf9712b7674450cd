"""The numbers that decide ``correct``: each compares what the port's timed
path produced with what the reference produced from the same inputs, and is
held to a limit of the cell's own (``limits/<workload>.json``, set from
readings in PERF.md).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

#: a leaf whose first gradient in the reference is under this share of the
#: median leaf's moves under Adam by round-off alone: it is left out of the
#: change's comparison (a key's bias under softmax is one)
DEAD_LEAF = 1e-3
DEG_TO_M = 11.13e4


def _worst_leaf(got: List[float], want: List[float], keep=None) -> float:
    """The largest gap between the port's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    worst = 0.0
    for i in idx:
        gap = abs(got[i] - want[i]) / max(want[i], med, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def train(got: Dict, want: Dict) -> Dict[str, float]:
    """A train cell's numbers: the first step's relative loss gap, the worst
    leaf of the first gradient's norm, the median live leaf of the
    parameters' change after the first step, and the worst reading of the
    port's AdamW updates at every checked step against the reference's from
    the same state (``train.AdamCheck``). Later steps' losses and the change
    over all checked steps are logged, not compared: they read run-to-run
    round-off amplified, each side against itself as much as against the
    other (PERF.md gives the readings)."""
    if (len(got["grad_norms"]) != len(want["grad_norms"])
            or len(got["losses"]) != len(want["losses"])):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf,
                "adam_gap": math.inf}
    live = _live(want)
    return {"loss_gap": _rel_gap(got["losses"][0], want["losses"][0]),
            "grad_gap": _worst_leaf(got["grad_norms"], want["grad_norms"]),
            "change_gap": _median_leaf(got["step1_norms"], want["step1_norms"], live),
            "adam_gap": max(got["adam_gaps"], default=math.inf)}


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf


def _live(want: Dict) -> List[bool]:
    med_g = statistics.median(want["grad_norms"])
    return [g >= DEAD_LEAF * med_g for g in want["grad_norms"]]


def _median_leaf(got: List[float], want: List[float], keep) -> float:
    """The median over the kept leaves of the gap between the port's and the
    reference's norm of a leaf, over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    idx = [i for i in range(len(want)) if keep[i]]
    med = statistics.median(want[i] for i in idx)
    gaps = [abs(got[i] - want[i]) / max(want[i], med, 1e-30) for i in idx]
    return statistics.median(g if math.isfinite(g) else math.inf for g in gaps)


def train_detail(got: Dict, want: Dict) -> str:
    """The checked steps' losses on both sides, each step's relative loss
    gap, the change over all of them (median and worst live leaf) and each
    optimizer call's AdamW reading, for the run's log."""
    live = _live(want)
    gaps = [_rel_gap(a, b) for a, b in zip(got["losses"], want["losses"])]
    return (f"losses port {got['losses']!r} reference {want['losses']!r}; loss gaps "
            f"{gaps!r}; change over the checked steps: median leaf "
            f"{_median_leaf(got['delta_norms'], want['delta_norms'], live)!r}, worst leaf "
            f"{_worst_leaf(got['delta_norms'], want['delta_norms'], live)!r} "
            f"({sum(live)} of {len(live)} leaves live); AdamW calls {got['adam_gaps']!r}")


def records(got: Dict[str, dict], want: Dict[str, dict]) -> Dict[str, float]:
    """Served or evaluated trajectories, record by record (``instr_id`` →
    ``path_corners``, ``actions``, ``progress``): the largest gap of a view
    corner (metres; infinite where a record is missing or stops at another
    step), of an action and of the progress."""
    corner, action, progress = 0.0, 0.0, 0.0
    for key, w in want.items():
        g = got.get(key)
        if g is None or len(g["path_corners"]) != len(w["path_corners"]):
            corner = math.inf
            continue
        for (gc, gh), (wc, wh) in zip(g["path_corners"], w["path_corners"]):
            corner = max(corner, _maxabs(gc, wc) * DEG_TO_M)
        for ga, wa in zip(g["actions"], w["actions"]):
            action = max(action, _maxabs(ga[0], wa[0]), abs(float(ga[1]) - float(wa[1])))
        progress = max(progress, _maxabs(g["progress"], w["progress"]))
    return {"corner_gap_m": corner, "action_gap": action, "progress_gap": progress}


def _maxabs(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def ha_records(got: Dict[str, dict], want: Dict[str, dict]) -> float:
    """The largest gap of a human-attention precision, recall or NSS over
    the records of a fused HA eval (infinite where their counts differ)."""
    worst = 0.0
    for key, w in want.items():
        g = got.get(key)
        if g is None:
            return math.inf
        for field in ("human_att_performance", "nss"):
            worst = max(worst, _maxabs(g[field], w[field]))
    return worst
