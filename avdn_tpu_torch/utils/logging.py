"""Record files, phase timers and metric logs (the port's copy of
``write_to_record_file``, ``PhaseTimer`` and ``MetricWriter`` from
``avdn_tpu/utils/logging.py``, without the TensorBoard writer): plain-text
record lines (the reference's src/utils/logger.py), cumulative per-phase
wall timers, and structured JSONL.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


def write_to_record_file(data: str, file_path: Optional[str], verbose: bool = True):
    if verbose:
        print(data)
    if file_path:
        with open(file_path, "a") as f:
            f.write(data + "\n")


class PhaseTimer:
    """Cumulative per-phase wall timers: ``with timer("render"): ...``;
    ``timer.summary()`` reports totals and shares."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._start: Dict[str, float] = {}

    class _Ctx:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.name] += dt
            self.timer.counts[self.name] += 1

    def __call__(self, name: str) -> "PhaseTimer._Ctx":
        return PhaseTimer._Ctx(self, name)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        parts = [
            f"{k}: {v:.2f}s ({100 * v / total:.0f}%, n={self.counts[k]})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "; ".join(parts)


class MetricWriter:
    """Record-file + JSONL scalar writer."""

    def __init__(self, log_dir: str, record_name: str = "train.txt"):
        os.makedirs(log_dir, exist_ok=True)
        self.record_path = os.path.join(log_dir, record_name)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": step, **{k: float(v) for k, v in values.items()}}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def text(self, line: str):
        write_to_record_file(line, self.record_path)
