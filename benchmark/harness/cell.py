"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and one reader ``metrics/<metric>.py`` per
per-layer metric. Adding a cell, a configuration, a traffic mix or a metric
adds files; no file that is there changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]   # the cell's per-layer metrics
    chips: int = 1


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` of ``<root>/BENCHMARK.json``."""
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    bench = os.path.join(root, "benchmark")
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    # a per-layer metric without a workloads key belongs to every cell that
    # reports the end-to-end metric it moves
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(
        name=workload,
        config=_load_json(os.path.join(bench, "configs", w["config"] + ".json")),
        traffic=_load_json(os.path.join(bench, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(bench, "limits", workload + ".json")),
        end_to_end=e2e, per_layer=per_layer, chips=int(w["chips"]))


def metric_reader(name: str, bench: str = BENCH_DIR) -> Callable:
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
