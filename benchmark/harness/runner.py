"""One run of a cell: the traffic kind's driver, then the result line.

A driver (``harness/<kind>.py``, the kind named by the traffic file) sets
up, measures, traces and checks; it returns the end-to-end metrics it
measured, the numbers it compared, and fills ``ctx.record`` with what the
per-layer readers (``metrics/<name>.py``) read.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import shutil
import subprocess
import sys
from typing import Callable, Optional

import torch

from harness import trace as trace_mod
from harness.cell import Cell, metric_reader


class Context:
    """What a driver needs: the cell, the seed, the window, the device, the
    process's start time, and hooks that the tests replace."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, run_dir: Optional[str] = None):
        import tempfile

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_start = torch.device(device), t_start
        self.run_dir = run_dir or os.path.join(tempfile.gettempdir(), "avdn_bench", cell.name)
        shutil.rmtree(self.run_dir, ignore_errors=True)
        os.makedirs(self.run_dir)
        self.record: dict = {}
        self.flags = {**cell.config.get("args", {}), **cell.traffic.get("args", {})}
        self.argv = ["--output_dir", os.path.join(self.run_dir, "out"),
                     "--root_dir", self.run_dir, "--seed", str(seed)]
        for k, v in self.flags.items():
            self.argv += [f"--{k}", str(v)]
        #: the tests wrap the port's timed call here to plant a fault
        self.wrap_step: Callable = lambda fn: fn

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.on_card else 0

    def free(self) -> None:
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def traced(self, fn, name_fn=None, expect=None):
        if not self.on_card:
            return None
        return trace_mod.traced(fn, self.sync, name_fn, expect)


def _card_name(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(ctx: Context) -> dict:
    kind = ctx.cell.traffic["kind"]
    driver = importlib.import_module(f"harness.{kind}")
    print(f"[run] {ctx.cell.name} seed {ctx.seed} {ctx.seconds} s trace {int(ctx.trace)} "
          f"on {_card_name(ctx.device)['kind']} ({_power_limit() if ctx.on_card else 'cpu'})",
          file=sys.stderr)
    out = driver.run(ctx)
    rec = ctx.record
    limits = ctx.cell.limits
    compared = {}
    for name, value in out["compared"].items():
        if name not in limits:
            raise KeyError(f"{ctx.cell.name}: no limit for {name} in limits/{ctx.cell.name}.json")
        compared[name] = [value, limits[name]]
    correct = all(math.isfinite(v) and v <= lim for v, lim in compared.values())
    device = _card_name(ctx.device)
    device["memory_peak_bytes"] = rec.get("memory_peak_bytes", 0)
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out.get("failed", 0))}
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    if not ctx.trace:
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in out["metrics"].items() if k in units}
        print(f"[run] window {rec.get('window_s')} s, {rec.get('units')} "
              f"{rec.get('unit_name')}s; " + ", ".join(
                  f"{k} {v!r}" for k, v in out["metrics"].items()) +
              f"; peak {device['memory_peak_bytes']} bytes", file=sys.stderr)
    else:
        tr = rec.get("trace")
        metrics = {}
        for m in ctx.cell.per_layer:
            value = metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if tr is not None:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
    result["device"] = device
    if ctx.trace and rec.get("trace") is not None:
        tr = rec["trace"]
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["compared"] = compared
    return result
