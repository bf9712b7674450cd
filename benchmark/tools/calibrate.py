#!/usr/bin/env python3
"""Readings behind a cell's limits (``limits/<workload>.json``), on the card,
many seeds in one process. Not run by the benchmark's own runs.

    python3 benchmark/tools/calibrate.py --workload haa_lstm.train --mode sound --seeds 11 12 13
    python3 benchmark/tools/calibrate.py --workload haa_lstm.train --mode control --seeds 21 22 23

Modes:
  sound    the cell as the benchmark runs it (a window of ``--seconds``): the
           numbers compared, per seed (the lower readings);
  control  the reference in the nearest precision below the configuration's
           in the port's place: TF32 for the float32 cells; for a bf16
           serving cell the port's own int8 tower (``--quant int8``);
  half     (train) the port's step on half of each batch, its loss the mean
           over the rest;
  frozen   (train) a step that returns its state unchanged;
  wrong_b2 (train) optimizers that decay the second moment at 0.99;
  repeat   (train) the cell twice on each seed in one process: each checked
           step's loss gap, the first step's change and the change over all
           checked steps, for the port against itself, the reference
           against itself, and each run's port against its reference.
``--deterministic`` runs both sides with cuDNN's and PyTorch's
deterministic algorithms (warning where an op has none).
One JSON line per seed: ``{"seed", "mode", "compared": {name: value}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
os.environ["USE_FLAX"] = "0"
os.environ.pop("AVDN_BERT_VOCAB", None)


def control(ctx) -> dict:
    """The control's numbers for one seed."""
    import reference.device as ref_device
    from harness import data, train, valid
    from harness.runner import run_cell

    kind = ctx.cell.traffic["kind"]
    if kind == "serve":
        ctx.argv += ["--quant", "int8"]
        return {k: v[0] for k, v in run_cell(ctx)["compared"].items()}
    tr = ctx.cell.traffic
    items = data.make_items(ctx.seed, tr["n_items"], tr["n_maps"], tr["map_px"])
    maps = data.make_maps(ctx.seed, tr["n_maps"], tr["map_px"], ctx.device)
    split = "train" if kind == "train" else "val_seen"
    data.write_annotations(ctx.run_dir, {split: items})
    where = types.SimpleNamespace(
        train_anno_dir=os.path.join(ctx.run_dir, "AVDN", "annotations"),
        val_anno_dir=os.path.join(ctx.run_dir, "AVDN", "annotations"),
        batch_size=ctx.flags["batch_size"], render_crop=0)
    runs = []
    for tf32 in (False, True):
        ref_device.ALLOW_TF32 = tf32
        if kind == "train":
            runs.append(train.reference_steps(ctx, where, maps, ctx.seed))
        else:
            runs.append(valid.reference_pass(ctx, where, maps, ctx.seed, split))
        ctx.free()
    ref_device.ALLOW_TF32 = False
    if kind == "train":
        from harness import compare

        print(f"[control] {compare.train_detail(runs[1], runs[0])}", file=sys.stderr)
        return compare.train(runs[1], runs[0])
    (want, want_m), (got, got_m) = runs
    return valid._compare({k: [v] for k, v in got.items()}, want, [got_m], want_m)


def _pair(a: dict, b: dict, live) -> dict:
    """Each checked step's relative loss gap, and the median and worst live
    leaf of the first step's change and of the change over all checked
    steps, between two runs of the first steps."""
    from harness import compare

    return {"loss_gaps": [compare._rel_gap(x, y) for x, y in zip(a["losses"], b["losses"])],
            "step1_median": compare._median_leaf(a["step1_norms"], b["step1_norms"], live),
            "step1_worst": compare._worst_leaf(a["step1_norms"], b["step1_norms"], live),
            "change_median": compare._median_leaf(a["delta_norms"], b["delta_norms"], live),
            "change_worst": compare._worst_leaf(a["delta_norms"], b["delta_norms"], live)}


def repeat(runs) -> dict:
    """The readings of :func:`_pair` for two runs' ``(port, reference)``."""
    from harness import compare

    (p1, r1), (p2, r2) = runs
    live = compare._live(r1)
    return {"port_port": _pair(p1, p2, live), "ref_ref": _pair(r1, r2, live),
            "port_ref_1": _pair(p1, r1, live), "port_ref_2": _pair(p2, r2, live),
            "compared_1": compare.train(p1, r1), "compared_2": compare.train(p2, r2)}


def deterministic() -> None:
    import torch

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", "half", "frozen", "wrong_b2", "repeat"))
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args()

    import torch

    from harness import faults
    from harness.cell import load_cell
    from harness.runner import Context, run_cell

    if a.deterministic:
        deterministic()
    cell = dataclasses.replace(load_cell(a.workload),
                               limits={k: float("inf") for k in load_cell(a.workload).limits})

    def context(seed, t0):
        return Context(cell, seed, a.seconds, False, torch.device("cuda", 0), t0)

    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = context(seed, t0)
        if a.mode in faults.TRAIN:
            ctx.wrap_step = faults.TRAIN[a.mode]
        if a.mode == "control":
            compared = control(ctx)
        elif a.mode == "repeat":
            runs = []
            for _ in range(2):
                run_ctx = context(seed, time.perf_counter())
                run_cell(run_ctx)
                runs.append(run_ctx.record["check"])
                del run_ctx
                torch.cuda.empty_cache()
            compared = repeat(runs)
        else:
            compared = {k: v[0] for k, v in run_cell(ctx)["compared"].items()}
        print(json.dumps({"workload": a.workload, "seed": seed, "mode": a.mode,
                          "deterministic": a.deterministic,
                          "compared": compared,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
        del ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
