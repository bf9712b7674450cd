#!/usr/bin/env python3
"""How each Darknet call of a benchmark train cell ran, step by step, on the
card: ``Darknet.graph_calls`` (captures, graph replays, eager calls by
reason) read before and after every train step of the cell's run, and each
step's host seconds to its end on the device.

    python3 tools/darknet_graph_census.py --workload haa_lstm.train --seed 7 --seconds 20

Runs the cell as ``benchmark/run.py --trace 0`` does (set-up with its
checked steps, the window, the check against the reference) and prints one
JSON line: the run's result line (``result``), the counts of each set-up
step (``setup_steps``), the window's steps summed (``window``, with
``window_steps``) and their median seconds (``window_step_s``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
os.environ["USE_FLAX"] = "0"
os.environ.pop("AVDN_BERT_VOCAB", None)


def _counts(net) -> collections.Counter:
    # a tower from before Darknet.graph_calls existed counts nothing
    return collections.Counter(getattr(net, "graph_calls", {}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="haa_lstm.train")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    a = ap.parse_args()

    import torch

    from harness import program
    from harness.cell import load_cell
    from harness.runner import Context, run_cell

    program.modules()
    cell = load_cell(a.workload)
    if cell.traffic["kind"] != "train":
        raise SystemExit(f"{a.workload} is not a train cell")
    ctx = Context(cell, a.seed, a.seconds, False, torch.device("cuda", 0), time.perf_counter())
    steps = []  # per step: seconds, then the counts that moved

    def wrap(fn):
        def step(state, *args):
            before, t0 = _counts(state.darknet), time.perf_counter()
            out = fn(state, *args)
            torch.cuda.synchronize()
            seconds, after = time.perf_counter() - t0, _counts(state.darknet)
            steps.append({"seconds": seconds, **{k: after[k] - before[k] for k in after
                                                 if after[k] != before[k]}})
            return out
        return step

    ctx.wrap_step = wrap
    result = run_cell(ctx)
    n_setup = cell.traffic["check_steps"]
    window = collections.Counter()
    for s in steps[n_setup:]:
        window.update({k: v for k, v in s.items() if k != "seconds"})
    print(json.dumps({"workload": a.workload, "seed": a.seed, "result": result,
                      "setup_steps": steps[:n_setup], "window": dict(window),
                      "window_steps": len(steps) - n_setup,
                      "window_step_s": statistics.median(s["seconds"] for s in steps[n_setup:])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
