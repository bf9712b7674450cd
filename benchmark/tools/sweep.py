#!/usr/bin/env python3
"""Find a serving cell's knee once, on the card: the highest offered rate
(items/s) at which the backlog does not grow over a window. Not run by the
benchmark's own runs; its result is written into the traffic file by hand.

    python3 benchmark/tools/sweep.py --workload et_haa.serve --seed 3 --seconds 12 \
        --rates 10 15 20 25 30 35

One Navigator and server, warmed up once; then each rate's open loop in
turn. A rate holds when the window's completed items per second reach 95 %
of the offered rate and the latency of the last quarter of its requests
is under 1.5 × that of the first quarter. One JSON line per rate.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
os.environ["USE_FLAX"] = "0"
os.environ.pop("AVDN_BERT_VOCAB", None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args()

    import torch

    from harness import serve
    from harness.cell import load_cell
    from harness.runner import Context

    cell = load_cell(a.workload)
    ctx = Context(cell, a.seed, a.seconds, False, torch.device("cuda", 0), time.perf_counter())
    nav, server, thread, url, pool, _maps, _args = serve.start(ctx)
    knee = None
    try:
        for rate in a.rates:
            dues, picks = serve.schedule(a.seed, rate, a.seconds, len(pool))
            b0 = server.service.batches_run
            res = serve.offer(url, pool, dues, picks, f"s{rate:g}_")
            lat = [(done - due) * 1e3 for due, _s, done, recs in res]
            span = max(done for _d, _s, done, _r in res)
            q = max(1, len(res) // 4)
            order = sorted(range(len(res)), key=lambda i: res[i][0])
            first = statistics.median(lat[i] for i in order[:q])
            last = statistics.median(lat[i] for i in order[-q:])
            served = len(res) / span
            holds = served >= 0.95 * rate and last < 1.5 * first
            knee = rate if holds else knee
            print(json.dumps({"rate": rate, "requests": len(res), "served_items_s": served,
                              "p50_ms": serve.percentile(lat, 50),
                              "p95_ms": serve.percentile(lat, 95),
                              "first_quarter_ms": first, "last_quarter_ms": last,
                              "batches": server.service.batches_run - b0,
                              "holds": bool(holds)}), flush=True)
    finally:
        serve.stop(server, thread)
    print(json.dumps({"knee_items_s": knee, "at_four_fifths": None if knee is None
                      else 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
