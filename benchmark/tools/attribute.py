#!/usr/bin/env python3
"""A cell's kernel launches and idle device time by layer of the port, on
the card (``harness/spans.py``). Not run by the benchmark's own runs.

    python3 benchmark/tools/attribute.py --workload haa_lstm.train --seed 7 --seconds 20
    python3 benchmark/tools/attribute.py --workload et_haa.valid --seed 7 --seconds 20 \\
        --cost_pairs 4 --cost_seconds 10
    python3 benchmark/tools/attribute.py --proof 1000

Runs the cell as ``run.py --trace 1`` does (the measured window, the cell's
own traced sessions, the check against the reference), with one more
traced session of the same units with the port's span recorder on. Prints
one JSON line: the run's result line (``result``), the span metrics of
``harness/spans.py:METRICS`` (``span_metrics``), every group's (and every
span name's) launches a unit and idle ms a unit, the thread mapping, and with ``--cost_pairs`` the
units' rate with the recorder off and on in alternating windows of
``--cost_seconds`` in this process, before any profiler session
(``cost``). ``--recorder_on``: the cell as ``run.py --trace 0`` runs it,
with the recorder on from the start (the end-to-end metrics with it on; its
result line alone). ``--proof n``: the clock and thread proof
(``spans.clock_proof``) alone.
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


def cost(fn, sync, pairs: int, seconds: float) -> dict:
    """Units a second of ``fn() -> units`` in windows of ``seconds``, the
    recorder off and on in alternating order (off, on; on, off; ...)."""
    from avdn_tpu_torch.utils.logging import disable, drain, enable

    rates = {"off": [], "on": []}
    for k in range(pairs):
        for arm in (("off", "on") if k % 2 == 0 else ("on", "off")):
            if arm == "on":
                enable()
            sync()
            t0, units = time.perf_counter(), 0
            while time.perf_counter() - t0 < seconds:
                units += fn()
            sync()
            rates[arm].append(units / (time.perf_counter() - t0))
            disable()
            drain()
    med = {arm: statistics.median(v) for arm, v in rates.items()}
    return {"rates": rates, "median": med,
            "on_over_off": med["on"] / med["off"] if med["off"] else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--cost_pairs", type=int, default=0)
    ap.add_argument("--cost_seconds", type=float, default=10.0)
    ap.add_argument("--proof", type=int, default=0)
    ap.add_argument("--recorder_on", action="store_true")
    ap.add_argument("--out", default=None, help="also write the line to this file")
    a = ap.parse_args()

    import torch

    from harness import program, spans
    from harness.cell import load_cell
    from harness.runner import Context, run_cell

    program.modules()  # the port, from this checkout
    if a.proof:
        line = {"proof": spans.clock_proof(a.proof),
                "device": torch.cuda.get_device_name(0)}
    elif a.recorder_on:
        from avdn_tpu_torch.utils.logging import drain, enable

        enable()
        line = run_cell(Context(load_cell(a.workload), a.seed, a.seconds, False,
                                torch.device("cuda", 0), time.perf_counter()))
        line["spans_recorded"] = len(drain())
    else:
        class SpanContext(Context):
            def traced(self, fn, name_fn=None, expect=None):
                # the cost first: a profiler session leaves the host slower
                if a.cost_pairs:
                    self.record["cost"] = cost(fn, self.sync, a.cost_pairs,
                                               a.cost_seconds)
                tr = super().traced(fn, name_fn, expect)
                self.record["spans"] = spans.session(fn, self.sync)
                return tr

        cell = load_cell(a.workload)
        ctx = SpanContext(cell, a.seed, a.seconds, True, torch.device("cuda", 0),
                          time.perf_counter())
        result = run_cell(ctx)
        rec = ctx.record
        st = rec.get("spans")
        kind = cell.traffic["kind"]
        line = {"workload": a.workload, "seed": a.seed, "result": result,
                "span_metrics": {name: spans.read(rec, name)
                                 for name in spans.METRICS[kind]}}
        if st is not None:
            line.update(
                units=st.units, window_s=st.window_s, idle_s=st.idle_s,
                thread_map=st.thread_map, spans=st.spans,
                launches_per_unit={g: n / st.units for g, n in sorted(st.launches.items())},
                idle_ms_per_unit={g: v * 1e3 / st.units
                                  for g, v in sorted(st.idle_s_by.items())},
                launches_total=sum(st.launches.values()) / st.units,
                launches_per_unit_by_span={k: n / st.units for k, n in
                                           sorted(st.launches_by_span.items())},
                idle_ms_per_unit_by_span={k: v * 1e3 / st.units for k, v in
                                          sorted(st.idle_s_by_span.items())})
        if "cost" in rec:
            per_unit = rec.get("episodes", rec["units"]) / rec["units"]
            line["cost"] = dict(rec["cost"], episodes_per_unit=per_unit)
    text = json.dumps(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
