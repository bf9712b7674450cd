#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 benchmark/run.py --workload et_haa.train --seed 7 --seconds 30 --trace 0

From the root of a checkout. Reads the cell from ``BENCHMARK.json`` and its
files under ``benchmark/`` (``configs/``, ``traffic/``, ``limits/``,
``metrics/``), makes the inputs and weights from ``--seed``, sets up and
warms up the port (``avdn_tpu_torch``), measures for ``--seconds``, checks
what the timed path produced against the plain reference
(``benchmark/reference/``), and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` window after the measured one), ``device`` and, traced,
``breakdown``. Each number compared is printed beside its limit as the last
lines of standard error and under ``compared``, the line's last key.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when the process holds JAX, jaxlib, flax or the
JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache of the program inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "cache", _sub)
os.environ["USE_FLAX"] = "0"
os.environ.pop("AVDN_BERT_VOCAB", None)  # the hashed vocabulary on both sides
sys.path.insert(0, BENCH)

FORBIDDEN = ("jax", "jaxlib", "flax", "avdn_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules the benchmark must never hold,
    compared whole (``avdn_tpu_torch`` is not ``avdn_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from harness.cell import load_cell
    from harness.runner import Context, run_cell

    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = Context(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), T_START)
    result = run_cell(ctx)
    held = forbidden_modules()
    if held:
        print(f"the process holds {held} after the window: the benchmark runs "
              "without JAX and without the JAX package", file=sys.stderr)
        return 4
    for name, (value, limit) in result["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
