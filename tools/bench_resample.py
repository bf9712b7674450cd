#!/usr/bin/env python3
"""Host cost of resampling one map tile: the PyTorch port's host library
against its plain numpy version and OpenCV.

    python3 tools/bench_resample.py [--sizes 3000 4000] [--repeats 3]

``avdn_tpu_torch.data.native.area_resize`` (``csrc/avdn_host.cpp``, built at
first use with the host compiler) is what the port's map bank runs on each
host-cache miss (``data/maps.py:load_map_image``). It is timed on seeded RGB
uint8 tiles at xView sizes (2-4k px edges, about 0.5 m/px), with the width
stretched by lng/lat ratio 1.1547 (square pixels at 30 degrees latitude) and
shrunk by 0.866, beside its plain version ``data/resample.py`` (numpy
float64), whose output it must equal bit for bit, and
``cv2.resize(..., INTER_AREA)``. Prints one JSON line for the host (its CPU
model and core count), then one per case: the median wall time in seconds of
each resampler over ``--repeats`` calls (null where OpenCV is missing).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATIOS = (1.1547, 0.866)


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``), or the
    architecture where the host reports no model."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            lines += [line for line in f if line.startswith("model name")]
    except OSError:
        pass
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        lines += [line for line in out.splitlines() if line.startswith("Model name:")]
    except (OSError, subprocess.SubprocessError):
        pass
    for line in lines:
        name = line.split(":", 1)[1].strip()
        if name and name.lower() != "unknown":
            return name
    return f"{platform.machine()}, CPU model not reported"


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return lambda src, dh, dw: cv2.resize(src, (dw, dh), interpolation=cv2.INTER_AREA)


def median_s(fn, repeats):
    """``(median wall seconds over repeats, the last result)``."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def time_case(tile, dh, dw, repeats, cv2_resize=None):
    """One case: native, plain and OpenCV seconds and the bit-equality of
    native and plain."""
    sys.path.insert(0, ROOT)
    from avdn_tpu_torch.data import native, resample

    native.library()  # built and loaded before the clock starts
    native_s, got = median_s(lambda: native.area_resize(tile, dh, dw), repeats)
    plain_s, want = median_s(lambda: resample.area_resize(tile, dh, dw), repeats)
    rec = {"src": list(tile.shape), "dst": [dh, dw, tile.shape[2]], "native_s": native_s,
           "plain_s": plain_s, "bit_equal": bool(np.array_equal(got, want)), "cv2_s": None}
    if cv2_resize is not None:
        rec["cv2_s"] = median_s(lambda: cv2_resize(tile, dh, dw), repeats)[0]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[3000, 4000])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps({"cpu": cpu_model(), "cpus": os.cpu_count(),
                      "numpy": np.__version__}), flush=True)
    cv2_resize = _cv2()
    rng = np.random.default_rng(args.seed)
    for edge in args.sizes:
        tile = rng.integers(0, 256, (edge, edge, 3), dtype=np.uint8)
        for ratio in RATIOS:
            print(json.dumps(time_case(tile, edge, int(edge * ratio), args.repeats,
                                       cv2_resize)), flush=True)


if __name__ == "__main__":
    main()
