#!/usr/bin/env python3
"""Host cost of resampling one map tile: the PyTorch port's INTER_AREA
resampler against OpenCV's and the native C++ one.

    python3 tools/bench_resample.py [--sizes 3000 4000] [--repeats 3]

``avdn_tpu_torch.data.resample.area_resize`` (numpy float64) is what the
port's map bank runs on each host-cache miss (``data/maps.py:
load_map_image``). It is timed on seeded RGB uint8 tiles at xView sizes
(2-4k px edges, about 0.5 m/px), with the width stretched by lng/lat ratio
1.1547 (square pixels at 30 degrees latitude) and shrunk by 0.866, beside
``cv2.resize(..., INTER_AREA)`` and the native ``area_resize_u8`` of
``native/libavdn_host.so`` (loaded with ctypes, where it loads), whose
output it must equal bit for bit. Prints one JSON line per case: the median
wall time in seconds of each resampler over ``--repeats`` calls, or null
where that resampler is not available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATIOS = (1.1547, 0.866)


def _native():
    try:
        lib = ctypes.CDLL(os.path.join(ROOT, "native", "libavdn_host.so"))
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fn = lib.area_resize_u8
    fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
                   ctypes.c_int, ctypes.c_int]
    fn.restype = None

    def resize(src, dh, dw):
        dst = np.empty((dh, dw, src.shape[2]), np.uint8)
        fn(src.ctypes.data_as(u8p), src.shape[0], src.shape[1], src.shape[2],
           dst.ctypes.data_as(u8p), dh, dw)
        return dst
    return resize


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return lambda src, dh, dw: cv2.resize(src, (dw, dh), interpolation=cv2.INTER_AREA)


def _median_s(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[3000, 4000])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from avdn_tpu_torch.data.resample import area_resize

    others = {"cv2": _cv2(), "native": _native()}
    print(json.dumps({"machine": platform.machine(), "cpus": os.cpu_count(),
                      "numpy": np.__version__}), flush=True)
    rng = np.random.default_rng(args.seed)
    for edge in args.sizes:
        tile = rng.integers(0, 256, (edge, edge, 3), dtype=np.uint8)
        for ratio in RATIOS:
            dh, dw = edge, int(edge * ratio)
            port_s, got = _median_s(lambda: area_resize(tile, dh, dw), args.repeats)
            rec = {"src": [edge, edge, 3], "dst": [dh, dw, 3], "port_s": port_s}
            for name, fn in others.items():
                if fn is None:
                    rec[f"{name}_s"] = None
                    continue
                rec[f"{name}_s"], want = _median_s(lambda: fn(tile, dh, dw), args.repeats)
                if name == "native":
                    rec["bit_equal_to_native"] = bool(np.array_equal(got, want))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
