"""INTER_AREA resampling of uint8 map tiles on the host: the plain version.

The map bank resamples with the port's host library
(``csrc/avdn_host.cpp:area_resize_u8`` through ``data/native.py``); this is
the same function in numpy float64, which the tests hold the library
against. Each destination pixel averages the exact fractional coverage of
its source footprint. It follows the C++ code's order of operations — every
product and sum rounded once, no fused multiply-add — so its output is
bit-equal to the library's (built without ``-march``, where the compiler
emits no FMA). OpenCV's INTER_AREA, which uses fixed point, is ±1 intensity
off on about 0.5 % of pixels.

Vectorised over rows and columns; the only Python loops run over the span
index (a few taps per destination pixel) and over blocks of destination
rows, which bound the float64 working set.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_ROWS_PER_BLOCK = 256


def _spans(src_len: int, dst_len: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per destination index: the first source index ``i0`` (dst_len,) and,
    for each tap k, the coverage ``w`` (K, dst_len) of source index
    ``i0 + k`` in the C++ code's order; taps the C++ code skips (beyond the
    span, or with coverage <= 0) carry weight 0, which adds nothing."""
    scale = float(src_len) / dst_len
    d = np.arange(dst_len, dtype=np.float64)
    lo = d * scale
    hi = np.minimum(lo + scale, float(src_len))
    i0 = lo.astype(np.int64)
    i1 = np.minimum(np.ceil(hi).astype(np.int64), src_len)
    k_max = int((i1 - i0).max(initial=0))
    idx = i0[None, :] + np.arange(k_max)[:, None]
    cover = (np.minimum((idx + 1).astype(np.float64), hi)
             - np.maximum(idx.astype(np.float64), lo))
    w = np.where((idx < i1) & (cover > 0), cover, 0.0)
    return i0, w, np.minimum(idx, src_len - 1)


def area_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """INTER_AREA resize of an (H, W) or (H, W, C) uint8 image to
    (out_h, out_w[, C]), bit-equal to the native ``area_resize_u8``."""
    src = np.ascontiguousarray(img, np.uint8)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    sh, sw, _ = src.shape
    _, wx, ix = _spans(sw, out_w)
    iy0, wy, iy = _spans(sh, out_h)
    # horizontal normaliser: sum of the column's coverages, in tap order
    norm_x = np.zeros(out_w)
    for k in range(wx.shape[0]):
        norm_x = norm_x + wx[k]
    out = np.empty((out_h, out_w, src.shape[2]), np.uint8)
    for r0 in range(0, out_h, _ROWS_PER_BLOCK):
        r1 = min(r0 + _ROWS_PER_BLOCK, out_h)
        s0, s1 = int(iy0[r0]), int(iy[:, r0:r1].max(initial=iy0[r0])) + 1
        rows = src[s0:s1]
        # horizontal pass over the block's source rows: out += w * px
        row_acc = np.zeros((s1 - s0, out_w, src.shape[2]))
        for k in range(wx.shape[0]):
            row_acc = row_acc + wx[k][None, :, None] * rows[:, ix[k]]
        # vertical pass: col_acc += cover_y * row_acc, total_h += cover_y
        col_acc = np.zeros((r1 - r0, out_w, src.shape[2]))
        total_h = np.zeros(r1 - r0)
        for k in range(wy.shape[0]):
            cy = wy[k, r0:r1]
            total_h = total_h + cy
            col_acc = col_acc + cy[:, None, None] * row_acc[iy[k, r0:r1] - s0]
        inv = 1.0 / (total_h[:, None] * norm_x[None, :])
        v = col_acc * inv[:, :, None]
        out[r0:r1] = np.where(v < 0, 0.0, np.where(v > 255, 255.0, v + 0.5)).astype(np.uint8)
    return out[:, :, 0] if squeeze else out
