"""ctypes bindings of the port's host library, ``csrc/avdn_host.cpp``: the
INTER_AREA resampler and channel swap behind ``data/maps.py`` and the
WordPiece encoder behind ``data/tokenizer.py``.

The library is built at first use by ``ops/build.py`` with the host C++
compiler into ``build/avdn_tpu_torch/`` and loaded once per process, under a
lock: concurrent first calls (the map bank's decode threads) wait for the
one load and all get the library. A library that does not build or load
raises ``RuntimeError`` with the compiler's or the loader's message; nothing
here falls back to numpy or OpenCV. ``data/resample.py`` and the tokenizer's
Python encoder are the plain versions the tests hold these against.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from avdn_tpu_torch.ops import build

NAME = "avdn_host"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_longlong)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.area_resize_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _U8P, ctypes.c_int, ctypes.c_int]
    lib.area_resize_u8.restype = None
    lib.swap_rb_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int]
    lib.swap_rb_u8.restype = None
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int]
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_destroy.restype = None
    lib.wp_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _I64P,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    _I32P, _I32P, _U8P]
    lib.wp_encode_batch.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed. The module's handle
    is set only once the load and the declarations have succeeded."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            try:
                lib = build.load(NAME)
            except OSError as e:
                raise RuntimeError(f"cannot load the host library {NAME}: {e}") from e
            _lib = _declare(lib)
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def area_resize(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """INTER_AREA resize of an (H, W, C) or (H, W) uint8 image to (dh, dw)."""
    if dh < 1 or dw < 1:
        raise ValueError(f"area_resize: destination {dh}x{dw} is empty")
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim not in (2, 3) or min(src.shape[:2]) < 1:
        raise ValueError(f"area_resize: source shape {src.shape}")
    ch = src.shape[2] if src.ndim == 3 else 1
    dst = np.empty((dh, dw, ch) if src.ndim == 3 else (dh, dw), np.uint8)
    library().area_resize_u8(_u8p(src), src.shape[0], src.shape[1], ch,
                             _u8p(dst), dh, dw)
    return dst


def swap_rb(img: np.ndarray) -> np.ndarray:
    """BGR↔RGB channel swap of an (H, W, 3) uint8 image, in place when
    ``img`` is already contiguous uint8; returns the swapped array."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"swap_rb: expected (H, W, 3), got {img.shape}")
    library().swap_rb_u8(_u8p(img), img.shape[0], img.shape[1])
    return img


def wp_create(vocab_text: Optional[bytes], lowercase: bool = True,
              hash_size: int = 0) -> Optional[int]:
    """A native WordPiece encoder: ``vocab_text`` is the vocab.txt bytes
    (ids dense 0..n-1 in line order), or None with ``hash_size`` for the
    hashed vocabulary. Returns an opaque handle, or None where the C++ side
    refuses the vocabulary (a special token missing, ``hash_size`` <= 1000)."""
    buf = vocab_text if vocab_text is not None else b""
    handle = library().wp_create(buf, len(buf), int(lowercase), int(hash_size))
    return handle or None


def wp_destroy(handle: int) -> None:
    library().wp_destroy(handle)


def wp_encode_batch(handle: int, texts: Sequence[str], max_length: int,
                    pad_to: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode a batch of texts into ``(ids, mask, refused)``: (n, pad_to)
    int32 rows of ``[CLS] pieces [SEP]`` truncated to ``max_length`` tokens,
    and the indices of the texts the C++ side refused (non-ASCII), whose
    rows are left zero for the caller to fill."""
    raw = [t.encode("utf-8") for t in texts]
    n = len(raw)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in raw], out=offsets[1:])
    blob = b"".join(raw)
    ids = np.zeros((n, pad_to), np.int32)
    mask = np.zeros((n, pad_to), np.int32)
    refused = np.zeros(n, np.uint8)
    rc = library().wp_encode_batch(handle, blob, offsets.ctypes.data_as(_I64P), n,
                                   max_length, pad_to, ids.ctypes.data_as(_I32P),
                                   mask.ctypes.data_as(_I32P), _u8p(refused))
    if rc != 0:
        raise ValueError(f"wp_encode_batch: max_length {max_length} and pad_to "
                         f"{pad_to} (need max_length >= 2 and pad_to >= 1)")
    return ids, mask, np.nonzero(refused)[0]
