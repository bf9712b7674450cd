"""Map bank — xView GeoTIFF tiles, square-pixel normalised, on the card
(torch counterpart of ``avdn_tpu/data/maps.py``).

Maps are preprocessed ONCE on host (area-resample to square lat-ratio
pixels and BGR→RGB, both in the port's host library ``csrc/avdn_host.cpp``),
padded to a fixed slot shape, and uploaded into a uint8 tensor on the
device that the renderer gathers from directly. Attention
circles are kept as (cx, cy, r) lists (img coords) instead of rasterised
maps — the renderer tests them analytically (see sim.render).

Device caching: each unique map occupies one slot; slots are freed when a
map is absent from the incoming batch (same eviction policy as the
reference's ``map_batch`` dict, src/env.py:234-240) and reused. The *host*
decode cache is a bounded LRU instead (PARITY.md).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from avdn_tpu_torch.data import native
from avdn_tpu_torch.device import resolve_device
from avdn_tpu_torch.geometry.transforms import gps_to_img_coords_np


def load_map_image(path: str, lng_ratio: float, lat_ratio: float) -> np.ndarray:
    """Read a GeoTIFF tile and resample its width by lng_ratio/lat_ratio so
    pixels are square in latitude units (src/env.py:217-221). Returns RGB
    uint8 (the reference keeps BGR and flips at model input; we flip once).
    OpenCV decodes; the resampling and the flip are the host library's
    (:func:`native.area_resize`, bit-equal to ``data/resample.py`` and to
    the JAX package's native resampler)."""
    import cv2

    im = cv2.imread(path, 1)
    if im is None:
        raise FileNotFoundError(path)
    new_w = int(im.shape[1] * lng_ratio / lat_ratio)
    return native.swap_rb(native.area_resize(im, im.shape[0], new_w))


def attention_circles(item: dict, max_circles: int) -> Tuple[np.ndarray, int]:
    """Per-item GT attention circles in image coords ((cx, cy, radius),
    padded)."""
    circles = np.zeros((max_circles, 3), np.float32)
    att = item.get("attention_list", [])
    n = min(len(att), max_circles)
    for j in range(n):
        center_gps, radius = att[j][0], att[j][1]
        x, y = gps_to_img_coords_np(center_gps, item["gps_botm_left"],
                                    item["gps_top_right"], item["lat_ratio"])
        circles[j] = [x, y, float(radius)]
    return circles, n


class DeviceMapBank:
    """Fixed-shape uint8 map slots on ``device`` with name-keyed reuse and
    eviction.

    Tiles larger than the current slot shape are NEVER cropped (a crop would
    render views/GT beyond it black); the bank auto-grows to fit, rounded up
    to ``grow_quantum``, or raises if ``auto_grow=False``.

    ``loader(item) -> (H, W, 3) RGB uint8`` produces a map on a host-cache
    miss; the default decodes ``<dataset_dir>/<map_name>.tif`` with
    :func:`load_map_image`.

    A ``prepare`` that places maps writes into a NEW bank tensor (the old
    one stays intact for a rollout still in flight on it, like the JAX
    package's functional update).
    """

    def __init__(self, dataset_dir: str, bank_hw: Tuple[int, int],
                 n_slots: int = 8, auto_grow: bool = True,
                 grow_quantum: int = 512, device=None,
                 host_cache_maps: Optional[int] = None,
                 loader: Optional[Callable[[dict], np.ndarray]] = None):
        self.dataset_dir = dataset_dir
        self.bank_hw = tuple(bank_hw)
        self.n_slots = n_slots
        self.auto_grow = auto_grow
        self.grow_quantum = grow_quantum
        self.device = resolve_device(device)
        self.loader = loader or self._decode_tif
        # bounded LRU host decode cache (PARITY.md); default 2x the slots
        self.host_cache_maps = (host_cache_maps if host_cache_maps is not None
                                else 2 * n_slots)
        self._slots: List[Optional[str]] = [None] * n_slots
        self._host_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bank = torch.zeros((n_slots, *self.bank_hw, 3), dtype=torch.uint8,
                                 device=self.device)

    def _decode_tif(self, item: dict) -> np.ndarray:
        return load_map_image(
            os.path.join(self.dataset_dir, item["map_name"] + ".tif"),
            item["lng_ratio"], item["lat_ratio"])

    @property
    def array(self) -> torch.Tensor:
        """The current device bank (as last returned by ``prepare``)."""
        return self._bank

    def _load_host(self, item: dict) -> np.ndarray:
        name = item["map_name"]
        if name not in self._host_cache:
            self._host_cache[name] = self.loader(item)
        self._host_cache.move_to_end(name)
        return self._host_cache[name]

    def _ensure_fits(self, imgs: List[np.ndarray]):
        need_h = max([im.shape[0] for im in imgs], default=0)
        need_w = max([im.shape[1] for im in imgs], default=0)
        H, W = self.bank_hw
        if need_h <= H and need_w <= W:
            return
        if not self.auto_grow:
            raise ValueError(
                f"map tile of shape ({need_h}, {need_w}) exceeds bank slots "
                f"{self.bank_hw} and auto_grow is off — raise --map_bank_px")
        q = self.grow_quantum
        self.grow_to(-(-need_h // q) * q, -(-need_w // q) * q)

    def grow_to(self, new_h: int, new_w: int):
        """Grow the bank to at least (new_h, new_w), preserving resident
        slots."""
        H, W = self.bank_hw
        new_h, new_w = max(H, new_h), max(W, new_w)
        if (new_h, new_w) == (H, W):
            return
        grown = torch.zeros((self.n_slots, new_h, new_w, 3), dtype=torch.uint8,
                            device=self.device)
        grown[:, :H, :W] = self._bank
        self._bank = grown
        self.bank_hw = (new_h, new_w)

    def prepare(self, batch_items: List[dict]):
        """Ensure every batch map has a slot; upload new maps; evict unused
        host cache entries. Returns (bank tensor, {map_name: slot})."""
        names = [it["map_name"] for it in batch_items]
        unique = list(dict.fromkeys(names))
        if len(unique) > self.n_slots:
            raise ValueError(
                f"batch needs {len(unique)} maps > bank slots {self.n_slots}")
        for name in unique:
            if name in self._host_cache:
                self._host_cache.move_to_end(name)
        # free slots whose map is gone, then place new maps
        for i, owner in enumerate(self._slots):
            if owner is not None and owner not in unique:
                self._slots[i] = None
        slot_of: Dict[str, int] = {
            name: self._slots.index(name) for name in unique if name in self._slots}
        incoming = []
        seen = set(slot_of)
        for it in batch_items:
            if it["map_name"] not in seen:
                seen.add(it["map_name"])
                incoming.append(it)
        # decode cache-missing tiles in parallel (cv2 releases the GIL)
        misses = [it for it in incoming if it["map_name"] not in self._host_cache]
        if len(misses) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(misses))) as ex:
                list(ex.map(self._load_host, misses))
        to_place = {it["map_name"]: self._load_host(it) for it in incoming}
        if to_place:
            grown_from = self._bank
            self._ensure_fits(list(to_place.values()))
            if self._bank is grown_from:  # copy-on-write (see class doc)
                self._bank = self._bank.clone()
            for name, img in to_place.items():
                free = self._slots.index(None)
                slot = self._bank[free]
                slot.zero_()
                slot[: img.shape[0], : img.shape[1]] = torch.from_numpy(
                    np.ascontiguousarray(img)).to(self.device)
                self._slots[free] = name
                slot_of[name] = free
        bound = max(self.host_cache_maps, len(unique))
        while len(self._host_cache) > bound:
            self._host_cache.popitem(last=False)
        return self._bank, slot_of
