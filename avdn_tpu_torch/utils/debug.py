"""Debug utilities (torch counterpart of ``avdn_tpu/utils/debug.py``).

The reference carries a GC-walking CUDA tensor census for leak hunting
(``debug_memory``, src/xview_et/agent.py:34-43). This is that census,
grouped and sorted so the big consumers surface first: the live tensors on a
device that Python holds (parameters, buffers, optimizer moments, anything a
frame or an object keeps), each storage counted once however many views
share it. Tensors that only the autograd graph holds are not Python objects
and are not seen; on the card the total line is the allocator's own
``torch.cuda.memory_allocated``, which sees them.
"""

from __future__ import annotations

import collections
import gc
from typing import List, Tuple

import torch

from avdn_tpu_torch.device import resolve_device


def _live_storages(device: torch.device):
    """``{storage pointer: (nbytes, the largest tensor viewing it)}`` of the
    live tensors on ``device``."""
    found = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): no __class__ lookup on proxies and the
        # objects that warn when touched
        if not issubclass(type(obj), torch.Tensor):
            continue
        if obj.device != device or obj.is_sparse or obj.is_meta:
            continue
        storage = obj.untyped_storage()
        key = storage.data_ptr()
        if key == 0:  # an empty storage holds no memory
            continue
        seen = found.get(key)
        if seen is None or obj.numel() > seen[1].numel():
            found[key] = (storage.nbytes(), obj)
    return found


def device_memory_census(top: int = 20, device=None) -> List[Tuple[str, int, int]]:
    """Census of live tensors on ``device`` (the card unless the caller
    asks for the CPU): ``[(dtype[shape], count, total_bytes)]`` sorted by
    total bytes, descending, truncated to ``top`` rows. A storage shared by
    several tensors is counted once, under the largest of them."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    groups: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for nbytes, t in _live_storages(device).values():
        key = f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
        groups[key] += nbytes
        counts[key] += 1
    return [(k, counts[k], b) for k, b in groups.most_common(top)]


def format_memory_census(top: int = 20, device=None) -> str:
    """Human-readable census, one line per group and a total line: on the
    card the allocator's ``torch.cuda.memory_allocated``, on the CPU the sum
    of every group."""
    device = resolve_device(device)
    rows = device_memory_census(10 ** 9, device)
    lines = [f"{b / 1e6:10.2f} MB  x{n:<5d} {k}" for k, n, b in rows[:top]]
    seen = sum(b for _, _, b in rows)
    if device.type == "cuda":
        total = torch.cuda.memory_allocated(device)
        lines.append(f"{total / 1e6:10.2f} MB  total allocated on {device} "
                     f"(torch.cuda.memory_allocated; {seen / 1e6:.2f} MB in the "
                     "tensors above and the rest of the census)")
    else:
        lines.append(f"{seen / 1e6:10.2f} MB  total live tensors on {device}")
    return "\n".join(lines)
